"""Host-side image conversion for the inference CLI (PIL imported on use).

Port of face_mask_inpaint_tpu/utils/images.py.
"""

from __future__ import annotations

import numpy as np

__all__ = ["tensor2im", "mask2im"]


def tensor2im(img_hwc):
    """[H, W, C] float in [0, 1] (array or tensor) -> PIL image, values
    clipped to [0, 1] (PICNet_inference.py:112-117)."""
    from PIL import Image

    var = np.clip(np.asarray(img_hwc, np.float32), 0.0, 1.0)
    return Image.fromarray((var * 255).astype("uint8"))


def mask2im(mask_hw):
    """[H, W] float mask -> 3-channel PIL image."""
    return tensor2im(np.repeat(np.asarray(mask_hw, np.float32)[..., None], 3, axis=-1))
