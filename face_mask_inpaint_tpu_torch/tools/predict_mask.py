"""Mask prediction over image files, the port of
face_mask_inpaint_tpu/tools/predict_mask.py (the reference's
modules/unet/extra/predict.py):

    python -m face_mask_inpaint_tpu_torch.tools.predict_mask \\
        --model saved_model/mask_detector.pth -i a.jpg b.jpg -o a_m.png b_m.png \\
        [--device cuda]

``--model`` goes through the CLIs' loader (convert.py): the port's own
state dict, a reference ``.pth``/``.pt`` (``convert_unet``), or a
``unet_checkpoint_epoch<N>`` of the port's trainer (its model). A missing
file warns and uses random weights from ``--seed``. Each mask is the
argmax decision of ``MaskDetector.predict_mask``, saved as a 0/255 PNG.
``--device`` defaults to cuda and fails when CUDA is absent.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

__all__ = ["get_args", "load_model", "predict_img", "main"]


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Predict masks from input images")
    parser.add_argument("--model", "-m", default="MODEL.pth",
                        help="checkpoint (the port's state dict, a reference .pth, or a "
                             "train state of the port's mask-detector trainer)")
    parser.add_argument("--input", "-i", nargs="+", required=True, help="input image files")
    parser.add_argument("--output", "-o", nargs="+", help="output mask files")
    parser.add_argument("--viz", "-v", action="store_true",
                        help="save a side-by-side visualization instead")
    parser.add_argument("--no-save", "-n", action="store_true")
    parser.add_argument("--mask-threshold", "-t", type=float, default=0.5)
    parser.add_argument("--scale", "-s", type=float, default=1.0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' must be asked for explicitly")
    parser.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    return parser.parse_args(argv)


def load_model(path: str, seed: int, device: torch.device):
    """MaskDetector on ``device`` in eval mode with the weights of ``path``."""
    from face_mask_inpaint_tpu_torch.convert import load_checkpoint, read_checkpoint
    from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
    from face_mask_inpaint_tpu_torch.tools.convert_torch import convert_unet

    model = MaskDetector(n_channels=3, bilinear=True,
                         generator=torch.Generator().manual_seed(seed))
    state = read_checkpoint(path, "mask detector")
    if state is not None:
        train_state = {k[len("model."):]: v for k, v in state.items() if k.startswith("model.")}
        if set(train_state) == set(model.state_dict()):  # the trainer's checkpoint
            state = train_state
        with torch.no_grad():
            load_checkpoint(model, state, convert_unet, "mask detector", path)
        logging.info("Model loaded from %s", path)
    return model.to(device).eval()


@torch.no_grad()
def predict_img(model, pil_img, scale: float, device) -> np.ndarray:
    """The argmax mask [H, W] of one image."""
    from face_mask_inpaint_tpu_torch.data.dataset import _preprocess

    arr = _preprocess(pil_img, scale, is_mask=False)
    return model.predict_mask(torch.from_numpy(arr)[None].to(device))[0].cpu().numpy()


def main(argv=None) -> list[np.ndarray]:
    from PIL import Image

    from face_mask_inpaint_tpu_torch.cli.picnet_inference import resolve_device

    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    device = resolve_device(args.device)
    model = load_model(args.model, args.seed, device)
    outputs = args.output or [f"{Path(p).stem}_OUT.png" for p in args.input]
    masks = []
    for in_file, out_file in zip(args.input, outputs):
        img = Image.open(in_file).convert("RGB")
        mask = predict_img(model, img, args.scale, device)
        masks.append(mask)
        if not args.no_save:
            Image.fromarray((mask * 255).astype("uint8")).save(out_file)
            logging.info("Mask saved to %s", out_file)
    return masks


if __name__ == "__main__":
    main()
