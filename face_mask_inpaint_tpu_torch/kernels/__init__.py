"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper keeps a plain integer ``launches`` count, incremented only where
it launches its kernel (never for the plain version).
"""

from face_mask_inpaint_tpu_torch.kernels import decoder_conv as _dc
from face_mask_inpaint_tpu_torch.kernels import flash_attention as _fa
from face_mask_inpaint_tpu_torch.kernels import norm_act as _na
from face_mask_inpaint_tpu_torch.kernels import output_head as _oh

__all__ = ["WRAPPERS", "reset_launch_counts"]

WRAPPERS = (_fa.flash_attention, _fa.flash_attention_bwd, _na.instance_norm_act,
            _oh.output_head, _dc.conv3x3_stats, _dc.convt_pair)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
