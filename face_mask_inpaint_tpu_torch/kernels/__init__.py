"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper keeps a plain integer ``launches`` count, incremented only where
it launches its kernel (never for the plain version).
"""

from face_mask_inpaint_tpu_torch.kernels import decoder_conv as _dc
from face_mask_inpaint_tpu_torch.kernels import flash_attention as _fa
from face_mask_inpaint_tpu_torch.kernels import fused_act as _act
from face_mask_inpaint_tpu_torch.kernels import norm_act as _na
from face_mask_inpaint_tpu_torch.kernels import output_head as _oh
from face_mask_inpaint_tpu_torch.kernels import residual_add as _res
from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as _fir

__all__ = ["WRAPPERS", "NAMES", "reset_launch_counts", "launch_counts"]

WRAPPERS = (_fa.flash_attention, _fa.flash_attention_bwd, _na.instance_norm_act,
            _oh.output_head, _dc.conv3x3_stats, _dc.convt_pair, _fir.upfirdn2d,
            _fir.upfirdn2d_bwd, _act.fused_leaky_relu, _act.fused_leaky_relu_bwd,
            _res.residual_bias_add)
# each wrapper's name in chip_smoke.py's kernels line
NAMES = ("flash_attention_fwd", "flash_attention_bwd", "instance_norm_act", "output_head",
         "conv3x3_stats", "convt_pair", "upfirdn2d", "upfirdn2d_bwd", "fused_leaky_relu",
         "fused_leaky_relu_bwd", "residual_bias_add")


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: w.launches for name, w in zip(NAMES, WRAPPERS)}
