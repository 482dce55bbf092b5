"""Model factories, the port of face_mask_inpaint_tpu/hub.py (the
reference's torch-hub entry, modules/unet/extra/hubconf.py:1-15).

Each factory returns the port's module with weights drawn from ``seed``
or, given ``checkpoint``, loaded through the CLIs' loader (convert.py): the
port's own state dict, or a reference ``.pth`` through its converter. There
is no download: a checkpoint must be a local file.

>>> from face_mask_inpaint_tpu_torch import hub
>>> detector = hub.mask_detector("saved_model/mask_detector.pth")
>>> mask = detector.predict_mask(images)  # [N, H, W, 3] in [0, 1]
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["unet_carvana", "mask_detector", "reference_fill", "psp"]


def _load(model, checkpoint: Optional[str], convert, what: str, merge=None):
    from face_mask_inpaint_tpu_torch.convert import load_checkpoint, read_checkpoint

    if checkpoint:
        state = read_checkpoint(checkpoint, what)
        if state is None:
            raise FileNotFoundError(f"{what} checkpoint {checkpoint}: no such file")
        with torch.no_grad():
            load_checkpoint(model, state, convert, what, checkpoint, merge=merge)
    return model


def unet_carvana(checkpoint: Optional[str] = None, seed: int = 0):
    """The reference hub entry (hubconf.py:5-15): UNet(3, 2, bilinear), in
    eval mode; a reference checkpoint holds the UNet's keys, with or
    without the ``model.`` prefix of the mask detector."""
    from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
    from face_mask_inpaint_tpu_torch.tools.convert_torch import convert_unet

    detector = MaskDetector(generator=torch.Generator().manual_seed(seed))
    net = detector.model
    if checkpoint:
        def unet_vars(sd):
            v = convert_unet(sd, bilinear=True)
            return {c: tree["model"] for c, tree in v.items()}
        _load(net, checkpoint, unet_vars, "UNet")
    return net.eval()


def mask_detector(checkpoint: Optional[str] = None, seed: int = 0):
    """MaskDetector (UNet + the argmax ``predict_mask``), in eval mode."""
    from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
    from face_mask_inpaint_tpu_torch.tools.convert_torch import convert_unet

    net = MaskDetector(generator=torch.Generator().manual_seed(seed))
    return _load(net, checkpoint, convert_unet, "mask detector").eval()


def reference_fill(seed: int = 0, out_size: int = 256, checkpoint: Optional[str] = None):
    """The flagship ReferenceFill at the reference CLI defaults (use_att),
    in eval mode; a reference checkpoint merges its parameters, as the
    PICNet CLI does."""
    from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
    from face_mask_inpaint_tpu_torch.tools.convert_torch import convert_picnet_module

    enc = dict(type="pluralistic", ngf=32, z_nc=128, img_f=128, L=6, layers=5,
               norm="none", activation="LeakyReLU", init_type="orthogonal")
    dec = dict(ngf=32, z_nc=128, img_f=256, L=0, layers=5, norm="instance",
               activation="LeakyReLU", init_type="orthogonal")
    net = ReferenceFill(enc, dec, use_att=True, out_size=(out_size, out_size),
                        generator=torch.Generator().manual_seed(seed))
    return _load(net, checkpoint, convert_picnet_module, "generator",
                 merge=("params",)).eval()


def psp(checkpoint: Optional[str] = None, seed: int = 0, output_size: int = 1024,
        device=None):
    """pSp (GradualStyleEncoder with attention + StyleGAN2), built on
    ``device`` (the CPU by default) in eval mode; a reference combined
    checkpoint merges through ``convert_psp``."""
    from face_mask_inpaint_tpu_torch.models.psp import PSP
    from face_mask_inpaint_tpu_torch.tools.convert_torch import convert_psp

    device = torch.device("cpu") if device is None else torch.device(device)
    with torch.device(device):
        net = PSP(output_size=output_size, use_attention=True,
                  generator=torch.Generator(device=device).manual_seed(seed))
    return _load(net, checkpoint, lambda sd: convert_psp(sd, output_size), "pSp",
                 merge=("params", "batch_stats", "noises", "latent_avg")).eval()
