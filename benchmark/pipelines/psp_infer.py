"""Stack B batch inference through the port: the mask detector, then pSp
with the reference fused in, through ``cli/psp_inference.py``'s per-batch
step, ``make_infer_batch(detector, psp, use_ref=True)``, as the CLI builds
the models (fixed noise maps). The models compute in the configuration's
dtype with float32 parameters; their weights are the benchmark's, loaded by
state-dict name.
"""

from __future__ import annotations

import torch

DETECTOR, PSP = "detector.", "psp."


def input_spec(config: dict, traffic: dict) -> dict:
    """name -> (kind, shape) of one batch: NHWC photos in [-1, 1]."""
    n, h, w = traffic["batch"], traffic["height"], traffic["width"]
    return {"src": ("image11", (n, h, w, 3)), "ref": ("image11", (n, h, w, 3))}


def _sub(weights: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}


class System:
    """The port's two models on ``device`` and the CLI's per-batch step."""

    def __init__(self, config: dict, weights: dict, device):
        from face_mask_inpaint_tpu_torch.cli.psp_inference import make_infer_batch
        from face_mask_inpaint_tpu_torch.models.psp import PSP as PSPModel
        from face_mask_inpaint_tpu_torch.models.unet import MaskDetector

        dtype = getattr(torch, config["dtype"])
        with torch.device(device):
            self.detector = MaskDetector(**config["detector"], dtype=dtype,
                                         generator=torch.Generator(device=device))
            self.psp = PSPModel(**config["psp"], dtype=dtype, init=False)
        self.detector.load_state_dict(_sub(weights, DETECTOR))
        self.psp.load_state_dict(_sub(weights, PSP))
        self.detector.eval()
        self.psp.eval()
        self._infer = make_infer_batch(self.detector, self.psp, use_ref=config["use_ref"])
        # the modules whose forward bounds each stage (stage_ms.<name>)
        self.stages = {"detector": self.detector.model, "generator": self.psp}

    def step(self, batch: dict):
        """(images [N, 256, 256, 3], masks [N, H, W])."""
        return self._infer(batch["src"], batch["ref"])
