"""Stack A batch inference through the port: the mask detector, then
ReferenceFill, as ``cli/picnet_inference.py``'s per-batch step runs them.

The step makes the step's two calls, ``detector.predict_mask(src)`` and
``generator(src, ref, mask, ...)`` under ``torch.no_grad``, with the latent
noise handed in as ``eps_q``/``eps_p`` (an input of the batch, which the
reference is given too) instead of drawn inside from a ``torch.Generator``.
The models compute in the configuration's dtype with float32 parameters;
their weights are the benchmark's, loaded by state-dict name.
"""

from __future__ import annotations

import torch

DETECTOR, GENERATOR = "detector.", "generator."


def input_spec(config: dict, traffic: dict) -> dict:
    """name -> (kind, shape) of one batch: NHWC photos in [0, 1] and the
    noise of z, shaped like the encoders' mu (NHWC)."""
    n, h, w = traffic["batch"], traffic["height"], traffic["width"]
    down = 2 ** (1 + (config["encoder"]["layers"] - 1) // 2)
    z = (n, h // down, w // down, config["encoder"]["z_nc"])
    return {"src": ("image01", (n, h, w, 3)), "ref": ("image01", (n, h, w, 3)),
            "eps_q": ("normal", z), "eps_p": ("normal", z)}


def _sub(weights: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}


class System:
    """The port's two models on ``device`` and the per-batch step."""

    def __init__(self, config: dict, weights: dict, device):
        from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
        from face_mask_inpaint_tpu_torch.models.unet import MaskDetector

        dtype = getattr(torch, config["dtype"])
        with torch.device(device):
            self.detector = MaskDetector(**config["detector"], dtype=dtype,
                                         generator=torch.Generator(device=device))
        with torch.device("meta"):
            gen = ReferenceFill(config["encoder"], config["decoder"], use_att=config["use_att"],
                                out_size=(config["out_size"], config["out_size"]), dtype=dtype,
                                generator=torch.Generator())
        self.generator = gen.to_empty(device=device)
        self.detector.load_state_dict(_sub(weights, DETECTOR))
        self.generator.load_state_dict(_sub(weights, GENERATOR))
        self.detector.eval()
        self.generator.eval()
        # the modules whose forward bounds each stage (stage_ms.<name>)
        self.stages = {"detector": self.detector.model, "generator": self.generator}

    @torch.no_grad()
    def step(self, batch: dict):
        """(images [N, out, out, 3] in [-1, 1], masks [N, H, W])."""
        mask = self.detector.predict_mask(batch["src"])
        return self.generator(batch["src"], batch["ref"], mask, eps_q=batch["eps_q"],
                              eps_p=batch["eps_p"]), mask
