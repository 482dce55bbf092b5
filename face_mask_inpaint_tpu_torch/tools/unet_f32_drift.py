"""How far the Stack C training step's f32 gradients sit from its f64 step.

    python -m face_mask_inpaint_tpu_torch.tools.unet_f32_drift \\
        [--device cuda] [--sizes 64 128 256] [--batch 2]

For each image size: one train step (train/unet.py, Adam at 1e-5) of the
seeded MaskDetector on a seeded batch, in f64 on the CPU (the reference), in
f32 on the CPU, and with ``--device cuda`` in f32 on the card twice and in
f64 on the card, cuDNN's deterministic algorithms, TF32 off. Prints, for
each run against the reference, the largest share of phase 7's per-tensor
tolerance (1e-3 * max|ref| + 1e-5 * the step's largest gradient entry) its
gradients use, and the tensors that use the most; and the card's two f32
runs' largest difference. ``chip_smoke.py`` phase 10 gates the f64 step and
bounds the f32 drift with these shares.
"""

from __future__ import annotations

import argparse

import torch

from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
from face_mask_inpaint_tpu_torch.train.optim import adam
from face_mask_inpaint_tpu_torch.train.unet import make_unet_train_step

GRAD_TOL, GRAD_FLOOR = 1e-3, 1e-5


def _batch(n: int, hw: int, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    image = torch.rand(n, hw, hw, 3, generator=gen)
    mask = torch.zeros(n, hw, hw, dtype=torch.long)
    corner = torch.randint(0, hw // 2, (n, 2), generator=gen).tolist()
    for i, (y, x) in enumerate(corner):
        mask[i, y:y + hw // 2, x:x + hw // 4] = 1
    return {"image": image, "mask": mask}


def step_grads(batch: dict, device: str, dtype: torch.dtype, seed: int) -> dict:
    """The gradients of one train step, on the CPU in f64."""
    model = MaskDetector(dtype=dtype, generator=torch.Generator().manual_seed(seed))
    model = model.to(device, dtype)
    make_unet_train_step(model, adam(model.parameters(), 1e-5))(
        {k: v.to(device, dtype) if v.is_floating_point() else v.to(device)
         for k, v in batch.items()})
    return {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()}


def shares(got: dict, want: dict) -> list[tuple[float, str]]:
    """Each tensor's share of the tolerance, largest first."""
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
    return sorted(((float((got[k] - w).abs().max()) / (GRAD_TOL * float(w.abs().max()) + floor),
                    k) for k, w in want.items()), reverse=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu", help="cpu, or cuda to add the card's runs")
    parser.add_argument("--sizes", type=int, nargs="+", default=[64, 128, 256])
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    for hw in args.sizes:
        batch = _batch(args.batch, hw, args.seed + 22)
        ref = step_grads(batch, "cpu", torch.float64, args.seed)
        runs = {"cpu f32": step_grads(batch, "cpu", torch.float32, args.seed)}
        if args.device != "cpu":
            runs["card f32"] = step_grads(batch, args.device, torch.float32, args.seed)
            again = step_grads(batch, args.device, torch.float32, args.seed)
            runs["card f64"] = step_grads(batch, args.device, torch.float64, args.seed)
        for name, got in runs.items():
            top = shares(got, ref)
            print(f"{hw}^2 batch {args.batch}: {name} vs cpu f64 uses {top[0][0]:.3f} of the "
                  f"tolerance; most: " + ", ".join(f"{k} {u:.2f}" for u, k in top[:3]),
                  flush=True)
        if args.device != "cpu":
            top = shares(runs["card f32"], runs["cpu f32"])
            diff = max(float((runs["card f32"][k] - again[k]).abs().max()) for k in again)
            print(f"{hw}^2 batch {args.batch}: card f32 vs cpu f32 uses {top[0][0]:.3f} "
                  f"({top[0][1]}); two card f32 runs differ by at most {diff:.3e}", flush=True)


if __name__ == "__main__":
    main()
