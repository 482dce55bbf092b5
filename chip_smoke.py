#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

The main path is the flagship: reference-guided PICNet inference at 256^2
(MaskDetector.predict_mask, then ReferenceFill at the bench.py flagship
widths), the path of ``PICNet_inference.py --use_att 1``. Phases:

1. build the CUDA kernels from the sources in the checkout (set-up time);
2. hold each kernel against its plain PyTorch version on the card, at the
   flagship shapes and a ragged one, in float32 (TF32 off) and bfloat16;
3. the flagship models at batch 4, float32, random weights from --seed:
   output shape, range and finiteness; the kernel path against the plain
   versions on the card; the launch counts of one forward (K1 once, K2 ten
   times);
4. the CLI's ``infer_batch`` over three seeded batches, with SSIM/MS-SSIM;
5. the flagship forward at batch 16 in bfloat16 (bench.py's configuration),
   timed with CUDA events, with the kernels and with the plain versions.

Prints a ``kernels`` JSON line, the card's name and power limit, and as its
last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when CUDA is unavailable or any phase fails. Imports torch, numpy,
triton and the port only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

FLAGSHIP_ENC = dict(type="pluralistic", ngf=32, z_nc=128, img_f=128, L=6, layers=5,
                    norm="none", activation="LeakyReLU", init_type="orthogonal")
FLAGSHIP_DEC = dict(ngf=32, z_nc=128, img_f=256, L=0, layers=5, norm="instance",
                    activation="LeakyReLU", init_type="orthogonal")
HW = 256
# (C, H) of the ten decoder instance norms (five ResBlockDecoders, norm1 on the
# block input and norm2 on its hidden map) at the flagship widths
DECODER_NORMS = [(256, 32), (256, 32), (256, 64), (256, 64), (256, 128), (128, 128),
                 (128, 256), (64, 256), (64, 512), (32, 512)]
# |kernel - plain| <= ATOL + RTOL * |plain|: float32 differs only in the order
# of f32 sums; bfloat16 outputs are f32 results rounded once, so the two
# sides may land one bf16 ulp (2^-7 relative) apart
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 2.0 ** -7)}
LSE_ATOL = 1e-3

KERNELS = {
    "flash_attention_fwd": dict(
        route="cuda", source="face_mask_inpaint_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="face_mask_inpaint_tpu/ops/pallas/flash_attention.py:93"),
    "instance_norm_act": dict(
        route="triton", source="face_mask_inpaint_tpu_torch/kernels/norm_act.py",
        replaces="face_mask_inpaint_tpu/ops/pallas/norm_act.py:84"),
}


class Run:
    """Collects check results; any failed check fails the script."""

    def __init__(self):
        self.failures: list[str] = []
        self.err = {k: 0.0 for k in KERNELS}

    def check(self, ok: bool, what: str) -> None:
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)


def _close(got, want, dtype_name):
    atol, rtol = TOL[dtype_name]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return bool((err <= atol + rtol * want.abs()).all()), float(err.max())


def _time_ms(fn, reps: int):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain versions (for the
    comparisons and the plain timing only; launches are not counted)."""
    from face_mask_inpaint_tpu_torch.kernels import flash_attention as fa
    from face_mask_inpaint_tpu_torch.kernels import norm_act as na

    saved = fa.flash_attention, na.instance_norm_act
    fa.flash_attention = lambda q, values, with_lse=False: fa.flash_attention_plain(
        q, values, with_lse=with_lse)
    na.instance_norm_act = na.instance_norm_act_plain
    try:
        yield
    finally:
        fa.flash_attention, na.instance_norm_act = saved


def phase_build():
    from face_mask_inpaint_tpu_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {len(libs)} CUDA source(s) in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.is_file():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")


def phase_kernels(run: Run, seed: int, timings: dict):
    import torch

    from face_mask_inpaint_tpu_torch.kernels import flash_attention as fa
    from face_mask_inpaint_tpu_torch.kernels import norm_act as na

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    # q scaled so the maps are spread (the diagonal holds well under 1% of a
    # row at L = 16384), which exercises the whole online softmax; d = 48
    # takes the CUDA-core path, d = 64 in bf16 the tensor-core path
    k1_cases = [("flagship", 16, 16384, 64, [256]), ("ragged", 2, 4100, 64, [200, 56]),
                ("ragged", 2, 4100, 48, [200, 56])]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, n, l, d, widths in k1_cases:
            q = (torch.randn(n, l, d, device=dev, generator=gen) / d ** 0.5 * 2).to(dtype)
            vs = [torch.randn(n, l, c, device=dev, generator=gen).to(dtype) for c in widths]
            outs, lse = fa.flash_attention(q, vs, with_lse=True)
            torch.cuda.synchronize()
            refs, lse_ref = fa.flash_attention_plain(q, vs, with_lse=True)
            ok, err = True, 0.0
            for o, r in zip(outs, refs):
                o_ok, o_err = _close(o, r, dname)
                ok, err = ok and o_ok, max(err, o_err)
            lse_err = float((lse - lse_ref).abs().max())
            run.err["flash_attention_fwd"] = max(run.err["flash_attention_fwd"], err)
            run.check(ok and lse_err <= LSE_ATOL,
                      f"K1 {label} N={n} L={l} d={d} C={widths} {dname}: max_abs_err "
                      f"{err:.3e} lse_err {lse_err:.3e} (tol atol {TOL[dname][0]} + rtol "
                      f"{TOL[dname][1]:.3e}*|ref|, lse {LSE_ATOL})")
            if label == "flagship":
                ms = _time_ms(lambda: fa.flash_attention(q, vs), 5)
                plain_ms = _time_ms(lambda: fa.flash_attention_plain(q, vs), 5)
                timings[("flash_attention_fwd", dname)] = (ms, plain_ms)
                print(f"[time] K1 flagship {dname}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
            del q, vs, outs, refs

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        total, total_plain = 0.0, 0.0
        cases = [(f"decoder N=16 C={c} H=W={h}", (16, c, h, h), "LeakyReLU")
                 for c, h in DECODER_NORMS]
        cases += [("ragged", (3, 5, 37, 41), act) for act in ("LeakyReLU", "ReLU", "none")]
        for label, shape, act in cases:
            x = (torch.randn(shape, device=dev, generator=gen) * 2 + 1).to(dtype)
            w = torch.randn(shape[1], device=dev, generator=gen)
            b = torch.randn(shape[1], device=dev, generator=gen)
            y = na.instance_norm_act(x, w, b, act)
            torch.cuda.synchronize()
            ok, err = _close(y, na.instance_norm_act_plain(x, w, b, act), dname)
            run.err["instance_norm_act"] = max(run.err["instance_norm_act"], err)
            run.check(ok, f"K2 {label} {act} {dname}: max_abs_err {err:.3e} "
                          f"(tol atol {TOL[dname][0]} + rtol {TOL[dname][1]:.3e}*|ref|)")
            if label.startswith("decoder"):
                total += _time_ms(lambda: na.instance_norm_act(x, w, b, act), 5)
                total_plain += _time_ms(lambda: na.instance_norm_act_plain(x, w, b, act), 5)
            del x, y
        timings[("instance_norm_act", dname)] = (total, total_plain)
        print(f"[time] K2 ten decoder norms at N=16 {dname}: kernel {total:.3f} ms, "
              f"plain {total_plain:.3f} ms")


def _models(seed: int, dtype):
    import torch

    from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
    from face_mask_inpaint_tpu_torch.models.unet import MaskDetector

    weights = torch.Generator().manual_seed(seed)
    detector = MaskDetector(dtype=dtype, generator=weights)
    model = ReferenceFill(FLAGSHIP_ENC, FLAGSHIP_DEC, use_att=True, out_size=(HW, HW),
                          dtype=dtype, generator=weights)
    # gamma starts at zero; at one the attention term reaches the image
    with torch.no_grad():
        model.decoder.attn1.gamma.fill_(1.0)
    return detector.cuda(), model.cuda()


def _counts():
    from face_mask_inpaint_tpu_torch.kernels import flash_attention as fa
    from face_mask_inpaint_tpu_torch.kernels import norm_act as na

    return {"flash_attention_fwd": fa.flash_attention.launches,
            "instance_norm_act": na.instance_norm_act.launches}


def phase_flagship(run: Run, seed: int) -> dict:
    import torch

    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts

    detector, model = _models(seed, torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    src = torch.rand(4, HW, HW, 3, device="cuda", generator=gen)
    ref = torch.rand(4, HW, HW, 3, device="cuda", generator=gen)

    def forward():
        noise = torch.Generator(device="cuda").manual_seed(seed + 1)
        with torch.no_grad():
            mask = detector.predict_mask(src)
            return model(src, ref, mask, generator=noise), mask

    reset_launch_counts()
    out, mask = forward()
    torch.cuda.synchronize()
    launches = _counts()
    print(f"[flagship] launches in one forward: {launches}", flush=True)
    run.check(launches == {"flash_attention_fwd": 1, "instance_norm_act": 10},
              f"flagship forward launches K1 once and K2 ten times: {launches}")
    run.check(tuple(out.shape) == (4, HW, HW, 3), f"output shape {tuple(out.shape)}")
    run.check(bool(torch.isfinite(out).all()), "output finite")
    run.check(float(out.abs().max()) <= 1.0, f"output within [-1, 1]: max |y| {float(out.abs().max()):.4f}")
    print(f"[flagship] mask mean {float(mask.mean()):.4f}")
    with plain_versions():
        out_plain, mask_plain = forward()
    err = float((out - out_plain).abs().max())
    run.check(torch.equal(mask, mask_plain) and err <= 1e-3,
              f"flagship kernel path vs plain versions (float32, batch 4): max_abs_err "
              f"{err:.3e} (tol 1e-3)")
    del detector, model
    torch.cuda.empty_cache()
    return launches


def phase_cli(run: Run, seed: int):
    import torch

    from face_mask_inpaint_tpu_torch.cli import picnet_inference as cli
    from face_mask_inpaint_tpu_torch.evaluations.ssim import ms_ssim, ssim
    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts

    args = cli.get_args(["--device", "cuda", "--seed", str(seed), "--batch_size", "4",
                         "--decoder_img_f", "256", "--mask_detector_path", "",
                         "--pt_ckpt_path", "", "--out_size", str(HW)])
    detector, generator = cli.build_models(args, cli.resolve_device(args.device))
    infer_batch = cli.make_infer_batch(detector, generator)
    data = torch.Generator(device="cuda").manual_seed(seed + 2)
    noise = torch.Generator(device="cuda").manual_seed(seed)
    reset_launch_counts()
    for step in range(3):
        src = torch.rand(4, HW, HW, 3, device="cuda", generator=data)
        ref = torch.rand(4, HW, HW, 3, device="cuda", generator=data)
        gen, mask = infer_batch(src, ref, noise)
        s, ms = float(ssim(ref, gen)), float(ms_ssim(ref, gen))
        run.check(tuple(gen.shape) == (4, HW, HW, 3) and tuple(mask.shape) == (4, HW, HW)
                  and bool(torch.isfinite(gen).all()) and s == s and ms == ms,
                  f"infer_batch step {step}: ssim {s:.4f} ms_ssim {ms:.4f}")
    launches = _counts()
    run.check(launches == {"flash_attention_fwd": 3, "instance_norm_act": 30},
              f"infer_batch x3 launches: {launches}")
    del detector, generator
    torch.cuda.empty_cache()


def phase_timing(run: Run, seed: int, timings: dict, card: str):
    import torch

    from face_mask_inpaint_tpu_torch.kernels import reset_launch_counts

    batch = 16
    detector, model = _models(seed, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    src = torch.rand(batch, HW, HW, 3, device="cuda", generator=gen)
    ref = torch.rand(batch, HW, HW, 3, device="cuda", generator=gen)
    noise = torch.Generator(device="cuda").manual_seed(seed + 1)

    def forward():
        with torch.no_grad():
            return model(src, ref, detector.predict_mask(src), generator=noise)

    reset_launch_counts()
    out = forward()
    torch.cuda.synchronize()
    launches = _counts()
    run.check(launches == {"flash_attention_fwd": 1, "instance_norm_act": 10}
              and out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all()),
              f"bf16 batch-16 forward: {out.dtype}, launches {launches}")
    kernel_t, plain_t = [], []
    for _ in range(3):  # alternate so drift hits both sides alike
        kernel_t.append(_time_ms(forward, 3))
        with plain_versions():
            plain_t.append(_time_ms(forward, 3))
    ms, plain_ms = statistics.median(kernel_t), statistics.median(plain_t)
    timings["flagship"] = (ms, plain_ms)
    print(f"[time] flagship forward bf16 batch {batch}: kernels {ms:.2f} ms "
          f"({batch / ms * 1e3:.2f} images/s), plain versions {plain_ms:.2f} ms "
          f"({batch / plain_ms * 1e3:.2f} images/s) on {card}", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[time] peak device memory {peak:.2f} GiB")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    run = Run()
    timings: dict = {}
    t0 = time.perf_counter()
    phase_build()
    phase_kernels(run, args.seed, timings)
    launches = phase_flagship(run, args.seed)
    phase_cli(run, args.seed)
    phase_timing(run, args.seed, timings, smi)
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)
    if run.failures:
        print(f"chip_smoke: {len(run.failures)} check(s) failed:", file=sys.stderr)
        for f in run.failures:
            print("  " + f, file=sys.stderr)
        return 1

    kernels = []
    for name, meta in KERNELS.items():
        ms, plain_ms = timings[(name, "bfloat16")]
        kernels.append({"name": name, **meta, "launches": launches[name],
                        "max_abs_err": run.err[name], "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
