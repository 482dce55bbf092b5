"""Kernel validation: every hand-written kernel against an independent dense
reference in float64.

Port of face_mask_inpaint_tpu/tools/validate_kernels.py. ``chip_smoke.py``
holds each kernel against its own plain version; this tool holds it against
a reference written apart from both: softmax(q q^T) v by ``torch.matmul``,
instance norm from its definition, the output head and the decoder convs by
``F.conv2d``/``F.conv_transpose2d``, upfirdn2d as a zero-insert, pad and
depthwise ``F.conv2d`` of the flipped 2-D kernel, the activation by
``torch.where``, the residual sum as a sum, all in float64 on the same device
from the rounded inputs.

    python -m face_mask_inpaint_tpu_torch.tools.validate_kernels [--out PATH]
        [--device cuda|cpu]

One check a kernel: K1, K2, K3, K4a, K4b, K5, K6, K6's backward, K7a, K7b
and the decoder's residual sum (RES), each at small shapes in float32 and
bfloat16. K5 is the gradient of K1's autograd Function, K6_bwd that of K6's,
K7b that of K7a's; K2's gradient (its Function differentiates the plain
version) is checked with K2. K2 runs with and without its input bias, K3
with and without its pair bias, RES with both maps NCHW and with the second
channels-last. A check
passes when max |kernel - reference| <= tol * max |reference| for every
output in both types (``TOL``), and, on the card, when its kernels launched.
The JSON (default ``build/kernel_validation.json``) holds the device (the
card's name and power limit on ``cuda``), each check's ``ok``,
``max_abs_diff``, ``rel_diff`` and per-type rows, and ``all_ok``; one JSON
line goes to stdout, and the exit code is 1 when a check fails.

``--device`` defaults to ``cuda``; without CUDA the tool exits 2 unless
``--device cpu`` is given, where the port's plain versions stand in for the
kernels (the JSON says so).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import traceback
from pathlib import Path

import torch
import torch.nn.functional as F

from face_mask_inpaint_tpu_torch.kernels import launch_counts, reset_launch_counts

__all__ = ["CHECKS", "TOL", "run_checks", "main"]

DTYPES = (torch.float32, torch.bfloat16)
# max |kernel - f64 reference| <= tol * max |reference|: float32 sums in
# another order (K1, K4, K5 on the card in split precision, 3xTF32); bfloat16
# inputs exact, but the output rounded once (2^-9) and, inside K1, K4 and K5,
# the probabilities, the prologue and dS rounded to bf16 as well
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DEFAULT_OUT = "build/kernel_validation.json"
_SQRT2 = math.sqrt(2.0)


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def _randn(shape, gen, device, scale=1.0):
    return torch.randn(shape, generator=gen, device=device) * scale


def _compare(pairs) -> dict:
    """{max_abs_diff, rel_diff} over (got, reference) pairs."""
    abs_d, rel_d = 0.0, 0.0
    for got, want in pairs:
        got, want = got.detach(), want.detach()
        err = float((got.double() - want.double()).abs().max())
        abs_d = max(abs_d, err)
        rel_d = max(rel_d, err / max(float(want.double().abs().max()), 1e-30))
    return {"max_abs_diff": abs_d, "rel_diff": rel_d}


def _leaky(v, slope):
    return torch.where(v >= 0, v, v * slope)


# -- K1 and K5: flash attention ------------------------------------------------

def _attention_inputs(dtype, device):
    g = _gen(device, 1)
    n, l, d = 2, 300, 32  # L over two 128-row blocks and ragged; d and C on the tensor cores
    q = _randn((n, l, d), g, device, 0.35).to(dtype)
    values = [_randn((n, l, c), g, device).to(dtype) for c in (64, 32)]
    weights = [_randn((n, l, c), g, device).to(dtype) for c in (64, 32)]
    return q, values, weights


def _attention_ref(q, values):
    p = torch.softmax(torch.matmul(q, q.transpose(1, 2)), dim=-1)
    return [torch.matmul(p, v) for v in values]


def check_k1(dtype, device):
    from face_mask_inpaint_tpu_torch.kernels.flash_attention import flash_attention

    q, values, _ = _attention_inputs(dtype, device)
    got = flash_attention(q, values)
    want = _attention_ref(q.double(), [v.double() for v in values])
    return _compare(zip(got, want))


def check_k5(dtype, device):
    from face_mask_inpaint_tpu_torch.kernels.flash_attention import flash_attention_autograd

    q, values, weights = _attention_inputs(dtype, device)
    leaves = [t.detach().requires_grad_() for t in (q, *values)]
    outs = flash_attention_autograd(leaves[0], leaves[1:])
    got = torch.autograd.grad(sum((o * w).sum() for o, w in zip(outs, weights)), leaves)
    ref = [t.detach().double().requires_grad_() for t in (q, *values)]
    outs = _attention_ref(ref[0], ref[1:])
    want = torch.autograd.grad(sum((o * w.double()).sum() for o, w in zip(outs, weights)), ref)
    return _compare(zip(got, want))


# -- K2: instance norm + activation ---------------------------------------------

def check_k2(dtype, device):
    from face_mask_inpaint_tpu_torch.kernels.norm_act import instance_norm_act

    g = _gen(device, 2)
    x = (_randn((2, 16, 24, 20), g, device, 2.0) + 0.5).to(dtype)
    wt, b = 1.0 + 0.1 * _randn((16,), g, device), 0.1 * _randn((16,), g, device)
    up = _randn((2, 16, 24, 20), g, device).to(dtype)
    leaves = [t.detach().requires_grad_() for t in (x, wt, b)]
    y = instance_norm_act(*leaves, "LeakyReLU", 0.1, 1e-5)
    grads = torch.autograd.grad((y * up).sum(), leaves)

    ref = [t.detach().double().requires_grad_() for t in (x, wt, b)]
    xd = ref[0]
    mean = xd.mean(dim=(2, 3), keepdim=True)
    var = ((xd - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    want = _leaky((xd - mean) / torch.sqrt(var + 1e-5) * ref[1][:, None, None]
                  + ref[2][:, None, None], 0.1)
    want_grads = torch.autograd.grad((want * up.double()).sum(), ref)

    ib = 0.5 * _randn((16,), g, device)  # the input bias: a conv's, added as x loads
    got_ib = instance_norm_act(x, wt, b, "LeakyReLU", 0.1, 1e-5, in_bias=ib)
    xb = x.double() + ib.double()[:, None, None]
    mean = xb.mean(dim=(2, 3), keepdim=True)
    var = ((xb - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    want_ib = _leaky((xb - mean) / torch.sqrt(var + 1e-5) * wt.double()[:, None, None]
                     + b.double()[:, None, None], 0.1)
    return _compare([(y, want), *zip(grads, want_grads), (got_ib, want_ib)])


# -- K3: output head --------------------------------------------------------------

def check_k3(dtype, device):
    from face_mask_inpaint_tpu_torch.kernels.output_head import output_head

    g = _gen(device, 3)
    h = _randn((2, 16, 32, 32), g, device).to(dtype)
    s = _randn((2, 16, 32, 32), g, device).to(dtype)
    w = (0.1 * _randn((3, 16, 3, 3), g, device)).to(dtype)
    b = 0.1 * _randn((3,), g, device)
    pb = 0.5 * _randn((16,), g, device)  # the pair bias: two convs' biases, summed
    pairs = []
    for pair_bias in (None, pb):
        got = output_head(h, s, w, b, "LeakyReLU", 4, pair_bias)
        hs = h.double() + s.double()
        if pair_bias is not None:
            hs = hs + pair_bias.double()[:, None, None]
        a = F.pad(_leaky(hs, 0.1), (1, 1, 1, 1), mode="reflect")
        pairs.append((got, F.avg_pool2d(torch.tanh(F.conv2d(a, w.double(), b.double())), 4)))
    return _compare(pairs)


# -- RES: the decoder block's residual sum with its convs' biases ------------------

def check_res(dtype, device):
    from face_mask_inpaint_tpu_torch.kernels.residual_add import residual_bias_add

    g = _gen(device, 11)
    h = _randn((2, 40, 24, 20), g, device).to(dtype)
    s = _randn((2, 40, 24, 20), g, device).to(dtype)
    b = 0.5 * _randn((40,), g, device) + 0.5 * _randn((40,), g, device)  # two convs' biases
    want = h.double() + s.double() + b.double()[:, None, None]
    return _compare([(residual_bias_add(h, s, b), want),
                     (residual_bias_add(h, s.contiguous(memory_format=torch.channels_last), b),
                      want)])


# -- K4b and K4a: the decoder tail's convs ------------------------------------------

def _prologue(x, a, b):
    return _leaky(x.double() * a.double()[:, :, None, None] + b.double()[:, :, None, None], 0.1)


def _stats_pairs(got, y):
    out, (s, sq) = got
    return [(out, _leaky(y, 0.1)), (s, y.sum(dim=(2, 3))), (sq, (y * y).sum(dim=(2, 3)))]


def check_k4b(dtype, device):
    from face_mask_inpaint_tpu_torch.kernels.decoder_conv import conv3x3_stats

    g = _gen(device, 4)
    x = _randn((2, 16, 16, 32), g, device).to(dtype)
    w = (0.1 * _randn((24, 16, 3, 3), g, device)).to(dtype)
    b = 0.1 * _randn((24,), g, device)
    a, c = 1.0 + 0.1 * _randn((2, 16), g, device), 0.1 * _randn((2, 16), g, device)
    got = conv3x3_stats(x, w, b, (a, c, "LeakyReLU"), "LeakyReLU", with_stats=True)
    y = F.conv2d(_prologue(x, a, c), w.double(), b.double(), padding=1)
    return _compare(_stats_pairs(got, y))


def check_k4a(dtype, device):
    from face_mask_inpaint_tpu_torch.kernels.decoder_conv import convt_pair

    g = _gen(device, 5)
    x1 = _randn((2, 16, 16, 32), g, device).to(dtype)
    x2 = _randn((2, 8, 16, 32), g, device).to(dtype)
    w1 = (0.1 * _randn((16, 24, 3, 3), g, device)).to(dtype)
    w2 = (0.1 * _randn((8, 24, 3, 3), g, device)).to(dtype)
    b1, b2 = 0.1 * _randn((24,), g, device), 0.1 * _randn((24,), g, device)
    a, c = 1.0 + 0.1 * _randn((2, 16), g, device), 0.1 * _randn((2, 16), g, device)
    got = convt_pair([(x1, w1, b1, (a, c, "LeakyReLU")), (x2, w2, b2)], "LeakyReLU",
                     with_stats=True)
    kw = dict(stride=2, padding=1, output_padding=1)
    y = (F.conv_transpose2d(_prologue(x1, a, c), w1.double(), b1.double(), **kw)
         + F.conv_transpose2d(x2.double(), w2.double(), b2.double(), **kw))
    return _compare(_stats_pairs(got, y))


# -- K6 and its backward: upfirdn2d ----------------------------------------------------

UPFIRDN_MODES = ((1, 1, (2, 1)), (2, 1, (2, 1)), (1, 2, (2, 2)), (1, 1, (1, 1)))
_TAPS = (1.0, 3.0, 3.0, 1.0)


def _upfirdn_ref(x, taps, up, down, pad):
    """Zero-insert by ``up``, pad (a negative pad crops), a true convolution
    with outer(taps, taps) as one depthwise F.conv2d, keep every down-th."""
    n, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros((n, c, h * up, w * up))
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    k = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    k2 = torch.outer(k, k).flip(0, 1).expand(c, 1, len(taps), len(taps))
    return F.conv2d(x, k2, groups=c)[:, :, ::down, ::down]


def _upfirdn_cases(dtype, device):
    from face_mask_inpaint_tpu_torch.ops.upfirdn2d import make_taps

    g = _gen(device, 6)
    x = _randn((2, 8, 33, 33), g, device).to(dtype)
    for up, down, pad in UPFIRDN_MODES:
        taps = [float(t) for t in make_taps(_TAPS, float(up * up))]
        yield x, taps, up, down, pad, g


def check_k6(dtype, device):
    from face_mask_inpaint_tpu_torch.kernels.upfirdn2d import upfirdn2d

    pairs = []
    for x, taps, up, down, pad, _ in _upfirdn_cases(dtype, device):
        pairs.append((upfirdn2d(x, taps, up, down, pad),
                      _upfirdn_ref(x.double(), taps, up, down, pad)))
    return _compare(pairs)


def check_k6_bwd(dtype, device):
    from face_mask_inpaint_tpu_torch.kernels.upfirdn2d import upfirdn2d

    pairs = []
    for x, taps, up, down, pad, g in _upfirdn_cases(dtype, device):
        xk = x.detach().requires_grad_()
        y = upfirdn2d(xk, taps, up, down, pad)
        w = _randn(y.shape, g, device).to(dtype)
        (got,) = torch.autograd.grad((y * w).sum(), xk)
        xr = x.detach().double().requires_grad_()
        (want,) = torch.autograd.grad(
            (_upfirdn_ref(xr, taps, up, down, pad) * w.double()).sum(), xr)
        pairs.append((got, want))
    return _compare(pairs)


# -- K7a and K7b: the StyleGAN2 activation ---------------------------------------------

def _act_cases(dtype, device):
    g = _gen(device, 7)
    for shape in ((2, 8, 17, 16), (4, 64)):  # an NCHW map and the discriminator's rows
        yield (_randn(shape, g, device).to(dtype), 0.5 * _randn(shape[1:2], g, device),
               _randn(shape, g, device).to(dtype))


def _act_ref(x, b):
    v = x + b.view(1, -1, *([1] * (x.dim() - 2)))
    return _leaky(v, 0.2) * _SQRT2


def check_k7a(dtype, device):
    from face_mask_inpaint_tpu_torch.kernels.fused_act import fused_leaky_relu

    return _compare([(fused_leaky_relu(x, b), _act_ref(x.double(), b.double()))
                     for x, b, _ in _act_cases(dtype, device)])


def check_k7b(dtype, device):
    from face_mask_inpaint_tpu_torch.kernels.fused_act import fused_leaky_relu

    pairs = []
    for x, b, w in _act_cases(dtype, device):
        leaves = [x.detach().requires_grad_(), b.to(dtype).requires_grad_()]
        got = torch.autograd.grad((fused_leaky_relu(*leaves) * w).sum(), leaves)
        ref = [x.detach().double().requires_grad_(), b.to(dtype).double().requires_grad_()]
        want = torch.autograd.grad((_act_ref(*ref) * w.double()).sum(), ref)
        pairs += list(zip(got, want))
    return _compare(pairs)


# check id -> (function, the kernels (launch-count names) it must launch on the card)
CHECKS = {
    "K1": (check_k1, ("flash_attention_fwd",)),
    "K2": (check_k2, ("instance_norm_act",)),
    "K3": (check_k3, ("output_head",)),
    "K4a": (check_k4a, ("convt_pair",)),
    "K4b": (check_k4b, ("conv3x3_stats",)),
    "K5": (check_k5, ("flash_attention_fwd", "flash_attention_bwd")),
    "K6": (check_k6, ("upfirdn2d",)),
    "K6_bwd": (check_k6_bwd, ("upfirdn2d", "upfirdn2d_bwd")),
    "K7a": (check_k7a, ("fused_leaky_relu",)),
    "K7b": (check_k7b, ("fused_leaky_relu", "fused_leaky_relu_bwd")),
    "RES": (check_res, ("residual_bias_add",)),
}


def run_checks(device: str) -> dict:
    """{check id: {ok, max_abs_diff, rel_diff, launches, float32: {...},
    bfloat16: {...}}} and ``all_ok``; a check that raises fails."""
    results, all_ok = {}, True
    for name, (fn, kernels) in CHECKS.items():
        row = {"max_abs_diff": 0.0, "rel_diff": 0.0}
        reset_launch_counts()
        try:
            ok = True
            for dtype in DTYPES:
                res = fn(dtype, device)
                res["tol"] = TOL[dtype]
                res["ok"] = res["rel_diff"] <= TOL[dtype]
                row[str(dtype).split(".")[-1]] = res
                ok = ok and res["ok"]
                row["max_abs_diff"] = max(row["max_abs_diff"], res["max_abs_diff"])
                row["rel_diff"] = max(row["rel_diff"], res["rel_diff"])
            counts = launch_counts()
            row["launches"] = {k: counts[k] for k in kernels}
            if device == "cuda":
                ok = ok and all(counts[k] > 0 for k in kernels)
            row["ok"] = ok
        except Exception as e:  # record, don't abort the sweep
            row.update(ok=False, error=f"{type(e).__name__}: {e}"[:300])
            traceback.print_exc()
        results[name] = row
        all_ok = all_ok and row["ok"]
    reset_launch_counts()
    return {"checks": results, "all_ok": all_ok}


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT, help="where the JSON goes")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda launches the kernels; cpu runs their plain versions")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("validate_kernels: CUDA is not available (pass --device cpu to check the plain "
              "versions)", file=sys.stderr)
        return 2
    report = {"device": args.device}
    if args.device == "cuda":
        report["card"] = _card()
        report["kernels"] = "the hand-written kernels"
    else:
        report["kernels"] = "the plain versions (--device cpu): no kernel ran"
    report.update(run_checks(args.device))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernel_validation": report["all_ok"], "device": args.device,
                      "path": str(out)}))
    return 0 if report["all_ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
