"""The schedules of K4b's split-precision route and of the fused K6, emulated
in plain torch on the CPU, against the plain versions.

K4b "tf32x3" (csrc/decoder_conv.cu ``conv3x3_tf32x3_kernel``): the weights
packed hi and lo as [2, 9, co_pad, c_pad] by the wrapper's own
``_weights_tf32x3``; the input's prologue in f32, the zero halo written after
it, then split into hi and lo tiles by the wrapper's ``tf32_split``; per
8-channel chunk, the nine taps' products lo·hi + hi·lo + hi·hi summed into a
zeroed f32 partial, which is then added to the total (one rounded add); the
bias, the stats of the f32 value, the activation. Each product of TF32 parts
is exact in f32; the emulated sums round to nearest, which the tensor cores'
accumulate does not, so the kernel itself is held against the plain version
on the card (chip_smoke.py, tests/test_torch_kernels_cuda.py). Held to the
card's f32 gates: |y - plain| <= 1e-4 + 1e-4 |plain| and the sums of y and
y^2 within rtol 1e-4 of the plain sums plus 1e-4 of the largest. The
negative control: one TF32 product (hi·hi, what allow_tf32 means) misses
the output gate.

K6 (csrc/upfirdn2d.cu ``upfirdn2d_kernel``): each output tile stages the
input window ``_window`` names (zeros outside the image), runs the H pass over
the window's columns and rounds it to x's dtype, then the W pass; every sum
a multiply and an add a tap in tap order, as the plain version takes it. So
the emulation is held to ``upfirdn2d_plain`` bit for bit, in float32 and in
bfloat16, for every mode, ragged tiles (the kernel's tiles and small ones
that cut the maps into many), negative and transposed pads and 16 taps.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from face_mask_inpaint_tpu_torch.kernels import decoder_conv as dc
from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as fir

CK = 8  # K4b tf32x3's input channels a chunk
# K6's output tile of one block per mode (up, down), (rows, columns):
# csrc/upfirdn2d.cu ``Tile``
K6_TILES = {(1, 1): (32, 128), (2, 1): (64, 128), (1, 2): (16, 64)}
F32_TOL = (1e-4, 1e-4)
STATS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pad_to(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _k4b_tf32x3(x, w, b, prologue, act, products=3):
    """K4b's split-precision schedule: (out, (sum y, sum y^2))."""
    n, c, h, wd = x.shape
    co = w.shape[0]
    co_pad, c_pad = _pad_to(co, 8), _pad_to(c, 16)
    wp = dc._weights_tf32x3(w, c_pad, co_pad)
    assert wp.shape == (2, 9, co_pad, c_pad)
    staged = F.pad(dc._prologued(x, prologue), (1, 1, 1, 1, 0, c_pad - c))
    sh, sl = dc.tf32_split(staged)
    total = torch.zeros(n, co_pad, h, wd)
    for c0 in range(0, c, CK):
        part = torch.zeros(n, co_pad, h, wd)
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            ah, al = (s[:, c0:c0 + CK, ky:ky + h, kx:kx + wd] for s in (sh, sl))
            bh, bl = (wp[i, tap, :, c0:c0 + CK] for i in (0, 1))
            terms = [(al, bh), (ah, bl), (ah, bh)] if products == 3 else [(ah, bh)]
            for a, bb in terms:
                part = part + torch.einsum("nchw,oc->nohw", a, bb)
        total = total + part
    y = total[:, :co] + dc._bias32(b, co, x.device)[None, :, None, None]
    return dc._finish(y, act, True, x.dtype)


def _k4b_case(seed, n, c, h, w, co, pro, act):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy((rs.randn(n, c, h, w) * 1.5 + 0.2).astype(np.float32))
    wt = torch.from_numpy((rs.randn(co, c, 3, 3) / (3 * c ** 0.5)).astype(np.float32))
    b = torch.from_numpy((0.5 * rs.randn(co)).astype(np.float32))
    prologue = None
    if pro is not None:
        prologue = (torch.from_numpy((0.5 + rs.rand(n, c)).astype(np.float32)),
                    torch.from_numpy((0.3 * rs.randn(n, c)).astype(np.float32)), pro)
    return x, wt, b, prologue, act


def _gate_used(got, want):
    """The largest share of the f32 output gate and of the stats gate used."""
    (y, (s1, s2)), (ref, (r1, r2)) = got, want
    out = float(((y - ref).abs() / (F32_TOL[0] + F32_TOL[1] * ref.abs())).max())
    stats = max(float(((g - r).abs() / (STATS_RTOL * (r.abs() + r.abs().max()))).max())
                for g, r in ((s1, r1), (s2, r2)))
    return out, stats


def test_tf32_split_rounds_to_nearest_ties_away():
    """tf32_split's hi keeps 10 mantissa bits rounded to nearest, a tie away
    from zero on either sign; hi + lo keeps about 21 bits."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23, 1 + 3 * ulp, 0.0])
    hi, lo = dc.tf32_split(x)
    assert torch.equal(hi, torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 3 * ulp, 0.0]))
    r = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi, lo = dc.tf32_split(r)
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((r - hi - lo).abs() / r.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("n,c,h,w,co,pro,act", [
    (2, 40, 13, 20, 64, "LeakyReLU", None), (1, 21, 9, 12, 3, "ReLU", "LeakyReLU"),
    (2, 13, 7, 8, 80, None, "ReLU"), (1, 64, 10, 16, 32, "none", None),
    (1, 5, 6, 4, 16, "LeakyReLU", "LeakyReLU")])
def test_k4b_tf32x3_schedule_meets_f32_gate(n, c, h, w, co, pro, act):
    """Three TF32 products a chunk, zeroed partials and rounded adds: the
    output and the stats within the card's f32 gates, with C off the chunk
    and Co off the channel block."""
    args = _k4b_case(1, n, c, h, w, co, pro, act)
    out, stats = _gate_used(_k4b_tf32x3(*args), dc.conv3x3_stats_plain(*args, with_stats=True))
    assert out <= 1.0 and stats <= 1.0, (out, stats)


def test_k4b_one_tf32_product_misses_the_gate():
    """The negative control: hi·hi alone leaves the f32 output gate on the
    inputs where the three products stay inside it."""
    args = _k4b_case(2, 2, 64, 12, 16, 32, "LeakyReLU", None)
    want = dc.conv3x3_stats_plain(*args, with_stats=True)
    one, _ = _gate_used(_k4b_tf32x3(*args, products=1), want)
    three, _ = _gate_used(_k4b_tf32x3(*args), want)
    assert one > 1.0 and three <= 1.0, (one, three)


def _window(o0, n, up, down, pad0, k):
    """(i0, count): the input positions [i0, i0 + count) that outputs
    [o0, o0 + n) read along one axis, as a block of the kernel stages them
    (csrc/upfirdn2d.cu ``window``): tap t of output o reads the upsampled
    position o * down - pad0 + t, input position (that) / up."""
    j0 = o0 * down - pad0
    i0 = j0 // up
    return i0, (j0 + (n - 1) * down + k - 1) // up - i0 + 1


def _k6_tiled(x, taps, up, down, pad, tile):
    """K6's tile schedule: per output tile, the staged window, the H pass
    rounded to x's dtype, the W pass; sums as the plain version takes them."""
    k = fir._flipped(taps)
    n, c, h, w = x.shape
    ho, wo = (fir.out_len(s, up, down, *pad, len(k)) for s in (h, w))
    out = torch.empty(n, c, ho, wo, dtype=x.dtype)

    def fir_pass(v, o0, n_out, i0, dim):
        """Outputs [o0, o0 + n_out) along dim of the window v that starts at
        input position i0: tap t of output o reads upsampled position
        o * down - pad0 + t, kept when its phase is 0."""
        acc = 0.0
        jb = torch.arange(o0, o0 + n_out) * down - pad[0] - i0 * up
        for t, kt in enumerate(k):
            j = jb + t
            prod = float(kt) * v.index_select(dim, torch.div(j, up, rounding_mode="floor"))
            keep = (j % up == 0).view([-1 if d == dim else 1 for d in range(4)])
            acc = acc + torch.where(keep, prod, torch.zeros_like(prod))
        return acc.to(x.dtype)

    for oy0 in range(0, ho, tile[0]):
        rows = min(tile[0], ho - oy0)
        iy0, nh = _window(oy0, rows, up, down, pad[0], len(k))
        for ox0 in range(0, wo, tile[1]):
            cols = min(tile[1], wo - ox0)
            ix0, nw = _window(ox0, cols, up, down, pad[0], len(k))
            win = torch.zeros(n, c, nh, nw)  # zeros outside the image
            ys, xs = slice(max(iy0, 0), min(iy0 + nh, h)), slice(max(ix0, 0), min(ix0 + nw, w))
            if ys.start < ys.stop and xs.start < xs.stop:
                win[:, :, ys.start - iy0:ys.stop - iy0, xs.start - ix0:xs.stop - ix0] = \
                    x[:, :, ys, xs].float()
            mid = fir_pass(win, oy0, rows, iy0, 2).float()
            out[:, :, oy0:oy0 + rows, ox0:ox0 + cols] = fir_pass(mid, ox0, cols, ix0, 3)
    return out


K6_CASES = [  # (shape, up, down, pad, taps)
    ((1, 2, 70, 300), 1, 1, (1, 1), [1, 3, 3, 1]),     # ragged blur tiles in both axes
    ((1, 3, 33, 129), 1, 1, (2, 2), [1, 3, 3, 1]),     # the blur's backward pads
    ((1, 3, 40, 70), 2, 1, (2, 1), [1, 3, 3, 1]),      # skip upsample, polyphase
    ((2, 1, 38, 142), 1, 2, (1, 1), [1, 3, 3, 1]),     # the skip upsample's backward
    ((1, 2, 37, 150), 1, 1, (-2, 3), [1, 2, 3, 4]),    # a negative pad crops
    ((1, 2, 35, 133), 2, 1, (1, 2), [1, 2, 3, 4]),
    ((1, 2, 45, 140), 1, 2, (2, 2), [1, 2, 3, 4]),
    ((1, 1, 50, 140), 1, 1, (9, 6), list(range(1, 17))),  # 16 taps
    ((1, 1, 30, 70), 2, 1, (8, 7), list(range(16, 0, -1))),
    ((1, 1, 48, 150), 1, 2, (7, 7), list(range(1, 17))),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("small_tiles", [False, True])
@pytest.mark.parametrize("shape,up,down,pad,taps", K6_CASES)
def test_k6_tile_schedule_equals_plain(shape, up, down, pad, taps, small_tiles, dtype):
    """The fused kernel's tile schedule, at its own tiles (K6_TILES, at
    least two a map in each axis here) and at 5 x 7 tiles, gives
    upfirdn2d_plain's values bit for bit."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)
    k = [float(t) for t in np.asarray(taps, np.float32) / np.sum(taps)]
    tile = (5, 7) if small_tiles else K6_TILES[(up, down)]
    want = fir.upfirdn2d_plain(x, k, up, down, pad)
    got = _k6_tiled(x, k, up, down, pad, tile)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("up,down", fir.MODES)
def test_k6_window_covers_the_taps(up, down):
    """``_window`` stages every input position a tile's taps read (of their
    own phase), and no more than the kernel's shared memory is sized for
    (csrc/upfirdn2d.cu ``span``: ((n - 1) down + K - 1) / up + 2)."""
    for k in (1, 4, 16):
        for pad0 in (-3, 0, 2, 9):
            for o0 in (0, 5, 64):
                for n in (1, 7, 64):
                    i0, count = _window(o0, n, up, down, pad0, k)
                    reads = [(o * down - pad0 + t) // up for o in range(o0, o0 + n)
                             for t in range(k) if (o * down - pad0 + t) % up == 0]
                    assert all(i0 <= i < i0 + count for i in reads)
                    assert count <= ((n - 1) * down + k - 1) // up + 2
