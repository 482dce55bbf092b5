"""The schedules of K4b's and K4a's split-precision routes, of the fused K6,
of K2, K3 and of K7a's routes, emulated in plain torch on the CPU, against
the plain versions.

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

K4a "tf32x3" (``convt_pair_tf32x3_kernel``) the same way over one or two
streams: each stream's weights packed by the wrapper's own
``_convt_weights_tf32x3``, its prologue, then the zero row and column of
output_padding, the split; per 8-channel chunk of each stream, each output
parity's taps (one, two or four) into a zeroed partial, added to that
parity's total with one rounded add; the streams' biases summed. Also held
against JAX's ``packed_convt_pair`` (the Pallas kernel in interpret mode).

K6 (csrc/upfirdn2d.cu ``upfirdn2d_kernel``): each output tile stages the
input window ``_window`` names (zeros outside the image), runs the H pass over
the window's columns and rounds it to x's dtype, then the W pass; every sum
a multiply and an add a tap in tap order, as the plain version takes it. So
the emulation is held to ``upfirdn2d_plain`` bit for bit, in float32 and in
bfloat16, for every mode, ragged tiles (the kernel's tiles and small ones
that cut the maps into many), negative and transposed pads and 16 taps.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from face_mask_inpaint_tpu_torch.kernels import decoder_conv as dc
from face_mask_inpaint_tpu_torch.kernels import fused_act as act
from face_mask_inpaint_tpu_torch.kernels import norm_act as na
from face_mask_inpaint_tpu_torch.kernels import output_head as oh
from face_mask_inpaint_tpu_torch.kernels import upfirdn2d as fir

CK = 8  # K4b's and K4a's tf32x3 input channels a chunk
# K6's output tile of one block per mode (up, down), (rows, columns):
# csrc/upfirdn2d.cu ``Tile``
K6_TILES = {(1, 1): (32, 128), (2, 1): (64, 128), (1, 2): (16, 64)}
F32_TOL = (1e-4, 1e-4)
SQRT2 = math.sqrt(2.0)
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


def _parity_taps(q):
    """(tap, dr, dc) of K4a's output parity q = py * 2 + px: even o = 2m
    reads k = 1 at m, odd o = 2m + 1 reads k = 2 at m and k = 0 at m + 1."""
    def axis(p):
        return [(1, 0)] if p == 0 else [(2, 0), (0, 1)]
    return [(ky * 3 + kx, dr, dc) for ky, dr in axis(q >> 1) for kx, dc in axis(q & 1)]


def _k4a_tf32x3(streams, act, products=3):
    """K4a's split-precision schedule: (out, (sum y, sum y^2))."""
    x0, co = streams[0][0], streams[0][1].shape[1]
    n, _, h, wd = x0.shape
    co_pad = _pad_to(co, 8)
    totals = [torch.zeros(n, co_pad, h, wd) for _ in range(4)]
    for x, w, _, prologue in streams:
        c = x.shape[1]
        c_pad = _pad_to(c, 16)
        wp = dc._convt_weights_tf32x3(w, c_pad, co_pad)
        assert wp.shape == (2, 9, co_pad, c_pad)
        # the zero row and column of output_padding, after the prologue
        sh, sl = dc.tf32_split(F.pad(dc._prologued(x, prologue), (0, 1, 0, 1, 0, c_pad - c)))
        for c0 in range(0, c, CK):
            for q in range(4):
                part = torch.zeros(n, co_pad, h, wd)
                for tap, dr, dcol in _parity_taps(q):
                    ah, al = (t[:, c0:c0 + CK, dr:dr + h, dcol:dcol + wd] for t in (sh, sl))
                    bh, bl = (wp[i, tap, :, c0:c0 + CK] for i in (0, 1))
                    terms = [(al, bh), (ah, bl), (ah, bh)] if products == 3 else [(ah, bh)]
                    for a, bb in terms:
                        part = part + torch.einsum("nchw,oc->nohw", a, bb)
                totals[q] = totals[q] + part
    y = torch.empty(n, co, 2 * h, 2 * wd)
    for q, total in enumerate(totals):
        y[:, :, q >> 1::2, q & 1::2] = total[:, :co]
    y = y + dc._pair_bias(streams, co, x0.device)[None, :, None, None]
    return dc._finish(y, act, True, x0.dtype)


def _k4a_case(seed, n, cs, pros, h, w, co):
    """Streams (x, w, b, prologue) with x [n, c, h, w] and torch's
    ConvTranspose2d weight [c, co, 3, 3], one a channel count of cs."""
    rs = np.random.RandomState(seed)
    streams = []
    for c, pro in zip(cs, pros):
        x = torch.from_numpy((rs.randn(n, c, h, w) * 1.5 + 0.2).astype(np.float32))
        wt = torch.from_numpy((rs.randn(c, co, 3, 3) / (3 * c ** 0.5)).astype(np.float32))
        b = torch.from_numpy((0.5 * rs.randn(co)).astype(np.float32))
        prologue = None
        if pro is not None:
            prologue = (torch.from_numpy((0.5 + rs.rand(n, c)).astype(np.float32)),
                        torch.from_numpy((0.3 * rs.randn(n, c)).astype(np.float32)), pro)
        streams.append((x, wt, b, prologue))
    return streams


# two streams (the first with a prologue, as the decoder runs them) and one;
# C off the 8-channel chunk, Co off the channel block (3, 16, 80), H and W
# off the tile
@pytest.mark.parametrize("n,cs,pros,h,w,co,act", [
    (2, (16, 13), ("LeakyReLU", None), 9, 12, 16, None),
    (1, (21, 5), ("ReLU", None), 7, 8, 3, "LeakyReLU"),
    (2, (13,), (None,), 5, 4, 80, "ReLU"),
    (1, (32, 64), ("LeakyReLU", None), 6, 10, 32, "LeakyReLU")])
def test_k4a_tf32x3_schedule_meets_f32_gate(n, cs, pros, h, w, co, act):
    """Three TF32 products a tap, each parity's chunk in a zeroed partial and
    rounded adds: the output and the stats within the card's f32 gates."""
    streams = _k4a_case(3, n, cs, pros, h, w, co)
    out, stats = _gate_used(_k4a_tf32x3(streams, act),
                            dc.convt_pair_plain(streams, act, with_stats=True))
    assert out <= 1.0 and stats <= 1.0, (out, stats)


def test_k4a_one_tf32_product_misses_the_gate():
    """The negative control: hi·hi alone leaves the f32 output gate on the
    inputs where the three products stay inside it."""
    streams = _k4a_case(4, 2, (32, 64), ("LeakyReLU", None), 8, 8, 32)
    want = dc.convt_pair_plain(streams, None, with_stats=True)
    one, _ = _gate_used(_k4a_tf32x3(streams, None, products=1), want)
    three, _ = _gate_used(_k4a_tf32x3(streams, None), want)
    assert one > 1.0 and three <= 1.0, (one, three)


def test_k4a_tf32x3_schedule_matches_jax_kernel():
    """The emulated schedule against JAX's packed_convt_pair (the Pallas
    kernel in interpret mode, unpacked NHWC at r = 1) at the f32 gates:
    two streams, the prologue on the first, weights from JAX's HWIO
    ConvTranspose kernels through convert.py."""
    import jax.numpy as jnp

    from face_mask_inpaint_tpu.ops import packed as jpacked
    from face_mask_inpaint_tpu.ops.pallas import packed_convt as jpc
    from face_mask_inpaint_tpu_torch.convert import state_dict_from_jax
    from face_mask_inpaint_tpu_torch.nn.layers import ConvTranspose2d

    rs = np.random.RandomState(5)
    n, h, w, ch, cx, co = 2, 6, 8, 12, 20, 16
    hx = (rs.randn(n, h, w, ch) + 0.2).astype(np.float32)
    xx = rs.randn(n, h, w, cx).astype(np.float32)
    wh = (rs.randn(3, 3, ch, co) / np.sqrt(9 * ch)).astype(np.float32)
    wx = (rs.randn(3, 3, cx, co) / np.sqrt(9 * cx)).astype(np.float32)
    bh, bx = ((0.5 * rs.randn(co)).astype(np.float32) for _ in range(2))
    pa, pb = (0.5 + rs.rand(n, ch)).astype(np.float32), (0.3 * rs.randn(n, ch)).astype(np.float32)
    want, (ws1, ws2) = jpc.packed_convt_pair(
        [(jnp.asarray(hx), jnp.asarray(wh), jnp.asarray(bh),
          (jnp.asarray(pa), jnp.asarray(pb), "LeakyReLU")),
         (jnp.asarray(xx), jnp.asarray(wx), jnp.asarray(bx))], 1, act=None, with_stats=True)
    want = torch.from_numpy(np.array(jpacked.depth_to_space(want, 2)).transpose(0, 3, 1, 2))

    def port(x, w_hwio, b, c, prologue=None):
        sd = state_dict_from_jax(ConvTranspose2d(c, co), {"params": {"kernel": w_hwio,
                                                                    "bias": b}})
        return (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
                sd["weight"], sd["bias"], prologue)

    streams = [port(hx, wh, bh, ch, (torch.from_numpy(pa), torch.from_numpy(pb), "LeakyReLU")),
               port(xx, wx, bx, cx)]
    ref = (want, (torch.from_numpy(np.array(ws1)), torch.from_numpy(np.array(ws2))))
    out, stats = _gate_used(_k4a_tf32x3(streams, None), ref)
    assert out <= 1.0 and stats <= 1.0, (out, stats)


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


# ---------------------------------------------------------------------------
# K7a (csrc/fused_act.cu): the wrapper's ``_plan`` (route, threads, chunk)
# and the kernels' index mapping. "plane": block b takes chunk b % parts of
# plane b // parts and reads that plane's bias once; "flat": block b takes
# chunk b of the flat tensor, and each vector finds the channel of its first
# element with one division, then steps through the planes its elements
# cross. In a chunk, with x and y at one offset ``mis`` from a 16-byte
# boundary: single elements up to the first boundary, thread t's vectors
# t + u * threads (u < _UNROLL), single elements after the last whole
# vector; with x and y at different offsets (mis -1): single elements, a
# thread every threads-th. The emulation lists each block's pieces, asserts
# that they cover the tensor once, every element with its own plane's bias,
# then computes y in the kernel's arithmetic (the f32 add, the slope's and
# the gain's products, each rounded, one rounding to x's dtype). Held to
# fused_leaky_relu_plain bit for bit.
# ---------------------------------------------------------------------------


def _k7a_chunks(begin, end, threads, vec, mis, unroll):
    """(singles, vectors): lists of (start, stop) tensors over the blocks
    whose chunks are [begin, end), as csrc/fused_act.cu ``run_chunk`` cuts
    them; every vector piece starts on a 16-byte boundary."""
    if mis < 0:
        starts = [begin + s * threads for s in range(unroll * vec)]
        return [(a, torch.minimum(end, a + threads)) for a in starts], []
    a0 = torch.minimum(end, begin + (vec - (mis + begin) % vec) % vec)
    nv = (end - a0) // vec
    tail = a0 + nv * vec
    assert bool((a0 - begin < threads).all() and (end - tail < threads).all())
    vectors = [(a0 + torch.clamp(nv, max=u * threads) * vec,
                a0 + torch.clamp(nv, max=(u + 1) * threads) * vec) for u in range(unroll)]
    for a, _ in vectors:
        assert bool(((mis + a) % vec == 0).all())
    return [(begin, a0), (tail, end)], vectors


def _k7a_emulate(x, bias, mis=0, slope=0.2, scale=SQRT2, unroll=None):
    """y as K7a computes it, x [N, C, ...] contiguous, x and y ``mis``
    elements past a 16-byte boundary (-1: at different offsets)."""
    unroll = act._UNROLL if unroll is None else unroll
    n, c = x.shape[:2]
    hw, planes = math.prod(x.shape[2:]), n * c
    total, vec = planes * hw, 16 // x.element_size()
    plan = act._plan(hw, x.element_size())
    assert plan.chunk == plan.threads * act._UNROLL * vec and plan.threads % 32 == 0
    if plan.route == "plane":
        assert hw >= act._FLAT_BELOW
        parts = -(-hw // plan.chunk)
        blk = torch.arange(planes * parts)
        plane = blk // parts
        first = (blk - plane * parts) * plan.chunk
        begin, end = plane * hw + first, plane * hw + torch.clamp(first + plan.chunk, max=hw)
    else:
        assert hw < act._FLAT_BELOW and plan.threads == act._THREADS
        begin = torch.arange(-(-total // plan.chunk)) * plan.chunk
        end = torch.clamp(begin + plan.chunk, max=total)
    singles, vectors = _k7a_chunks(begin, end, plan.threads, vec, mis, unroll)
    pieces = singles + vectors
    starts = torch.cat([torch.minimum(a, b) for a, b in pieces])
    stops = torch.cat([b for _, b in pieces])
    keep = stops > starts
    starts, order = starts[keep].sort()
    stops = stops[keep][order]
    assert int(starts[0]) == 0 and int(stops[-1]) == total, "the pieces miss the ends"
    assert bool((starts[1:] == stops[:-1]).all()), "the pieces overlap or leave a gap"
    xf = x.reshape(-1).float()
    if bias is None:
        v = xf
    elif plan.route == "plane":
        # a block's pieces lie in its plane, whose one bias it reads
        for a, b in pieces:
            inside = (a >= plane * hw) & (b <= plane * hw + hw)
            assert bool((inside | (b <= a)).all())
        v = (xf.view(planes, hw) + bias.float()[plane[::parts] % c][:, None]).view(-1)
    else:
        channel = torch.full((total,), -1, dtype=torch.long)
        for a, b in singles:  # element by element: (i // hw) % C
            for i0, i1 in zip(a.tolist(), b.tolist()):
                channel[i0:max(i0, i1)] = torch.arange(i0, max(i0, i1)) // hw % c
        for a, b in vectors:  # one division a vector, then a step an element
            i0 = torch.cat([torch.arange(s, e, vec) for s, e in zip(a.tolist(), b.tolist())])
            q = i0 // hw
            r, ch = i0 - q * hw, q % c
            for j in range(vec):
                channel[i0 + j] = ch
                r = r + 1
                wrap = r == hw
                r, ch = torch.where(wrap, 0, r), torch.where(wrap, ch + 1, ch)
                ch = torch.where(ch == c, 0, ch)
        assert bool((channel >= 0).all())
        v = xf + bias.float()[channel]
    y = torch.where(v >= 0, v, v * slope) * scale
    return y.to(x.dtype).view(x.shape)


def _k7a_shapes():
    """The distinct shapes of the 17 K7a calls of a config-4 forward at batch
    1 (chip_smoke.py ``_psp_kernel_shapes``)."""
    from face_mask_inpaint_tpu_torch.models.stylegan2 import channels_for

    ch = channels_for(1024)
    return [(1, ch[r], r, r) for r in (2 ** i for i in range(2, 11))]


K7A_CASES = [  # (shape, bias, mis): bias "f32", "bf16" or None
    *[(shape, "f32", 0) for shape in _k7a_shapes()],
    ((16, 512, 4, 4), "f32", 0),     # 4^2 x 512 at batch 16: flat
    ((7, 13), "f32", 0),             # [N, C] rows: every element its own channel
    ((300, 513), "bf16", 0),         # rows, N * C above 65,535
    ((3, 5, 37, 41), "f32", 0),      # ragged planes: a head and a tail in most
    ((2, 3, 17, 19), "bf16", 0),     # hw 323, no multiple of 8
    ((2, 3, 5, 7), "f32", 0),        # hw 35, flat, vectors across planes
    ((3, 5, 37, 41), "f32", -1),     # x one element off y's offset: singles only
    ((2, 5, 9, 11), "f32", -1),
    ((2, 32, 64, 64), "bf16", 3),    # x and y 3 elements past a boundary
    ((2, 3, 9, 11), None, 0),        # no bias
    ((2, 40, 33, 33), None, 1),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,bias,mis", K7A_CASES)
def test_k7a_plan_and_mapping_equal_plain(shape, bias, mis, dtype):
    """Every element once, with its own channel's bias, and the kernel's
    arithmetic: fused_leaky_relu_plain bit for bit, in f32 and bf16."""
    gen = torch.Generator().manual_seed(19)
    x = (torch.randn(shape, generator=gen) * 2).to(dtype)
    b = None if bias is None else torch.randn(shape[1], generator=gen).to(
        torch.float32 if bias == "f32" else torch.bfloat16)
    got = _k7a_emulate(x, b, mis)
    assert got.dtype == dtype and torch.equal(got, act.fused_leaky_relu_plain(x, b))


def test_k7a_one_vector_less_a_thread_leaves_a_gap():
    """The negative control: with one vector a thread fewer than the chunk
    is sized for, the pieces no longer cover the plane."""
    x = torch.randn(2, 4, 64, 64)
    _k7a_emulate(x, torch.randn(4))
    with pytest.raises(AssertionError, match="gap|ends"):
        _k7a_emulate(x, torch.randn(4), unroll=act._UNROLL - 1)


def test_k7a_routes_and_blocks():
    """The plane route from 16^2 up and for ragged planes of 256 elements or
    more; a plane under a full chunk gets the warps its vectors fill."""
    for shape in _k7a_shapes():
        for dtype in (torch.float32, torch.bfloat16):
            want = "flat" if shape[2] < 16 else "plane"
            assert act.fused_leaky_relu_route(shape, dtype) == want
    assert act.fused_leaky_relu_route((16, 512), torch.bfloat16) == "flat"
    assert act.fused_leaky_relu_route((3, 5, 37, 41), torch.float32) == "plane"
    assert act._plan(256, 2) == act.Plan("plane", 32, 1024)
    assert act._plan(1024, 2) == act.Plan("plane", 128, 4096)
    assert act._plan(1024, 4) == act.Plan("plane", 256, 4096)
    assert act._plan(1024 * 1024, 2) == act.Plan("plane", 256, 8192)
    assert act._plan(255, 4) == act.Plan("flat", 256, 4096)


# ---------------------------------------------------------------------------
# K2 (csrc/norm_act.cu): the plane cut as the wrapper's ``_plan`` cuts it,
# each thread's f32 sums over its 16-byte pieces in the kernel's order, the
# warps' shuffle tree, the warps and then the cluster's ranks (or the
# two-pass route's chunks) added in order, the finish with the clamp, and
# y = act(a (x - mean) + bias) with one fused multiply-add, rounded once.
# The kernel's fused multiply-adds are taken in float64 and rounded to f32
# (exact but for a rare double rounding), its rsqrtf as torch.rsqrt: the
# emulation is held to instance_norm_act_plain at the card's gates, not bit
# for bit.
# ---------------------------------------------------------------------------

K2_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 2.0 ** -7)}
DECODER_NORMS = [(256, 32), (256, 64), (256, 128), (128, 256), (64, 512), (32, 512)]


def _k2_sums(data, starts, length, hw, threads, itemsize):
    """(s1, s2) [spans] of the spans [start, start + len) of data (the map's
    f32 values, its first element on a 16-byte boundary) as a group of
    ``threads`` threads takes them: thread t sums pieces t, t + threads, ...
    in element order, then the shuffle tree and the warps in order."""
    e = 16 // itemsize
    starts = torch.as_tensor(starts)
    lens = torch.clamp(torch.minimum(torch.full_like(starts, length),
                                     hw - starts % hw), min=0)
    lead = starts % e
    pieces = int(((lead + lens + e - 1) // e).max())
    steps = -(-pieces // threads)
    j = torch.arange(steps * threads * e).view(1, -1)
    idx = (starts - lead).view(-1, 1) + j
    inside = (j - lead.view(-1, 1) >= 0) & (j - lead.view(-1, 1) < lens.view(-1, 1))
    vals = torch.where(inside, data[idx.clamp(max=data.numel() - 1)], torch.zeros(()))
    vals = vals.view(-1, steps, threads, e)
    s1 = torch.zeros(vals.shape[0], threads)
    s2 = torch.zeros(vals.shape[0], threads, dtype=torch.float64)
    for step in range(steps):
        for k in range(e):
            v = vals[:, step, :, k]
            s1 = s1 + v
            s2 = (s2 + v.double() * v.double()).float().double()  # fmaf(v, v, s2)
    s2 = s2.float()
    lanes = torch.arange(32)
    s1, s2 = s1.view(-1, threads // 32, 32), s2.view(-1, threads // 32, 32)
    for m in (16, 8, 4, 2, 1):
        s1, s2 = s1 + s1[..., lanes ^ m], s2 + s2[..., lanes ^ m]
    t1, t2 = torch.zeros(s1.shape[0]), torch.zeros(s1.shape[0])
    for w in range(threads // 32):
        t1, t2 = t1 + s1[:, w, 0], t2 + s2[:, w, 0]
    return t1, t2


def _k2_schedule(x, weight, bias, act, slope=0.1, eps=1e-5, clamp=True):
    """K2's schedule on the CPU; with clamp=False the variance is not
    clamped at 0, as the JAX Pallas ``_forward`` leaves it."""
    n, c, h, w = x.shape
    hw, planes = h * w, n * c
    plan = na._plan(hw, x.element_size())
    if plan.route == "cluster" and plan.planes_per_block > 1:
        threads, ranks, length = 256 // plan.planes_per_block, 1, hw
    else:
        threads, ranks, length = 256, plan.cluster, plan.slice
    starts = [p * hw + r * length for p in range(planes) for r in range(ranks)]
    s1, s2 = _k2_sums(x.float().reshape(-1), starts, length, hw, threads, x.element_size())
    t1, t2 = torch.zeros(planes), torch.zeros(planes)
    for r in range(ranks):  # the ranks (or chunks) in order
        t1, t2 = t1 + s1.view(planes, ranks)[:, r], t2 + s2.view(planes, ranks)[:, r]
    count = torch.tensor(float(hw))
    mean = t1 / count
    var = t2 / count - mean * mean
    if clamp:
        var = torch.clamp_min(var, 0.0)
    a = torch.rsqrt(var + eps)
    beta = torch.zeros(planes)
    if weight is not None:
        a = a * weight.float().repeat(n)
        beta = bias.float().repeat(n)
    xm = x.float().reshape(planes, hw) - mean[:, None]
    y = (a.double()[:, None] * xm.double() + beta.double()[:, None]).float()
    return na._act(y, act, slope).to(x.dtype).view(x.shape)


def _k2_case(seed, shape, dtype, affine=True):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy((rs.randn(*shape) * 2 + 1).astype(np.float32)).to(dtype)
    if not affine:
        return x, None, None
    w = torch.from_numpy(rs.randn(shape[1]).astype(np.float32))
    b = torch.from_numpy(rs.randn(shape[1]).astype(np.float32))
    return x, w, b


def _within(got, want, dtype):
    atol, rtol = K2_TOL[dtype]
    return float(((got.float() - want.float()).abs() / (atol + rtol * want.float().abs())).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,act,affine", [
    *[((1, min(c, 4), h, h), "LeakyReLU", True) for c, h in DECODER_NORMS],
    ((3, 5, 37, 41), "ReLU", True),      # odd hw: small planes off 16-byte boundaries
    ((1, 3, 129, 257), "none", False),   # odd hw: sliced over a cluster
    ((1, 1, 1024, 1024), "LeakyReLU", True),  # two_pass
])
def test_k2_schedule_meets_gate(shape, act, affine, dtype):
    """The one-read schedule (and the two-pass route's chunks) within the
    card's gates of the plain version, at the flagship decoder norms' plane
    sizes (batch and channels cut) and at ragged ones."""
    x, w, b = _k2_case(4, shape, dtype, affine)
    used = _within(_k2_schedule(x, w, b, act), na.instance_norm_act_plain(x, w, b, act), dtype)
    assert used <= 1.0, used


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 32, 32), (1, 2, 256, 256), (1, 1, 1024, 1024)])
def test_k2_schedule_constant_plane_gives_zeros(shape, dtype):
    """A plane whose values all equal its mean: zeros, finite, as the plain
    version gives, on the small-plane, cluster and two-pass cuts."""
    x = torch.full(shape, 1.5, dtype=dtype)
    y = _k2_schedule(x, None, None, "LeakyReLU")
    assert bool(torch.isfinite(y).all()) and bool((y == 0).all())
    assert torch.equal(y, na.instance_norm_act_plain(x, None, None, "LeakyReLU"))


def test_k2_schedule_clamps_the_variance():
    """The kernel's finish clamps the variance at 0, as
    ``instance_norm_act_reference`` does and the JAX Pallas ``_forward``
    does not: on a constant f32 plane of 1000.1 the f32 sums leave
    E[x^2] - mean^2 below -eps, so without the clamp rsqrt gives NaN; with it
    the output is finite, as the plain version's is. (Neither is zero: each
    side's rounding of the mean is scaled by rsqrt(eps), so the two are not
    held to the gate on such a plane.)"""
    x = torch.full((1, 2, 37, 41), 1000.1)
    assert bool(torch.isnan(_k2_schedule(x, None, None, "none", clamp=False)).all())
    assert bool(torch.isfinite(_k2_schedule(x, None, None, "none")).all())
    assert bool(torch.isfinite(na.instance_norm_act_plain(x, None, None, "none")).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [1, 7, 1024, 1517, 4096, 4097, 16384, 16388, 33153, 65540,
                                262144, 462816, 925632, 925696, 1048576])
def test_k2_plan_covers_the_plane(hw, dtype):
    """Every plan covers its plane exactly once in slices that start on
    16-byte boundaries, fits the kernel's shared memory, and takes the
    cluster route while 8 blocks can hold the plane."""
    es = torch.empty((), dtype=dtype).element_size()
    plan = na._plan(hw, es)
    assert plan.cluster * plan.slice >= hw > (plan.cluster - 1) * plan.slice
    if plan.route == "two_pass":
        assert na._cap(-(-hw // 8), es) > na._SMEM and plan.planes_per_block == 1
        return
    assert plan.planes_per_block in (1, 2, 4, 8) and 1 <= plan.cluster <= 8
    assert plan.planes_per_block == 1 or (plan.cluster == 1 and plan.slice == hw)
    assert plan.planes_per_block * na._cap(plan.slice, es) <= na._SMEM
    assert plan.cluster == 1 or plan.slice * es % 16 == 0


def test_k2_routes_of_the_flagship():
    """Every decoder norm of the flagship, config 5 and the f32 CLI takes the
    cluster route; [2, 3, 1024, 1024] takes two_pass."""
    for c, h in DECODER_NORMS:
        for dtype in (torch.float32, torch.bfloat16):
            assert na.norm_act_route((16, c, h, h), dtype) == "cluster"
    for dtype in (torch.float32, torch.bfloat16):
        assert na.norm_act_route((2, 3, 1024, 1024), dtype) == "two_pass"


# ---------------------------------------------------------------------------
# K3 "mma_sync" (csrc/output_head.cu ``output_head_mma_kernel``): act(h + s)
# staged in bf16 with act_sum's roundings (h + s rounded, then the slope's
# product rounded), a one-pixel reflected halo, the weights as the wrapper's
# ``_weights_mma`` packs them (bf16, co padded to 8, C to 16), per 16-channel
# chunk and per tap the products summed into f32, bias and tanh in f32, each
# f x f cell summed in row-major order, times 1 / f^2, rounded once. Held to
# output_head_plain at the bf16 gate; the negative control stages a zero
# halo and misses the gate on the border.
# ---------------------------------------------------------------------------


def _k3_mma(h, s, weight, bias, act, pool, halo="reflect"):
    n, c, height, width = h.shape
    co = weight.shape[0]
    a = (h.float() + s.float()).to(torch.bfloat16).float()
    neg = (a * 0.1).to(torch.bfloat16).float() if act == "LeakyReLU" else torch.zeros_like(a)
    a = torch.where(a >= 0, a, neg)
    a = F.pad(a, (1, 1, 1, 1), mode=halo) if halo == "reflect" else F.pad(a, (1, 1, 1, 1))
    c_pad = -(-c // 16) * 16
    a = F.pad(a, (0, 0, 0, 0, 0, c_pad - c))
    wm = oh._weights_mma(weight, c_pad).float()
    acc = torch.zeros(n, 8, height, width)
    for c0 in range(0, c_pad, 16):
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            acc = acc + torch.einsum("nchw,co->nohw",
                                     a[:, c0:c0 + 16, ky:ky + height, kx:kx + width],
                                     wm[tap, c0:c0 + 16])
    y = torch.tanh(acc[:, :co] + bias.float()[None, :, None, None])
    total = torch.zeros(n, co, height // pool, width // pool)
    for i in range(pool):
        for j in range(pool):
            total = total + y[:, :, i::pool, j::pool]
    return (total * (1.0 / (pool * pool))).to(torch.bfloat16)


def _k3_case(seed, shape, co):
    rs = np.random.RandomState(seed)
    c = shape[1]
    h = torch.from_numpy((rs.randn(*shape) * 2).astype(np.float32)).to(torch.bfloat16)
    s = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rs.randn(co, c, 3, 3) / (3 * c ** 0.5)).astype(np.float32))
    b = torch.from_numpy((rs.randn(co) * 0.1).astype(np.float32))
    return h, s, w, b


@pytest.mark.parametrize("act", ["LeakyReLU", "ReLU"])
@pytest.mark.parametrize("shape,co,pool", [
    ((2, 32, 32, 64), 3, 4),   # the flagship head, cut in batch and size
    ((2, 20, 24, 72), 3, 2), ((1, 37, 16, 64), 4, 1), ((1, 5, 64, 64), 1, 32),
    ((1, 7, 8, 8), 2, 8),
])
def test_k3_mma_schedule_meets_bf16_gate(shape, co, pool, act):
    h, s, w, b = _k3_case(5, shape, co)
    assert oh.output_head_route(shape, torch.bfloat16, pool) == "mma_sync"
    used = _within(_k3_mma(h, s, w, b, act, pool), oh.output_head_plain(h, s, w, b, act, pool),
                   torch.bfloat16)
    assert used <= 1.0, used


def test_k3_zero_halo_misses_the_gate_at_the_border():
    """The negative control: a zero halo in place of the reflection leaves
    the bf16 gate, and only on the image's border pixels."""
    h, s, w, b = _k3_case(6, (1, 16, 24, 32), 3)
    want = oh.output_head_plain(h, s, w, b, "LeakyReLU", 1).float()
    atol, rtol = K2_TOL[torch.bfloat16]
    out = (_k3_mma(h, s, w, b, "LeakyReLU", 1, halo="zeros").float() - want).abs() > \
        atol + rtol * want.abs()
    border = torch.ones(24, 32, dtype=torch.bool)
    border[1:-1, 1:-1] = False
    assert bool(out.any()) and not bool((out & ~border).any())
    assert _within(_k3_mma(h, s, w, b, "LeakyReLU", 1), want, torch.bfloat16) <= 1.0


def test_k3_routes():
    """bf16 with W % 8 == 0, aligned maps and f a power of two up to 32 takes
    the tensor cores; float32, ragged W, misaligned maps, f = 3 and f = 64
    keep the CUDA-core kernel."""
    route, bf = oh.output_head_route, torch.bfloat16
    assert route((16, 32, 1024, 1024), bf, 4) == "mma_sync"
    assert all(route((1, 3, 64, 64), bf, f) == "mma_sync" for f in (1, 2, 4, 8, 16, 32))
    assert route((16, 32, 1024, 1024), torch.float32, 4) == "cuda_cores"
    assert route((2, 5, 36, 44), bf, 2) == route((1, 3, 48, 48), bf, 3) == "cuda_cores"
    assert route((1, 3, 128, 192), bf, 64) == "cuda_cores"
    assert route((1, 3, 16, 64), bf, 1, aligned=False) == "cuda_cores"
