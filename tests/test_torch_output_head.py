"""K3's plain version and the pair path of the port's Output head,
ResGenerator and ReferenceFill against the JAX package's pair path.

The JAX side runs with ``FMI_OUTPUT_KERNEL=1``: the decoder hands its
(h, bypass) pair to ``Output``, which runs ``packed_output_head`` (Pallas, in
interpret mode on the CPU) and rebuilds the reflection ring. The port's
inputs are the JAX pair unpacked with JAX's ``depth_to_space`` and moved to
NCHW. Weights are seeded random values in the shapes of ``init``, carried
across with convert.py. float32 unless stated; tolerances per test.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.models import picnet as jp
from face_mask_inpaint_tpu.models.reference_fill import ReferenceFill as JReferenceFill
from face_mask_inpaint_tpu.nn.blocks import Output as JOutput
from face_mask_inpaint_tpu.ops import packed as jpacked
from face_mask_inpaint_tpu.ops.pallas import norm_act as jna
from face_mask_inpaint_tpu.ops.pallas import packed_convt as jpc
from face_mask_inpaint_tpu_torch.convert import convert_reference_fill, state_dict_from_jax
from face_mask_inpaint_tpu_torch.kernels import output_head as oh
from face_mask_inpaint_tpu_torch.models import picnet as tp
from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
from face_mask_inpaint_tpu_torch.nn.blocks import Output
from face_mask_inpaint_tpu_torch.nn.layers import init_weights
from face_mask_inpaint_tpu_torch.ops.resize import adaptive_avg_pool2d

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several pytest workers on a few cores: one intra-op
    thread each keeps torch from oversubscribing them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def head_calls(monkeypatch):
    """Counts the JAX packed_output_head calls and the port's output_head
    calls, so that each test shows the pair path ran on both sides."""
    calls = {"jax": 0, "port": 0}
    jax_head, port_head = jpc.packed_output_head, oh.output_head

    def counted_jax(*a, **k):
        calls["jax"] += 1
        return jax_head(*a, **k)

    def counted_port(*a, **k):
        calls["port"] += 1
        return port_head(*a, **k)

    monkeypatch.setattr(jpc, "packed_output_head", counted_jax)
    monkeypatch.setattr(oh, "output_head", counted_port)
    monkeypatch.setenv("FMI_OUTPUT_KERNEL", "1")
    return calls


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def jitted_apply(module, **kw):
    """``module.apply`` with the keywords kw, under ``jax.jit``: one XLA
    program for the whole module in place of one per operation (most of an
    eager apply's time on the CPU). Traced anew at each call of this helper,
    so the FMI_* settings in force are the ones the trace reads."""
    return jax.jit(functools.partial(module.apply, **kw))


def random_variables(init, seed):
    """Variables shaped by ``jax.eval_shape(init)`` from a seeded numpy
    RandomState: kernels ~ N(0, 1/fan_in), norm scales near 1, small random
    biases, AutoAttention's gamma random, unit spectral vectors."""
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        x = rs.randn(*shape).astype(np.float32)
        if name == "kernel":
            x /= np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * x
        elif name == "bias":
            x *= 0.1
        elif name in ("u", "v"):
            x /= np.linalg.norm(x)
        return jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init))


@pytest.mark.parametrize("act", ["LeakyReLU", "ReLU"])
@pytest.mark.parametrize("f", [2, 4])
def test_plain_head_matches_jax_pair_head(head_calls, monkeypatch, f, act):
    """f x f pool with the pair packed at r = f on the JAX side. Max-abs
    2e-5, the JAX test's own tolerance (tests/test_packed_ops.py)."""
    rs = np.random.RandomState(10 * f + len(act))
    c = 6
    h = jnp.asarray(rs.randn(2, 8, 8, f * f * c), jnp.float32)
    s = jnp.asarray(rs.randn(2, 8, 8, f * f * c), jnp.float32)
    jmod = JOutput(output_nc=3, kernel_size=3, norm="none", activation=act, use_spect=True)
    kw = dict(train=False, pack_in=f, fuse_pool=True)
    variables = random_variables(lambda: jmod.init(KEY, (h, s), **kw), f)
    head_calls["jax"] = 0  # tracing init ran the head too
    want_kernel = np.asarray(jitted_apply(jmod, **kw)(variables, (h, s)))
    assert head_calls["jax"] == 1
    monkeypatch.setenv("FMI_OUTPUT_KERNEL", "0")
    want_dense = np.asarray(jitted_apply(jmod, **kw)(variables, (h, s)))

    port = Output(c, 3, 3, norm="none", activation=act, use_spect=True)
    port.load_state_dict(state_dict_from_jax(port, variables), strict=True)
    port.eval()
    th, ts = _nchw(jpacked.depth_to_space(h, f)), _nchw(jpacked.depth_to_space(s, f))
    conv = port.conv1.conv
    with torch.no_grad():
        got = oh.output_head_plain(th, ts, conv.effective_weight(), conv.bias, act, f)
        via_module = port((th, ts, None), pool=f)  # the decoder's triple, no pair bias
    assert got.shape == (2, 3, 8, 8)
    np.testing.assert_allclose(_nhwc(got), want_kernel, rtol=0, atol=2e-5)
    np.testing.assert_allclose(_nhwc(got), want_dense, rtol=0, atol=2e-5)
    assert head_calls["port"] == 1 and torch.equal(via_module, got)


# float32: the same math up to the pool, whose sums may run in another
# order. bfloat16: the dense head rounds its conv output, tanh and pooled
# mean to bf16, the fused head rounds once at the end; for results in
# [-1, 1] the two stay within one bf16 ulp at 1 (2^-7).
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-6), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("act", ["LeakyReLU", "ReLU"])
def test_plain_head_matches_dense_head_and_pool(dtype, atol, f, act):
    rs = np.random.RandomState(f)
    shape = (2, 5, 36, 44)
    h = torch.from_numpy(rs.randn(*shape).astype(np.float32) * 2).to(dtype)
    s = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)
    head = init_weights(Output(5, 3, 3, norm="none", activation=act, use_spect=True),
                        torch.Generator().manual_seed(f)).eval()
    with torch.no_grad():
        head.conv1.conv.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
        dense = adaptive_avg_pool2d(head(h + s), (36 // f, 44 // f))
        conv = head.conv1.conv
        got = oh.output_head(h, s, conv.effective_weight(), conv.bias, act, f)
    assert got.dtype == dtype and got.shape == (2, 3, 36 // f, 44 // f)
    np.testing.assert_allclose(got.float().numpy(), dense.float().numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("shape,act,pool,match", [
    ((1, 4, 16, 16), "LeakyReLU", 3, "does not divide"),
    ((1, 4, 16, 12), "ReLU", 8, "does not divide"),
    ((1, 4, 1, 16), "ReLU", 1, "H, W >= 2"),
    ((1, 4, 16, 16), "SELU", 2, "activation"),
])
def test_head_rejects_what_the_kernel_cannot_take(shape, act, pool, match):
    h = torch.zeros(shape)
    w, b = torch.zeros(3, shape[1], 3, 3), torch.zeros(3)
    with pytest.raises((ValueError, NotImplementedError), match=match):
        oh.output_head(h, h, w, b, act, pool)


def test_head_rejects_mixed_dtypes_and_wide_outputs():
    h = torch.zeros(1, 4, 8, 8)
    with pytest.raises(TypeError):
        oh.output_head(h, h.to(torch.bfloat16), torch.zeros(3, 4, 3, 3), torch.zeros(3), "ReLU", 2)
    with pytest.raises(ValueError, match="output channels"):
        oh.output_head(h, h, torch.zeros(5, 4, 3, 3), torch.zeros(5), "ReLU", 2)


GEN = dict(ngf=8, z_nc=8, img_f=32, L=0, layers=3, norm="instance",
           activation="LeakyReLU", init_type="normal")


# (use_attn, pack_threshold, fuse_pool): the JAX pair needs the last block
# packed at r = fuse_pool / 2. With attention at i == 1 the map is unpacked
# there, so the last block packs at r = 1 (pool 2); without it, threshold 8
# packs from the second block on (pool 4).
@pytest.mark.parametrize("use_attn,threshold,pool", [(True, 4, 2), (False, 8, 4)])
def test_res_generator_pair_head_matches_jax(head_calls, use_attn, threshold, pool):
    """z injected; max-abs 1e-4 (three decoder stages of instance norms)."""
    rs = np.random.RandomState(5)
    x = rs.randn(2, 4, 4, 32).astype(np.float32)
    z = rs.randn(2, 4, 4, 16).astype(np.float32)
    jgen = jp.define_g(**GEN, use_attn=use_attn, pack_threshold=threshold)
    kw = dict(train=False, fuse_pool=pool)
    variables = random_variables(
        lambda: jgen.init(KEY, jnp.asarray(x), z=jnp.asarray(z), **kw), 8)
    head_calls["jax"] = 0  # tracing init ran the head too
    want = np.asarray(jitted_apply(jgen, **kw)(variables, jnp.asarray(x), z=jnp.asarray(z)))
    assert head_calls["jax"] == 1

    tgen = tp.define_g(**GEN, use_attn=use_attn, input_nc=32, z_channels=16)
    tgen.load_state_dict(state_dict_from_jax(tgen, variables), strict=True)
    tgen.eval()
    with torch.no_grad():
        got = tgen(_nchw(x), z=_nchw(z), fuse_pool=pool)
    assert head_calls["port"] == 1
    assert got.shape == (2, 3, 32 // pool, 32 // pool)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-4)


def test_reference_fill_pair_head_matches_jax(head_calls, monkeypatch):
    """The slice as a whole, with the JAX decoder packing its last block
    (pack_threshold 16 at a 64^2 decode) so that the pair path engages at
    pool 2 (64^2 -> 32^2), norm_act on 'pallas', eps injected. Max-abs 1e-4."""
    monkeypatch.setattr(jna, "_IMPL", "pallas")
    enc = dict(type="pluralistic", ngf=8, z_nc=16, img_f=32, L=1, layers=3,
               norm="none", activation="LeakyReLU", init_type="orthogonal")
    dec = dict(ngf=16, z_nc=16, img_f=64, L=0, layers=3, norm="instance",
               activation="LeakyReLU", init_type="orthogonal", pack_threshold=16)
    rs = np.random.RandomState(3)
    src = rs.rand(2, 32, 32, 3).astype(np.float32)
    ref = rs.rand(2, 32, 32, 3).astype(np.float32)
    mask = np.zeros((2, 32, 32), np.float32)
    mask[:, 16:27, 8:24] = 1.0
    jmodel = JReferenceFill(encoder_params=enc, decoder_params=dec, use_att=True,
                            out_size=(32, 32))
    args = (jnp.asarray(src), jnp.asarray(ref), jnp.asarray(mask))
    variables = random_variables(
        lambda: jmodel.init({"params": KEY, "sample": KEY}, *args, train=False), 7)
    head_calls["jax"] = 0  # tracing init ran the head too
    rng = jax.random.PRNGKey(1)
    want = np.asarray(jitted_apply(jmodel, train=False)(variables, *args, rng=rng))
    assert head_calls["jax"] == 1
    rng_q, rng_p = jax.random.split(rng)
    eps_q = np.array(jax.random.normal(rng_q, (2, 8, 8, 16)))
    eps_p = np.array(jax.random.normal(rng_p, (2, 8, 8, 16)))

    model = ReferenceFill(enc, dec, use_att=True, out_size=(32, 32))
    model.load_state_dict(convert_reference_fill(model, variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(src), torch.from_numpy(ref), torch.from_numpy(mask),
                    eps_q=torch.from_numpy(eps_q), eps_p=torch.from_numpy(eps_p))
    assert head_calls["port"] == 1
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
