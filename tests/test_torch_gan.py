"""The Stack A training slice against the JAX package on the CPU: the
discriminators and VGG16Features through convert.py, the GAN and VGG losses,
and one full two-optimizer GAN step from identical weights, batch and
sampling noise (losses, G and D gradients, updated parameters, spectral-norm
u vectors), once as the model runs at these sizes and once with the port's
decoder attention forced onto the streaming path (the K1/K5 autograd Function
with its plain versions) while JAX materializes the map. Last, training mode
takes neither the K3 pair nor the fused decoder tail.

JAX weights are seeded random values in the shapes of ``init``; AutoAttention
gammas are random, so the attention terms reach the outputs and gradients.
The JAX step's noise: its ``sample_z`` is wrapped to hand out the key it
draws from (``jax.debug.callback``), from which the same normals are drawn
on the JAX side and passed to the port. Everything runs in float32; the
tolerances are stated per test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.losses import gan as jgan
from face_mask_inpaint_tpu.losses import vgg as jvgg
from face_mask_inpaint_tpu.models import picnet as jp
from face_mask_inpaint_tpu.models import reference_fill as jrf
from face_mask_inpaint_tpu.train.gan import make_gan_train_step as j_make_step
from face_mask_inpaint_tpu.train.optim import adam as j_adam
from face_mask_inpaint_tpu.train.state import GANTrainState, ModuleState
from face_mask_inpaint_tpu_torch.convert import (
    convert_discriminator, convert_reference_fill, convert_vgg16, state_dict_from_jax,
    vgg16_state_dict_from_torchvision)
from face_mask_inpaint_tpu_torch.kernels import decoder_conv as dc
from face_mask_inpaint_tpu_torch.kernels import flash_attention as fa
from face_mask_inpaint_tpu_torch.kernels import output_head as oh
from face_mask_inpaint_tpu_torch.losses import gan as tgan
from face_mask_inpaint_tpu_torch.losses import vgg as tvgg
from face_mask_inpaint_tpu_torch.models import picnet as tp
from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
from face_mask_inpaint_tpu_torch.nn.layers import init_weights
from face_mask_inpaint_tpu_torch.train.gan import make_gan_train_step
from face_mask_inpaint_tpu_torch.train.optim import adam

KEY = jax.random.PRNGKey(0)
# the widths of tests/test_train_steps.py
ENC = dict(type="pluralistic", ngf=4, z_nc=8, img_f=16, L=1, layers=3,
           norm="none", activation="LeakyReLU", init_type="normal")
DEC = dict(ngf=8, z_nc=8, img_f=32, L=0, layers=3, norm="instance",
           activation="LeakyReLU", init_type="normal")
DISC = dict(ndf=4, img_f=16, layers=3, init_type="normal")
LR = 1e-4
HW = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_variables(init, seed):
    """Variables shaped by ``jax.eval_shape(init)``, filled from a seeded
    numpy RandomState: kernels ~ N(0, 1/fan_in), norm scales near 1,
    gammas random, unit spectral vectors."""
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


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _batch(n=2, hw=HW, seed=0):
    rs = np.random.RandomState(seed)
    mask = np.zeros((n, hw, hw), np.float32)
    mask[:, hw // 2:hw // 2 + 11, hw // 4:3 * hw // 4] = 1.0
    return {"src_img": rs.rand(n, hw, hw, 3).astype(np.float32),
            "gt_img": rs.rand(n, hw, hw, 3).astype(np.float32),
            "ref_img": rs.rand(n, hw, hw, 3).astype(np.float32), "mask": mask}


# ---------------------------------------------------------------- models


@pytest.mark.parametrize("model_type,layers", [("ResDis", 4), ("PatchDis", 3)])
def test_discriminator_matches_jax(model_type, layers):
    """ResDiscriminator at 64^2 with four layers (its AutoAttention at i == 2
    on 8^2 tokens, gamma random) and PatchDiscriminator, through
    convert_discriminator; eval mode. f32 max-abs 1e-5 of an O(1) output."""
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    kw = dict(ndf=4, img_f=16, layers=layers, model_type=model_type, init_type="normal")
    jd = jp.define_d(**kw)
    variables = random_variables(lambda: jd.init(KEY, jnp.asarray(x), train=False), 2)
    want = np.asarray(jax.jit(lambda v, a: jd.apply(v, a, train=False))(variables, x))
    td = tp.define_d(input_nc=3, **kw)
    td.load_state_dict(convert_discriminator(td, variables), strict=True)
    td.eval()
    with torch.no_grad():
        got = _nhwc(td(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_vgg16_features_matches_jax():
    """The four taps of random-weight VGG16Features at 32^2, through
    convert_vgg16. f32 max-abs 1e-4 relative to each tap's largest value."""
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    params = random_variables(lambda: jvgg.VGG16Features().init(KEY, jnp.asarray(x)), 3)
    want = jax.jit(jvgg.VGG16Features().apply)(params, jnp.asarray(x))
    vgg = tvgg.VGG16Features()
    vgg.load_state_dict(convert_vgg16(vgg, params["params"]), strict=True)
    assert not any(p.requires_grad for p in vgg.parameters())
    with torch.no_grad():
        got = vgg(_nchw(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(_nhwc(g), w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_vgg16_features_matches_torchvision_fixture():
    """tests/fixtures/parity/vgg_block1.npz: torchvision's features[0:4]
    (conv1_1, conv1_2 and their ReLUs) on a 32^2 input. The fixture's two
    convs plus seeded tensors for the other eight make a torchvision
    state_dict, which vgg16_state_dict_from_torchvision maps; the first tap
    matches the fixture to max-abs 2e-4, the parity report's tolerance."""
    fx = np.load("tests/fixtures/parity/vgg_block1.npz")
    sd = {k[3:]: torch.from_numpy(fx[k]) for k in fx.files if k.startswith("sd:")}
    gen = torch.Generator().manual_seed(0)
    cin = 64
    for idx, cout in ((5, 128), (7, 128), (10, 256), (12, 256), (14, 256),
                      (17, 512), (19, 512), (21, 512)):
        sd[f"features.{idx}.weight"] = torch.randn(cout, cin, 3, 3, generator=gen) * 0.01
        sd[f"features.{idx}.bias"] = torch.zeros(cout)
        cin = cout
    sd["classifier.0.weight"] = torch.zeros(1)  # ignored: not in features[:23]
    vgg = tvgg.VGG16Features()
    vgg.load_state_dict(vgg16_state_dict_from_torchvision(sd), strict=True)
    with torch.no_grad():
        got = vgg(torch.from_numpy(fx["in:x"]))[0].numpy()
    np.testing.assert_allclose(got, fx["out:y"], rtol=0, atol=2e-4)


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("gan_mode", ["lsgan", "vanilla", "hinge", "wgangp"])
def test_gan_loss_matches_jax(gan_mode):
    """All (target, is_disc) cases; f32 rtol 1e-6."""
    pred = np.random.RandomState(4).randn(2, 5, 5, 1).astype(np.float32) * 2
    for target in (True, False):
        for is_disc in (True, False):
            want = float(jgan.gan_loss(jnp.asarray(pred), target, is_disc, gan_mode))
            got = float(tgan.gan_loss(_nchw(pred), target, is_disc, gan_mode))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_style_and_contextual_losses_match_jax():
    """Gram-matrix style loss and the contextual loss (including a feature
    vector of zeros, which the 1e-12 norm floor keeps finite) on NHWC
    features given to JAX, NCHW to the port; f32 rtol 1e-5."""
    rs = np.random.RandomState(5)
    x = np.maximum(rs.randn(2, 6, 5, 16), 0).astype(np.float32)
    y = np.maximum(rs.randn(2, 6, 5, 16), 0).astype(np.float32)
    x[0, 0, 0] = 0.0
    want = float(jvgg.style_loss_gram(jnp.asarray(x), jnp.asarray(y)))
    got = float(tvgg.style_loss_gram(_nchw(x), _nchw(y)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want = float(jvgg.contextual_loss(jnp.asarray(x), jnp.asarray(y)))
    got = float(tvgg.contextual_loss(_nchw(x), _nchw(y)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("loss_type", ["perceptual", "style", "contextual"])
def test_vgg_loss_matches_jax(loss_type):
    """vgg_loss on NHWC images (random VGG weights, 32^2); f32 rtol 1e-4."""
    rs = np.random.RandomState(6)
    a, b = (rs.rand(2, 32, 32, 3).astype(np.float32) for _ in range(2))
    params = random_variables(lambda: jvgg.VGG16Features().init(KEY, jnp.asarray(a)), 3)
    want = float(jax.jit(lambda p, u, w: jvgg.vgg_loss(p, u, w, loss_type))(
        params["params"], a, b))
    vgg = tvgg.VGG16Features()
    vgg.load_state_dict(convert_vgg16(vgg, params["params"]), strict=True)
    got = float(tvgg.vgg_loss(vgg, torch.from_numpy(a), torch.from_numpy(b), loss_type))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---------------------------------------------------------------- one GAN step


@pytest.fixture(scope="module")
def jax_step():
    """One JAX GAN step (return_grads) from seeded weights, with the key its
    sample_z drew from; returns numpy results and the starting variables."""
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    gen = jrf.ReferenceFill(encoder_params=ENC, decoder_params=DEC, use_att=True,
                            out_size=(HW, HW))
    disc = jp.define_d(**DISC)
    g_vars = random_variables(lambda: gen.init({"params": KEY, "sample": KEY},
                                               jbatch["src_img"], jbatch["ref_img"],
                                               jbatch["mask"]), 10)
    d_vars = random_variables(lambda: disc.init(KEY, jbatch["gt_img"]), 11)
    vgg = random_variables(lambda: jvgg.VGG16Features().init(KEY, jbatch["gt_img"]), 12)
    g_tx, d_tx = j_adam(LR), j_adam(LR)
    gs, ds = ModuleState.from_variables(g_vars), ModuleState.from_variables(d_vars)
    state = GANTrainState(step=jnp.zeros([], jnp.int32), generator=gs, discriminator=ds,
                          g_opt_state=g_tx.init(gs.params), d_opt_state=d_tx.init(ds.params),
                          rng=jax.random.PRNGKey(7))
    drawn = []
    original = jrf.sample_z

    def recording_sample_z(src_dist, ref_dist, rng, return_zq=False):
        jax.debug.callback(lambda r, shape=src_dist[0].shape: drawn.append((np.asarray(r),
                                                                            shape)), rng)
        return original(src_dist, ref_dist, rng, return_zq)

    mp = pytest.MonkeyPatch()
    mp.setattr(jrf, "sample_z", recording_sample_z)
    try:
        step = jax.jit(j_make_step(gen, disc, g_tx, d_tx, vgg["params"], return_grads=True))
        new_state, metrics = step(state, jbatch)
        jax.block_until_ready(metrics)
    finally:
        mp.undo()
    (rng, shape), = drawn
    rng_q, rng_p = jax.random.split(jnp.asarray(rng))
    eps = (np.asarray(jax.random.normal(rng_q, shape)), np.asarray(jax.random.normal(rng_p, shape)))
    return dict(batch=batch, g_vars=g_vars, d_vars=d_vars, vgg=vgg["params"], eps=eps,
                metrics={k: float(v) for k, v in metrics.items() if k not in ("g_grads",
                                                                              "d_grads")},
                g_grads=metrics["g_grads"], d_grads=metrics["d_grads"],
                g_new=new_state.generator, d_new=new_state.discriminator)


@pytest.fixture(scope="module", params=["materialized", "streaming"])
def port_step(request, jax_step):
    """The port's step from the same weights, batch and noise. 'streaming'
    lowers the decoder attention's block_threshold under its 32^2 = 1,024
    tokens, so it runs the K1/K5 autograd Function (plain versions here)."""
    j = jax_step
    gen = ReferenceFill(ENC, DEC, use_att=True, out_size=(HW, HW))
    gen.load_state_dict(convert_reference_fill(gen, j["g_vars"]), strict=True)
    disc = tp.define_d(input_nc=3, **DISC)
    disc.load_state_dict(convert_discriminator(disc, j["d_vars"]), strict=True)
    vgg = tvgg.VGG16Features()
    vgg.load_state_dict(convert_vgg16(vgg, j["vgg"]), strict=True)
    if request.param == "streaming":
        gen.decoder.attn1.block_threshold = 512
    step = make_gan_train_step(gen, disc, vgg, adam(gen.parameters(), LR),
                               adam(disc.parameters(), LR))
    calls = {"fwd": 0, "bwd": 0}

    def counted(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(fa, "flash_attention_plain", counted(fa.flash_attention_plain, "fwd"))
    mp.setattr(fa, "flash_attention_bwd_plain", counted(fa.flash_attention_bwd_plain, "bwd"))
    try:
        metrics = step({k: torch.from_numpy(v) for k, v in j["batch"].items()},
                       eps_q=torch.tensor(j["eps"][0]), eps_p=torch.tensor(j["eps"][1]),
                       return_grads=True)
    finally:
        mp.undo()
    return dict(mode=request.param, gen=gen, disc=disc, metrics=metrics, calls=calls)


def test_gan_step_path(port_step):
    """The streaming case ran the Function's plain forward and backward once
    each; the materialized case neither."""
    want = (1, 1) if port_step["mode"] == "streaming" else (0, 0)
    assert (port_step["calls"]["fwd"], port_step["calls"]["bwd"]) == want


def test_gan_step_losses_match_jax(jax_step, port_step):
    """Every loss in the metrics; f32 rtol 1e-4 (the adversarial and VGG
    terms pass several spectral-norm and instance-norm divisions)."""
    got = port_step["metrics"]
    for k, want in jax_step["metrics"].items():
        np.testing.assert_allclose(float(got[k]), want, rtol=1e-4, atol=1e-9, err_msg=k)


def _port_names(model, tree, collection="params"):
    return {k: v.numpy() for k, v in state_dict_from_jax(model, {collection: tree}).items()}


@pytest.mark.parametrize("net", ["G", "D"])
def test_gan_step_grads_match_jax(jax_step, port_step, net):
    """Every G and D gradient tensor: max-abs error <= 2e-3 of that tensor's
    largest entry + 1e-5 of the network's largest gradient entry (f32;
    gradients through VGG, contextual and spectral norms, summed in another
    order; the floor covers tensors whose gradient is zero up to rounding,
    such as a conv bias ahead of an instance norm)."""
    model = port_step["gen"] if net == "G" else port_step["disc"]
    want = _port_names(model, jax_step["g_grads" if net == "G" else "d_grads"])
    got = port_step["metrics"]["g_grads" if net == "G" else "d_grads"]
    assert set(got) == set(want)
    floor = 1e-5 * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        g = got[k].numpy()
        assert np.abs(g - w).max() <= 2e-3 * np.abs(w).max() + floor, k


@pytest.mark.parametrize("net", ["G", "D"])
def test_gan_step_params_and_spectral_match_jax(jax_step, port_step, net):
    """Updated parameters and spectral u/v after the step. Adam's first step
    moves each parameter by lr * g / (|g| + eps), about +-lr for any
    gradient well above eps = 1e-8: the two sides agree to 1e-2 lr there;
    where |g| < 1e-6 (of either sign, within the gradient tolerance) the move
    can be anything in [-lr, lr], so only 2 lr holds. Spectral vectors:
    f32 max-abs 1e-5 (unit vectors after one power iteration)."""
    model = port_step["gen"] if net == "G" else port_step["disc"]
    new = jax_step["g_new" if net == "G" else "d_new"]
    grads = _port_names(model, jax_step["g_grads" if net == "G" else "d_grads"])
    want = _port_names(model, new.params)
    sd = model.state_dict()
    for k, w in want.items():
        diff = np.abs(sd[k].numpy() - w)
        settled = np.abs(grads[k]) > 1e-6
        assert diff[settled].max(initial=0) <= 1e-2 * LR, k
        assert diff.max() <= 2 * LR, k
    spectral = _port_names(model, new.spectral, "spectral")
    assert spectral
    for k, w in spectral.items():
        np.testing.assert_allclose(sd[k].numpy(), w, rtol=0, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------- gating


def test_training_mode_takes_no_fused_path(monkeypatch):
    """ResGenerator with packed_convt (pack_threshold 8, so every block may
    pack) and a fused pool: eval mode runs the K4 tail and, without
    packed_convt, the K3 pair; training mode runs neither, and its
    gradients reach the decoder convs."""
    calls = {"head": 0, "conv": 0, "convt": 0}

    def counted(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(oh, "output_head", counted(oh.output_head, "head"))
    monkeypatch.setattr(dc, "conv3x3_stats", counted(dc.conv3x3_stats, "conv"))
    monkeypatch.setattr(dc, "convt_pair", counted(dc.convt_pair, "convt"))
    rs = np.random.RandomState(8)
    encoded = torch.from_numpy(rs.randn(2, 32, 4, 4).astype(np.float32))
    z = torch.from_numpy(rs.randn(2, 16, 4, 4).astype(np.float32))
    g = init_weights(tp.define_g(**DEC, input_nc=32, z_channels=16, pack_threshold=8),
                     torch.Generator().manual_seed(0))

    def run(train, packed):
        g.train(train)
        g.packed_convt = packed
        for k in calls:
            calls[k] = 0
        return g(encoded, z=z, fuse_pool=2), dict(calls)

    with torch.no_grad():
        _, eval_packed = run(False, True)
        _, eval_pair = run(False, False)
    assert eval_packed["conv"] > 0 and eval_packed["convt"] > 0
    assert eval_pair["head"] == 1
    for packed in (True, False):
        out, train_calls = run(True, packed)
        assert train_calls == {"head": 0, "conv": 0, "convt": 0}
        assert out.shape == (2, 3, 32, 32)  # the head at full size, no pool
        out.float().square().mean().backward()
        assert g.decoder2.conv2.weight.grad.abs().max() > 0
        g.zero_grad()
