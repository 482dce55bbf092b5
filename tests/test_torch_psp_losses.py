"""The pSp trainer's layers and losses against the JAX package on the same
weights and inputs: training-mode BatchNorm2d (flax semantics: batch mean,
biased variance, momentum 0.1 on the running statistics) over two calls;
LPIPSNet with each trunk (alex, vgg, squeeze), its value and its gradient
with respect to the image, and the lin stage against the recorded
reference-torch fixture (tests/fixtures/parity/lpips_lin.npz); the ArcFace
Backbone and the identity loss (IR-SE num_layers=4, the JAX side's
``make_backbone`` patched to the same); the W-norm; and ``psp_loss`` with
each lambda on and off, the style and contextual terms computed, logged and
not added, and its gradient with respect to y_hat.

JAX variables are shaped by ``jax.eval_shape(init)`` and filled from a
seeded numpy Generator; images come from seeded numpy. Everything is f32.
Tolerances: max |port - JAX| <= 1e-5 * max |JAX| for BatchNorm and the
W-norm (one pass of f32 sums), <= 1e-4 * max |JAX| for the conv stacks and
the losses and their gradients (f32 sums through many layers in another
order); the identity loss's gradient in float64 on both sides within 1e-9
(see test_id_loss_matches_jax); the lin fixture within 1e-5 absolute, as
tests/test_parity_report.py holds the JAX side.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.losses import id_loss as jid
from face_mask_inpaint_tpu.losses import lpips as jlp
from face_mask_inpaint_tpu.losses.psp_loss import PSPLossConfig as JPSPLossConfig
from face_mask_inpaint_tpu.losses.psp_loss import psp_loss as jpsp_loss
from face_mask_inpaint_tpu.losses.vgg import VGG16Features as JVGG16Features
from face_mask_inpaint_tpu.losses.w_norm import w_norm_loss as jw_norm_loss
from face_mask_inpaint_tpu.models.irse import Backbone as JBackbone
from face_mask_inpaint_tpu.nn import layers as jl
from face_mask_inpaint_tpu.tools.parity_report import DEFAULT_FIXTURE_DIR, _load_fixture
from face_mask_inpaint_tpu_torch.convert import (
    convert_backbone, convert_lpips, convert_vgg16, state_dict_from_jax)
from face_mask_inpaint_tpu_torch.losses.id_loss import id_loss
from face_mask_inpaint_tpu_torch.losses.lpips import LPIPSNet
from face_mask_inpaint_tpu_torch.losses.psp_loss import PSPLossConfig, psp_loss
from face_mask_inpaint_tpu_torch.losses.vgg import VGG16Features
from face_mask_inpaint_tpu_torch.losses.w_norm import w_norm_loss
from face_mask_inpaint_tpu_torch.models.irse import Backbone
from face_mask_inpaint_tpu_torch.nn.layers import BatchNorm2d, PReLU

from tests.test_torch_stylegan2 import _assert_rel, _nchw, _nhwc, random_variables

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed, n=2, hw=64):
    return np.random.RandomState(seed).uniform(-1, 1, (n, hw, hw, 3)).astype(np.float32)


def test_batch_norm_training_matches_flax_over_two_calls():
    """Output of each call and the running statistics after two, the
    second call on another batch: batch mean, biased variance, running
    stats moved 0.1 of the way with the biased variance."""
    rs = np.random.RandomState(11)
    xs = [(rs.randn(4, 5, 6, 7) * 3 + 1).astype(np.float32) for _ in range(2)]
    jmod = jl.BatchNorm2d(use_running_average=False)
    variables = random_variables(lambda: jmod.init(KEY, jnp.asarray(xs[0])), 12)
    tmod = BatchNorm2d(7)
    tmod.load_state_dict(state_dict_from_jax(tmod, variables), strict=True)
    tmod.train()
    apply = jax.jit(lambda v, x: jmod.apply(v, x, mutable=["batch_stats"]))
    for x in xs:
        want, mut = apply(variables, jnp.asarray(x))
        variables = {**variables, **mut}
        with torch.no_grad():
            got = tmod(_nchw(x))
        _assert_rel(_nhwc(got), np.asarray(want), 1e-5)
    _assert_rel(tmod.running_mean.numpy(), np.asarray(variables["batch_stats"]["bn"]["mean"]),
                1e-5)
    _assert_rel(tmod.running_var.numpy(), np.asarray(variables["batch_stats"]["bn"]["var"]),
                1e-5)


def _lpips_pair(net_type, hw=64):
    x, y = _images(1, hw=hw), _images(2, hw=hw)
    jnet = jlp.LPIPSNet(net_type)
    params = random_variables(lambda: jnet.init(KEY, jnp.asarray(x), jnp.asarray(y)),
                              13)["params"]
    tnet = LPIPSNet(net_type)
    tnet.load_state_dict(convert_lpips(tnet, params), strict=True)
    return x, y, params, tnet


@pytest.mark.parametrize("net_type", ["alex", "vgg", "squeeze"])
def test_lpips_matches_jax(net_type):
    """The distance and its gradient with respect to the first image."""
    x, y, params, tnet = _lpips_pair(net_type)
    fn = jax.jit(jax.value_and_grad(lambda a, b: jlp.lpips(params, a, b, net_type)))
    want, want_dx = fn(jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_()
    got = tnet(tx, torch.from_numpy(y))
    (dx,) = torch.autograd.grad(got, tx)
    assert all(not p.requires_grad for p in tnet.parameters())
    _assert_rel(got.detach().numpy(), np.asarray(want), 1e-4)
    _assert_rel(dx.numpy(), np.asarray(want_dx), 1e-4)


def test_lpips_lin_stage_matches_reference_torch_fixture():
    """The lin stage over the recorded alex-width taps against the
    reference torch's distance (tests/fixtures/parity/lpips_lin.npz)."""
    sd, ins, outs = _load_fixture(f"{DEFAULT_FIXTURE_DIR}/lpips_lin.npz")
    tnet = LPIPSNet("alex")
    with torch.no_grad():
        for i in range(5):
            getattr(tnet, f"lin{i}").weight.copy_(torch.from_numpy(sd[f"lin.{i}.1.weight"]))
        got = tnet.distance([torch.from_numpy(ins[f"feat{i}_a"]) for i in range(5)],
                            [torch.from_numpy(ins[f"feat{i}_b"]) for i in range(5)])
    assert abs(float(got) - float(outs["distance"])) < 1e-5


@pytest.fixture(scope="module")
def backbone_variables():
    """JAX ArcFace Backbone(num_layers=4) variables, the BatchNorm1d's
    running statistics included."""
    x = _images(3, hw=112)
    variables = random_variables(lambda: JBackbone(num_layers=4).init(KEY, jnp.asarray(x),
                                                                      train=False), 14)
    stats = dict(variables["batch_stats"])  # the BatchNorm1d's variance > 0
    stats["out_bn1d_var"] = 0.5 + jnp.abs(stats["out_bn1d_var"])
    return {**variables, "batch_stats": stats}


def _backbone(variables) -> Backbone:
    tnet = Backbone(num_layers=4)
    tnet.load_state_dict(convert_backbone(tnet, variables), strict=True)
    return tnet


def test_backbone_matches_jax(backbone_variables):
    x = _images(4, hw=112)
    want = jax.jit(lambda v, a: JBackbone(num_layers=4).apply(v, a, train=False))(
        backbone_variables, jnp.asarray(x))
    tnet = _backbone(backbone_variables)
    with torch.no_grad():
        got = tnet(_nchw(x))
    _assert_rel(got.numpy(), np.asarray(want), 1e-4)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, rtol=1e-5)
    assert not tnet.training and all(not p.requires_grad for p in tnet.parameters())
    with pytest.raises(NotImplementedError):
        tnet.train()


@pytest.fixture
def small_jax_backbone(monkeypatch):
    """The JAX identity loss's facenet at num_layers=4."""
    monkeypatch.setattr(jid, "make_backbone", lambda: JBackbone(num_layers=4))


def _id_loss_jax(variables, y_hat, y, x):
    """The JAX identity loss and its gradient with respect to y_hat."""
    def f(yh, v, yy, xx):
        loss, imp, logs = jid.id_loss(v, yh, yy, xx)
        return loss, (imp, logs)

    return jax.jit(jax.value_and_grad(f, has_aux=True))(y_hat, variables, y, x)


def _id_loss_port(tnet, y_hat, y, x, dtype=torch.float32):
    ty = torch.from_numpy(y_hat).to(dtype).requires_grad_()
    loss, imp, logs = id_loss(tnet.to(dtype), ty, torch.from_numpy(y).to(dtype),
                              torch.from_numpy(x).to(dtype))
    (d,) = torch.autograd.grad(loss, ty)
    return loss.detach(), imp.detach(), {k: v.detach() for k, v in logs.items()}, d


def test_id_loss_matches_jax(backbone_variables, small_jax_backbone, monkeypatch):
    """Loss, similarity improvement and the per-sample logs on 256^2 images
    in f32 (1e-4), and the gradient with respect to y_hat (y's embedding
    detached) in float64 on both sides (1e-9 of the largest JAX entry; the
    JAX Backbone built with dtype float64 under ``jax.enable_x64``).

    An f32 gradient through a PReLU is not a function of the inputs where a
    pre-activation lies within f32 rounding of 0: the slope there is 1 on
    one side and the PReLU's alpha on the other, and the two packages sum
    their convolutions in different orders. On these inputs one such
    pre-activation decides the branch differently in the two f32 runs, and
    that one element moves the image gradient far more than 1e-4 of its
    largest entry. So the f32 gradient is held with every PReLU's branch
    taken from the float64 run: the port's f32 gradient within 1e-4 of its
    float64 one. The f32 image gradient through the identity loss is also
    held against JAX's in test_psp_loss_matches_jax (the recipe case)."""
    y_hat, y, x = _images(5, hw=256), _images(6, hw=256), _images(7, hw=256)
    (want, (want_imp, want_logs)), _ = _id_loss_jax(backbone_variables,
                                                    *map(jnp.asarray, (y_hat, y, x)))
    got, imp, logs, _ = _id_loss_port(_backbone(backbone_variables), y_hat, y, x)
    _assert_rel(got.numpy(), np.asarray(want), 1e-4)
    _assert_rel(imp.numpy(), np.asarray(want_imp), 1e-4)
    for k in ("diff_target", "diff_input", "diff_views"):
        _assert_rel(logs[k].numpy(), np.asarray(want_logs[k]), 1e-4)

    monkeypatch.setattr(jid, "make_backbone",
                        lambda: JBackbone(num_layers=4, dtype=jnp.float64))
    with jax.enable_x64():
        v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), backbone_variables)
        (want64, _), want_d64 = _id_loss_jax(
            v64, *(jnp.asarray(a.astype(np.float64)) for a in (y_hat, y, x)))
        want64, want_d64 = np.asarray(want64), np.asarray(want_d64)
    branches = []
    prelu = PReLU.forward

    def record(self, a):
        branches.append(a.detach() >= 0)
        return prelu(self, a)

    monkeypatch.setattr(PReLU, "forward", record)
    got64, _, _, d64 = _id_loss_port(_backbone(backbone_variables), y_hat, y, x, torch.float64)
    _assert_rel(got64.numpy(), want64, 1e-9)
    _assert_rel(d64.numpy(), want_d64, 1e-9)

    replay = iter(branches)

    def pinned(self, a):
        alpha = self.alpha.to(a.dtype).view(1, -1, *([1] * (a.dim() - 2)))
        return torch.where(next(replay), a, alpha * a)

    monkeypatch.setattr(PReLU, "forward", pinned)
    _, _, _, d32 = _id_loss_port(_backbone(backbone_variables), y_hat, y, x)
    assert next(replay, None) is None
    _assert_rel(d32.numpy(), d64.numpy(), 1e-4)


@pytest.mark.parametrize("from_avg", [True, False])
def test_w_norm_matches_jax(from_avg):
    rs = np.random.RandomState(8)
    latent = rs.randn(3, 10, 512).astype(np.float32)
    avg = rs.randn(10, 512).astype(np.float32)
    want, want_d = jax.value_and_grad(lambda a: jw_norm_loss(a, jnp.asarray(avg), from_avg))(
        jnp.asarray(latent))
    tl = torch.from_numpy(latent).requires_grad_()
    got = w_norm_loss(tl, torch.from_numpy(avg), from_avg)
    (d,) = torch.autograd.grad(got, tl)
    _assert_rel(got.detach().numpy(), np.asarray(want), 1e-5)
    _assert_rel(d.numpy(), np.asarray(want_d), 1e-5)


LOSS_CONFIGS = {
    # scripts/train_psp.sh, the chip recipe
    "recipe": dict(id_lambda=0.1, lpips_lambda=0.8, l2_lambda=2.0, style_lambda=1000.0,
                   cx_lambda=1.0, w_norm_lambda=0.0, start_from_latent_avg=True),
    # the CLI's defaults
    "defaults": dict(),
    # the reference-side terms and the W-norm, nothing else
    "ref terms": dict(lpips_lambda=0.0, l2_lambda=0.0, style_lambda=0.0, cx_lambda=0.0,
                      lpips_lambda_ref=0.5, l2_lambda_ref=0.7, w_norm_lambda=0.01,
                      start_from_latent_avg=False),
}


@pytest.fixture(scope="module")
def loss_nets(backbone_variables):
    """JAX and port sub-nets on the same weights: LPIPS(alex), the
    Backbone(num_layers=4), VGG16Features."""
    img = jnp.asarray(_images(9, hw=128))
    lp = random_variables(lambda: jlp.LPIPSNet("alex").init(KEY, img, img), 15)["params"]
    vgg = random_variables(lambda: JVGG16Features().init(KEY, img), 16)["params"]
    tlp = LPIPSNet("alex")
    tlp.load_state_dict(convert_lpips(tlp, lp), strict=True)
    tvgg = VGG16Features()
    tvgg.load_state_dict(convert_vgg16(tvgg, vgg), strict=True)
    return ({"lpips": lp, "facenet": backbone_variables, "vgg": vgg},
            {"lpips": tlp, "facenet": _backbone(backbone_variables), "vgg": tvgg})


@pytest.mark.parametrize("name,masked", [("recipe", True), ("ref terms", True),
                                         ("defaults", False)])
def test_psp_loss_matches_jax(loss_nets, small_jax_backbone, name, masked):
    """Every logged term, the total, and d loss / d y_hat, on 128^2 images
    (the identity crop [35:223, 32:220] takes what it finds); the style and
    contextual terms are logged and left out of the total. Without a mask
    (and a reference) the masked and reference-side terms are skipped."""
    kw = LOSS_CONFIGS[name]
    jnets, tnets = loss_nets
    x, y, y_hat, ref = (_images(s, hw=128) for s in (20, 21, 22, 23))
    mask = np.zeros((2, 128, 128), np.float32)
    mask[:, 40:100, 30:90] = 1.0
    rs = np.random.RandomState(24)
    latent = rs.randn(2, 10, 512).astype(np.float32)
    avg = rs.randn(10, 512).astype(np.float32)
    m, r = (mask, ref) if masked else (None, None)

    def f(yh, nets, x, y, latent, avg, r, m):
        loss, d, _ = jpsp_loss(JPSPLossConfig(**kw), nets, x=x, y=y, y_hat=yh, latent=latent,
                               latent_avg=avg, ref=r, mask=m)
        return loss, d

    (want, want_dict), want_d = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(y_hat), jnets, *(None if a is None else jnp.asarray(a)
                                     for a in (x, y, latent, avg, r, m)))
    ty = torch.from_numpy(y_hat).requires_grad_()
    got, got_dict, _ = psp_loss(PSPLossConfig(**kw), tnets, x=torch.from_numpy(x),
                                y=torch.from_numpy(y), y_hat=ty,
                                latent=torch.from_numpy(latent),
                                latent_avg=torch.from_numpy(avg),
                                ref=None if r is None else torch.from_numpy(r),
                                mask=None if m is None else torch.from_numpy(m))
    (d,) = torch.autograd.grad(got, ty)
    assert set(got_dict) == set(want_dict)
    for k, v in want_dict.items():
        _assert_rel(got_dict[k].detach().numpy(), np.asarray(v), 1e-4)
    _assert_rel(d.numpy(), np.asarray(want_d), 1e-4)
    cfg = PSPLossConfig(**kw)
    lambdas = {"loss_id": cfg.id_lambda, "loss_l2": cfg.l2_lambda,
               "loss_lpips": cfg.lpips_lambda, "loss_lpips_ref": cfg.lpips_lambda_ref,
               "loss_l2_ref": cfg.l2_lambda_ref, "loss_w_norm": cfg.w_norm_lambda}
    included = sum(float(got_dict[k]) * lam for k, lam in lambdas.items() if k in got_dict)
    assert float(got) == pytest.approx(included, rel=1e-6, abs=1e-7)
    logged_only = {"loss_style", "loss_context"} & set(got_dict)
    assert logged_only == ({"loss_style", "loss_context"} if masked and name != "ref terms"
                           else set())
    assert all(not got_dict[k].requires_grad for k in logged_only)
