"""The pSp training step and its optimizers against the JAX package.

- Ranger: 14-step trajectories in float64 against the JAX ``ranger`` on a
  conv kernel and a dense kernel carried across layouts (HWIO -> OIHW,
  [in, out] -> [out, in]) with ``convert.jax_leading_dims`` choosing the
  centralization axes, as tests/test_train_steps.py holds the JAX ranger to
  the reference (1e-9); and a test that shows those axes are not the
  reference's per-output-channel ones.
- ``make_psp_train_step`` against the JAX step from identical weights:
  PSP(output_size=32, num_layers=4, decoder_base_channels=32,
  use_attention=True, start_from_latent_avg=True) with the fixed noise,
  ``resize=False`` (everything at 32^2, as the JAX package's own tests run
  the step on tiny shapes), the latent average injected from the JAX side,
  and the masked LPIPS and L2 terms, their reference-side twins and the
  W-norm. One jitted JAX step (adam, decoder trained) is shared by the
  module. Two configurations cover both optimizers and both train_decoder
  values: adam with the decoder trained, held against that step's new
  parameters, and ranger with the encoder alone, held against the JAX
  step's transformation (``partitioned_tx(ranger_injected)``) applied to
  its gradients. Compared: the loss dict, the ``return_grads`` gradients,
  the updated parameters (the frozen ones unchanged), the BatchNorm
  statistics.
- A batch with a NaN: the parameters stay, Adam's moments decay and its
  count advances, as optax's state does under the JAX guard.

Tolerances (f32): losses within 1e-4 relative; gradients, Adam's moments
and parameters within 1e-4 of each tensor's largest JAX entry, plus for the
gradients and moments a floor of 1e-5 of the model's largest entry (tensors
whose gradients sit many orders below the rest carry the f32 noise of the
large ones). The learning rate is the recipe's 1e-4; Adam's first step
moves each element by lr * sign(g), so where the JAX gradient is at the
f32 noise (|g| <= 1e-3 of the tensor's largest entry) the sign may differ
and such an element may sit 2 lr apart.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax

from face_mask_inpaint_tpu.losses import lpips as jlp
from face_mask_inpaint_tpu.losses.psp_loss import PSPLossConfig as JPSPLossConfig
from face_mask_inpaint_tpu.models.psp import PSP as JPSP
from face_mask_inpaint_tpu.train import optim as joptim
from face_mask_inpaint_tpu.train.psp import make_psp_train_step as jmake_step
from face_mask_inpaint_tpu.train.psp import partitioned_tx
from face_mask_inpaint_tpu.train.state import ModuleState, TrainState
from face_mask_inpaint_tpu_torch.convert import (
    convert_lpips, convert_psp, jax_leading_dims, state_dict_from_jax)
from face_mask_inpaint_tpu_torch.losses.lpips import LPIPSNet
from face_mask_inpaint_tpu_torch.losses.psp_loss import PSPLossConfig
from face_mask_inpaint_tpu_torch.models.psp import PSP
from face_mask_inpaint_tpu_torch.nn.layers import Conv2d, Dense
from face_mask_inpaint_tpu_torch.train.optim import Ranger, adam, ranger
from face_mask_inpaint_tpu_torch.train.psp import make_psp_train_step, partition_params

from tests.test_torch_stylegan2 import _assert_rel, random_variables

KEY = jax.random.PRNGKey(0)
LR = 1e-4
HW = 32
SMALL = dict(output_size=32, num_layers=4, decoder_base_channels=32, use_attention=True,
             start_from_latent_avg=True)
# every term that reaches the parameters but the identity loss (its crop
# needs 223 rows; it and the logged-only style and contextual terms are held
# in tests/test_torch_psp_losses.py)
LOSS = dict(id_lambda=0.0, lpips_lambda=0.8, l2_lambda=2.0, style_lambda=0.0, cx_lambda=0.0,
            lpips_lambda_ref=0.1, l2_lambda_ref=0.5, w_norm_lambda=0.01,
            start_from_latent_avg=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- Ranger ---------------------------------------------------------------

class _Leaves(nn.Module):
    """A conv and a dense layer: the two layouts the port changes."""

    def __init__(self):
        super().__init__()
        self.conv = Conv2d(4, 8, 3)
        self.dense = Dense(6, 5)


def _ranger_case(seed, n_steps=14):
    rs = np.random.RandomState(seed)
    shapes = {"conv": {"kernel": (3, 3, 4, 8), "bias": (8,)},
              "dense": {"kernel": (6, 5), "bias": (5,)}}
    tree = lambda: {m: {k: rs.randn(*s) for k, s in d.items()} for m, d in shapes.items()}
    return tree(), [tree() for _ in range(n_steps)]


def _port(module, tree):
    """The JAX tree in the port's layouts, in float64 (convert.py's rules:
    HWIO -> OIHW, [in, out] -> [out, in]; state_dict_from_jax rounds to
    f32)."""
    out = {}
    for m, leaves in tree.items():
        for k, v in leaves.items():
            v = np.asarray(v, np.float64)
            if k == "kernel":
                v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            out[f"{m}.{'weight' if k == 'kernel' else k}"] = torch.from_numpy(
                np.ascontiguousarray(v))
    return out


def test_ranger_trajectory_matches_jax_across_layouts():
    """14 steps (the unrectified RAdam phase, the rectified one, lookahead
    syncs at 6 and 12) in float64: parameters and slow buffers within
    1e-9."""
    init, grads = _ranger_case(42)
    module = _Leaves().double()
    with torch.no_grad():
        for k, v in _port(module, init).items():
            module.get_parameter(k).copy_(v)
    named = dict(module.named_parameters())
    dims = jax_leading_dims(module)
    assert dims == {"conv.weight": 2, "dense.weight": 1}
    opt = ranger(named.values(), 1e-2, keep_dims={named[k]: d for k, d in dims.items()})
    for g in grads:
        ported = _port(module, g)
        assert set(ported) == set(named)
        for k, v in ported.items():
            named[k].grad = v
        opt.step()
    with jax.enable_x64():
        tx = joptim.ranger(1e-2)

        @jax.jit
        def update(g, state, params):
            updates, state = tx.update(g, state, params)
            return optax.apply_updates(params, updates), state

        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), init)
        state = tx.init(params)
        for g in grads:
            params, state = update(jax.tree.map(jnp.asarray, g), state, params)
        params, slow = jax.device_get((params, state.slow))
    for k, v in _port(module, params).items():
        np.testing.assert_allclose(named[k].detach().numpy(), v.numpy(), rtol=1e-9, atol=1e-9,
                                   err_msg=k)
    for k, v in _port(module, slow).items():
        np.testing.assert_allclose(opt.state[named[k]]["slow"].numpy(), v.numpy(), rtol=1e-9,
                                   atol=1e-9, err_msg=f"slow buffer of {k}")


def test_ranger_centralization_axes_differ_from_the_reference():
    """The JAX package centralizes over its own layout's axes 1.. (HWIO:
    kw, in and out for each kernel row h; [in, out]: out for each input),
    the reference torch Ranger over OIHW's and [out, in]'s axes 1.. (per
    output channel). One step from the same gradient shows the two apart;
    the port follows the JAX package."""
    _, (g,) = _ranger_case(7, n_steps=1)
    module = _Leaves().double()
    named = dict(module.named_parameters())
    port_g = _port(module, g)
    dims = jax_leading_dims(module)
    jax_style = Ranger([named["conv.weight"], named["dense.weight"]],
                       keep_dims={named[k]: d for k, d in dims.items()})
    ref_style = Ranger([named["conv.weight"], named["dense.weight"]],
                       keep_dims={named[k]: 0 for k in dims})
    for k in ("conv.weight", "dense.weight"):
        p, gk = named[k], port_g[k]
        ours, theirs = jax_style._centralize(p, gk), ref_style._centralize(p, gk)
        with jax.enable_x64():
            jg = jnp.asarray(g[k.split(".")[0]]["kernel"], jnp.float64)
            jc = jg - jnp.mean(jg, axis=tuple(range(1, jg.ndim)), keepdims=True)
        np.testing.assert_allclose(ours.numpy(), _port(module, {k.split(".")[0]: {
            "kernel": np.asarray(jc)}})[k].numpy(), rtol=1e-12, atol=1e-12)
        gap = float((ours - theirs).abs().max())
        assert gap > 0.1 * float(gk.abs().max()), (k, tuple(gk.shape), gap)


def test_ranger_needs_the_axes_of_every_matrix():
    """Ranger centralizes only over the axes it is given: a parameter of two
    or more dimensions without a ``keep_dims`` entry is refused."""
    named = dict(_Leaves().named_parameters())
    with pytest.raises(ValueError, match="keep_dims"):
        Ranger(named.values(), keep_dims={named["conv.weight"]: 2})


def test_ranger_state_dict_round_trip_resumes_bit_for_bit():
    """Ranger's moments, count and slow buffers go through state_dict (the
    trainer's checkpoint): two steps equal one step, a round trip into a
    fresh optimizer and one step, through a lookahead sync at k=2."""
    init, grads = _ranger_case(3, n_steps=2)

    def fresh():
        module = _Leaves().double()
        with torch.no_grad():
            for k, v in _port(module, init).items():
                module.get_parameter(k).copy_(v)
        named = dict(module.named_parameters())
        dims = jax_leading_dims(module)
        return named, Ranger(named.values(), lr=1e-2, k=2,
                             keep_dims={named[k]: d for k, d in dims.items()})

    def step(named, opt, g):
        for k, v in _port(_Leaves(), g).items():
            named[k].grad = v
        opt.step()

    cont, cont_opt = fresh()
    for g in grads:
        step(cont, cont_opt, g)
    first, first_opt = fresh()
    step(first, first_opt, grads[0])
    resumed, resumed_opt = fresh()
    with torch.no_grad():
        for k, p in resumed.items():
            p.copy_(first[k])
    resumed_opt.load_state_dict(first_opt.state_dict())
    step(resumed, resumed_opt, grads[1])
    for k, p in cont.items():
        assert torch.equal(p, resumed[k]), k
        for key in ("exp_avg", "exp_avg_sq", "slow"):
            assert torch.equal(cont_opt.state[p][key], resumed_opt.state[resumed[k]][key])


# -- the step ---------------------------------------------------------------

def _batch(seed, nan=False):
    rs = np.random.RandomState(seed)
    b = {k: rs.uniform(-1, 1, (2, HW, HW, 3)).astype(np.float32)
         for k in ("src_img", "gt_img", "ref_img")}
    mask = np.zeros((2, HW, HW), np.float32)
    mask[:, 10:25, 6:22] = 1.0
    b["mask"] = mask
    if nan:
        b["gt_img"][0, 3, 5, 1] = np.nan
    return b


def _find(tree, cls_name):
    """The first node of a JAX optimizer state whose type is ``cls_name``."""
    if type(tree).__name__ == cls_name:
        return tree
    children = (tree.values() if isinstance(tree, dict)
                else tree if isinstance(tree, (tuple, list)) else ())
    for c in children:
        found = _find(c, cls_name)
        if found is not None:
            return found
    return None


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side, once: variables and sub-nets from a seeded fill, one
    jitted train step (adam, train_decoder=1, return_grads) on a batch and
    then on a batch with a NaN."""
    b = _batch(1)
    src, mask = jnp.asarray(b["src_img"]), jnp.asarray(b["mask"])
    model = JPSP(**SMALL)
    variables = random_variables(lambda: model.init(
        {"params": KEY, "noise": KEY}, src, ref=src, src_mask=mask, train=False), 31)
    img = jnp.zeros((1, HW, HW, 3))
    nets = {"lpips": random_variables(lambda: jlp.LPIPSNet("alex").init(KEY, img, img),
                                      32)["params"]}
    variables = jax.device_get(variables)  # host copies: the step's state is donated
    mstate = ModuleState.from_variables(jax.tree.map(jnp.array, variables))
    tx = partitioned_tx(joptim.adam_injected(LR), mstate.params, True)
    state = TrainState(step=jnp.zeros([], jnp.int32), model=mstate,
                       opt_state=tx.init(mstate.params), rng=KEY)
    # the state is donated, as the JAX trainer donates it; the tests keep
    # host copies of what they read
    step = jax.jit(jmake_step(model, tx, JPSPLossConfig(**LOSS), nets, use_ref=True,
                              randomize_noise=False, return_grads=True, resize=False),
                   donate_argnums=0)
    s1, m1 = step(state, {k: jnp.asarray(v) for k, v in b.items()})
    run = dict(variables=variables, nets=nets, batch=b,
               s1_params=jax.device_get(s1.model.params),
               s1_stats=jax.device_get(s1.model.batch_stats), m1=jax.device_get(m1))
    del m1
    s2, m2 = step(s1, {k: jnp.asarray(v) for k, v in _batch(1, nan=True).items()})
    run["adam2"] = jax.device_get(_find(s2.opt_state, "ScaleByAdamState"))
    run["m2"] = jax.device_get({k: v for k, v in m2.items() if k != "grads"})
    del s2, m2, step
    jax.clear_caches()
    return run


def _port_model(run):
    """The port's PSP and loss nets, every weight from the JAX variables
    (converted once a module)."""
    if "port_state" not in run:
        run["port_state"] = (convert_psp(PSP(**SMALL, init=False), run["variables"]),
                             convert_lpips(LPIPSNet("alex"), run["nets"]["lpips"]))
    psp, lp = PSP(**SMALL, init=False), LPIPSNet("alex")
    for m, sd in zip((psp, lp), run["port_state"]):
        m.load_state_dict(sd, strict=True)
    return psp, {"lpips": lp}


def _port_step(run, train_decoder, optimizer):
    psp, nets = _port_model(run)
    named = partition_params(psp, train_decoder)
    params = [p for _, p in named]
    if optimizer == "ranger":
        dims = jax_leading_dims(psp)
        opt = ranger(params, LR, keep_dims={p: dims[n] for n, p in named if n in dims})
    else:
        opt = adam(params, LR)
    step = make_psp_train_step(psp, opt, PSPLossConfig(**LOSS), nets, use_ref=True,
                               randomize_noise=False, resize=False)
    return psp, opt, dict(named), step


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_update(run, train_decoder, optimizer):
    """The JAX step's update of this configuration on its gradients."""
    base = joptim.ranger_injected(LR) if optimizer == "ranger" else joptim.adam_injected(LR)
    params = run["variables"]["params"]
    tx = partitioned_tx(base, params, train_decoder)

    @jax.jit
    def update(grads, params):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)

    new_params = jax.device_get(update(run["m1"]["grads"], params))
    jax.clear_caches()
    return new_params


@pytest.mark.parametrize("optimizer,train_decoder", [("adam", True), ("ranger", False)])
def test_psp_train_step_matches_jax(jax_run, optimizer, train_decoder):
    psp, _, named, step = _port_step(jax_run, train_decoder, optimizer)
    before = {n: p.detach().clone() for n, p in psp.named_parameters()}
    out = step(_tensors(jax_run["batch"]), return_grads=True)
    after = psp.state_dict()
    new_params = (jax_run["s1_params"] if optimizer == "adam"
                  else _jax_update(jax_run, train_decoder, optimizer))
    m1 = jax_run["m1"]
    assert set(out) == set(m1)
    for k in m1:
        if k != "grads":
            _assert_rel(out[k].numpy(), np.asarray(m1[k]), 1e-4)
    assert float(out["skipped_nonfinite"]) == 0.0
    # gradients of the trained tensors, against the JAX step's
    want_g = state_dict_from_jax(psp, {"params": m1["grads"]})
    assert set(out["grads"]) == set(named)
    floor = 1e-5 * max(float(want_g[n].abs().max()) for n in named)
    for n, g in out["grads"].items():
        w = want_g[n]
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()) + floor, n
    # parameters after the update; the frozen ones unchanged
    want_p = state_dict_from_jax(psp, {"params": new_params})
    for n, p in psp.named_parameters():
        w, got = want_p[n], after[n]
        if n not in named:
            assert torch.equal(got, before[n]) and not p.requires_grad, n
            continue
        g = want_g[n]
        tol = torch.full_like(w, 1e-4 * float(w.abs().max()))
        if optimizer == "adam":
            tol = torch.where(g.abs() <= 1e-3 * float(g.abs().max()), tol + 2 * LR, tol)
        assert bool(((got - w).abs() <= tol).all()), n
    assert any(n.startswith("decoder.") for n in named) == train_decoder
    # BatchNorm running statistics after the step's two encoder passes
    stats = state_dict_from_jax(psp, {"batch_stats": jax_run["s1_stats"]})
    for k, v in stats.items():
        _assert_rel(after[k].numpy(), v.numpy(), 1e-4)


def test_psp_train_step_nan_batch_holds_parameters_and_advances_adam(jax_run):
    """A finite step, then a batch whose ground truth holds a NaN: the loss
    is not finite, the parameters stay where the first step left them, and
    Adam's moments decay (mu * b1, nu * b2) and its count reaches 2, as the
    JAX guard runs optax with zeroed gradients."""
    psp, opt, named, step = _port_step(jax_run, True, "adam")
    step(_tensors(jax_run["batch"]))
    after_first = {n: p.detach().clone() for n, p in named.items()}
    out = step(_tensors(_batch(1, nan=True)), return_grads=True)
    assert float(out["skipped_nonfinite"]) == 1.0 == float(jax_run["m2"]["skipped_nonfinite"])
    assert not np.isfinite(float(out["loss"])) and not np.isfinite(float(jax_run["m2"]["loss"]))
    assert all(float(g.abs().max()) == 0.0 for g in out["grads"].values())
    for n, p in named.items():
        assert torch.equal(p.detach(), after_first[n]), n
    adam_state = jax_run["adam2"]
    assert int(adam_state.count) == 2
    mu = state_dict_from_jax(psp, {"params": adam_state.mu})
    nu = state_dict_from_jax(psp, {"params": adam_state.nu})
    floors = {k: 1e-5 * max(float(t[n].abs().max()) for n in named)
              for k, t in (("exp_avg", mu), ("exp_avg_sq", nu))}
    for n, p in named.items():
        st = opt.state[p]
        assert int(st["step"]) == 2
        for k, want in (("exp_avg", mu[n]), ("exp_avg_sq", nu[n])):
            err = float((st[k] - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()) + floors[k], (n, k, err)
