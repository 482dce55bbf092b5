"""The port's learning-rate schedules (train/optim.py get_scheduler and
plateau_scheduler) against the JAX package's on the CPU.

``get_scheduler``: the three policies over epochs 0-40, within 1e-6 of the
JAX value (both compute in float32; XLA's power and numpy's may round the
last bit apart). ``plateau_scheduler``: the scale after every value of a
fixed metric sequence against ``optax.contrib.reduce_on_plateau``'s (the
transformation the JAX function returns) applied to a unit update, scale
for scale, through an improvement, plateaus, a cooldown and ``min_scale``.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.train import optim as joptim
from face_mask_inpaint_tpu_torch.train import optim as toptim

POLICIES = [
    ("lambda", dict(niter=10, niter_decay=20)),
    ("lambda", dict(niter=5, niter_decay=7, iter_count=3)),
    ("step", dict(lr_decay_iters=7)),
    ("exponent", dict()),
]


@pytest.mark.parametrize("policy,kw", POLICIES)
def test_get_scheduler_matches_jax(policy, kw):
    want = joptim.get_scheduler(policy, 2e-4, **kw)
    got = toptim.get_scheduler(policy, 2e-4, **kw)
    for epoch in range(41):
        w, g = float(want(epoch)), got(epoch)
        assert isinstance(g, float)
        assert math.isclose(g, w, rel_tol=1e-6, abs_tol=1e-12), (policy, epoch, g, w)


def test_get_scheduler_unknown_policy():
    with pytest.raises(NotImplementedError, match="cosine"):
        toptim.get_scheduler("cosine", 1e-3)


# a drop, a plateau long enough for two reductions with a cooldown between,
# an improvement inside the cooldown, changes within rtol that do not count
# as improvements, and a tail that pins the scale at min_scale
METRICS = [5.0, 4.0, 4.0, 3.9999, 4.1, 4.0, 3.0, 3.0, 3.0, 2.9999, 3.0, 3.0, 3.0, 3.0,
           3.0, 3.0, 2.5, 2.6, 2.7, 2.8, 2.9, 3.0, 3.1, 3.2, 3.3, 3.4, 3.5]
PLATEAU_ARGS = [
    dict(factor=0.5, patience=2, rtol=1e-3, cooldown=2, min_scale=0.1),
    dict(factor=0.1, patience=3, rtol=1e-4, cooldown=0, min_scale=0.0),
    dict(factor=0.3, patience=1, rtol=1e-2, cooldown=1, min_scale=0.05),
]


@pytest.mark.parametrize("kw", PLATEAU_ARGS)
def test_plateau_scheduler_matches_optax(kw):
    tx = joptim.plateau_scheduler(**kw)
    updates = {"w": jnp.ones(())}
    state = tx.init(updates)
    update = jax.jit(lambda u, st, v: tx.update(u, st, value=v))
    ours = toptim.plateau_scheduler(**kw)
    got, want = [], []
    for value in METRICS:
        scaled, state = update(updates, state, value)
        want.append(float(scaled["w"]))
        got.append(ours.update(value))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    assert len(set(want)) >= 3  # the sequence reduced the scale at least twice
    assert got[-1] == pytest.approx(max(kw["min_scale"], min(got)))


def test_plateau_scheduler_rejects_bad_factor():
    with pytest.raises(ValueError):
        toptim.plateau_scheduler(factor=1.5)
