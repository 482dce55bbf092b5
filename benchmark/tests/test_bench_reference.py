"""Each configuration's frozen plain reference against the port's own path,
on the CPU at small widths in float32 (where the port takes its kernels'
plain versions), with the benchmark's weights loaded into both; and the
control, the reference with float8 operands, failing the check's limits
where the port in bfloat16 keeps inside them. The test imports both sides;
the references import nothing of the port."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, traffic
from benchmark.tests.conftest import CELLS, small


@pytest.mark.parametrize("cell_name", CELLS)
def test_reference_matches_the_port_in_float32(cell_name):
    cell = small(cell_name, dtype="float32")
    pool = traffic.make_pool(cell.pipeline.input_spec(cell.config, cell.mix), cell.mix, 5, "cpu")
    weights, calib = harness.cell_weights(cell, 5, pool, "cpu")
    system = cell.pipeline.System(cell.config, weights, "cpu")
    images, masks = system.step(pool[0])
    ref = cell.reference.Reference(cell.config, weights, harness.Ops())
    with torch.no_grad():
        ref_mask = ref.mask(pool[0])
        ref_img = ref.generate(pool[0], masks)
    assert torch.equal(ref_mask, masks)
    assert 0.05 < float(masks.mean()) < 0.6  # the calibrated mask covers some, not all
    err = float((images - ref_img).norm() / ref_img.norm())
    assert err < 1e-5, err


@pytest.mark.parametrize("cell_name", CELLS)
def test_every_weight_is_drawn_and_loaded(cell_name):
    """The reference's weight list is the port's state dict, name for name
    and shape for shape (loading is strict)."""
    cell = small(cell_name, dtype="float32")
    specs = cell.reference.weight_specs(cell.config)
    weights = harness.make_weights(specs, 3, "cpu")
    system = cell.pipeline.System(cell.config, weights, "cpu")
    ported = {f"{p}{k}" for p, m in (("detector.", system.detector),
                                      (("generator." if hasattr(system, "generator")
                                        else "psp."),
                                       getattr(system, "generator", getattr(system, "psp",
                                                                            None))))
              for k in m.state_dict()}
    assert ported == set(specs)


def test_weights_repeat_from_the_seed():
    cell = small(CELLS[0])
    specs = cell.reference.weight_specs(cell.config)
    a, b = harness.make_weights(specs, 2 ** 33 + 1, "cpu"), harness.make_weights(
        specs, 2 ** 33 + 1, "cpu")
    c = harness.make_weights(specs, 2 ** 33 + 2, "cpu")
    name = next(iter(specs))
    assert torch.equal(a[name], b[name]) and not torch.equal(a[name], c[name])


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_where_the_program_passes(cell_name):
    """At a size a test can hold: the port in bfloat16 keeps inside the
    configuration's limits, the float8 control exceeds one of them."""
    cell = small(cell_name)
    seed = 7
    pool = traffic.make_pool(cell.pipeline.input_spec(cell.config, cell.mix), cell.mix, seed,
                             "cpu")
    weights, calib = harness.cell_weights(cell, seed, pool, "cpu")
    rows = traffic.check_rows(cell.mix, seed)
    system = cell.pipeline.System(cell.config, weights, "cpu")
    produced = {}
    for j, batch in enumerate(pool):
        images, masks = system.step(batch)
        produced[j] = [(images[rows], masks[rows])]
    limits = cell.config["checks"]
    program = harness.judge(cell, seed, pool, rows, produced, "cpu", calib)
    assert all(program[k] <= limits[k] for k in limits), program
    control = harness.judge(cell, seed, pool, rows,
                            harness.control_outputs(cell, seed, pool, rows, "cpu", calib),
                            "cpu", calib)
    assert any(control[k] > limits[k] for k in limits), control


@pytest.mark.parametrize("cell_name", CELLS)
def test_check_numbers_read_their_definitions(cell_name):
    """The reference's own float32 output reads 0 on both numbers and its
    bfloat16 witness an image_err_ratio of 1; flipping mask pixels near a
    tie counts nothing, flipping pixels the reference decides by a margin
    counts them."""
    cell = small(cell_name)
    seed = 9
    pool = traffic.make_pool(cell.pipeline.input_spec(cell.config, cell.mix), cell.mix, seed,
                             "cpu")
    weights, calib = harness.cell_weights(cell, seed, pool, "cpu")
    rows = traffic.check_rows(cell.mix, seed)
    ref = cell.reference.Reference(cell.config, weights, harness.Ops())
    witness = cell.reference.Reference(cell.config, weights, harness.Ops("bf16"))
    batches = [{k: v[rows] for k, v in b.items()} for b in pool]
    with torch.no_grad():
        gaps = [ref.mask_gap(b) for b in batches]
        masks = [(g > 0).float() for g in gaps]
        own = {j: [(ref.generate(b, m), m)] for j, (b, m) in enumerate(zip(batches, masks))}
        wit = {j: [(witness.generate(b, m), m)] for j, (b, m) in enumerate(zip(batches, masks))}
    assert harness.judge(cell, seed, pool, rows, own, "cpu", calib) == {
        "mask_flip_pct": 0.0, "image_err_ratio": 0.0}
    assert harness.judge(cell, seed, pool, rows, wit, "cpu", calib)["image_err_ratio"] == \
        pytest.approx(1.0, rel=1e-6)

    def flipped(keep):
        out = {}
        for j, ((img, m), g) in enumerate(zip((o[0] for o in own.values()), gaps)):
            median = g.abs().flatten(1).median(dim=1).values[:, None, None]
            near = g.abs() < harness.MARGIN * median
            pick = torch.rand(g.shape, generator=torch.Generator().manual_seed(j)) < 0.1
            sel = near if keep == "near" else ~near & pick
            out[j] = [(img, torch.where(sel, 1.0 - m, m))]
        return harness.judge(cell, seed, pool, rows, out, "cpu", calib)["mask_flip_pct"]

    assert flipped("near") == 0.0
    assert 5.0 < flipped("decided") < 15.0
