"""The ``refill_drn`` configuration: ReferenceFill with two DRN-C-42 encoders
(``--encoder_type drn``) against its plain float32 reference
(``benchmark/reference/refill_drn.py``), and the spans and readers that
measure the DRN's two regimes.

- The benchmark's ``refill_infer`` System in float32 against the
  reference, on seeded random weights loaded strictly by state-dict name:
  the detector, the DRN trunks and the decoder at their published widths,
  on 64x64 photos, batch 2.
- The reference's weight list is the port's state dict, name for name and
  shape for shape; the configuration's DRN keys are ``drn_c_42``'s.
- The calibration keeps every DRN level's output variance O(1) and the
  mask between 5% and 60% of the pixels.
- The float8 control fails the configuration's limits where the port in
  bfloat16 keeps inside them.
- ``drn_strided`` and ``drn_dilated`` are two spans a forward each, inside
  the ``encoder`` spans, and nothing with no profiler running.
- ``roofline.drn_dilated``'s FLOPs, counted from the configuration's keys,
  are what ``FlopCounterMode`` counts over the port's dilated levels on the
  meta device; the three readers read None where the spans are absent.
"""

from __future__ import annotations

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, traffic
from benchmark.harness import BENCH_DIR, load_file_module
from face_mask_inpaint_tpu_torch.models.drn import drn_c_42
from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
from face_mask_inpaint_tpu_torch.utils import profiling
from face_mask_inpaint_tpu_torch.utils.profiling import reset_spans, span_table

CELL = "refill_drn.offline_b128"
READERS = ("span_ms.drn_strided", "span_ms.drn_dilated", "roofline.drn_dilated")


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def small(dtype: str, batch: int = 2) -> harness.Cell:
    """The cell at its published widths on 64x64 photos."""
    full = harness.Cell(CELL)
    config, mix = copy.deepcopy(full.config), copy.deepcopy(full.mix)
    config.update(dtype=dtype, out_size=64)
    mix.update(batch=batch, height=64, width=64, check_rows=batch, check_block=2)
    return harness.Cell(CELL, config=config, mix=mix)


def _setup(cell: harness.Cell, seed: int):
    pool = traffic.make_pool(cell.pipeline.input_spec(cell.config, cell.mix), cell.mix, seed,
                             "cpu")
    weights, calib = harness.cell_weights(cell, seed, pool, "cpu")
    return pool, weights, calib


def _reader(name):
    return load_file_module(BENCH_DIR / "metrics" / f"{name}.py")


def test_reference_matches_the_port_in_float32():
    """float32 on both sides, so the two differ by the order of float32
    sums alone: measured 4e-7 to 8e-7 relative over seeds; 1e-5 leaves
    room for other CPU kernels' orders and is 10^3 times under what
    bfloat16 rounding moves (``image_err_ratio``'s witness)."""
    cell = small("float32")
    pool, weights, _ = _setup(cell, 5)
    system = cell.pipeline.System(cell.config, weights, "cpu")
    images, masks = system.step(pool[0])
    ref = cell.reference.Reference(cell.config, weights, harness.Ops())
    with torch.no_grad():
        ref_mask = ref.mask(pool[0])
        ref_img = ref.generate(pool[0], masks)
    assert torch.equal(ref_mask, masks)
    err = float((images - ref_img).norm() / ref_img.norm())
    assert err < 1e-5, err
    assert float(ref_img.std()) > 0.05  # the image is not flat


def test_every_weight_is_drawn_and_loaded():
    """The reference's weight list is the port's state dict, name for name
    and shape for shape (the System loads it strictly)."""
    cell = small("float32")
    specs = cell.reference.weight_specs(cell.config)
    with torch.device("meta"):
        gen = ReferenceFill(cell.config["encoder"], cell.config["decoder"],
                            use_att=cell.config["use_att"], generator=torch.Generator())
    port = {f"generator.{k}": tuple(v.shape) for k, v in gen.state_dict().items()}
    ref = {k: tuple(shape) for k, (shape, _) in specs.items() if k.startswith("generator.")}
    assert port == ref
    assert any(k.endswith("layer6.block0.downsample_bn.running_var") for k in ref)
    harness.make_weights(specs, 3, "cpu")  # every spec draws


def test_configuration_is_drn_c_42():
    """arch, channels and blocks in the configuration are drn_c_42's."""
    enc = harness.Cell(CELL).config["encoder"]
    with torch.device("meta"):
        drn = drn_c_42(head_features=enc["img_f"])
    assert enc["arch"] == "C"
    channels = [drn.conv1.weight.shape[0]] + [
        getattr(drn, g).block0.conv2.weight.shape[0] for g in drn.groups]
    blocks = [getattr(drn, g).blocks for g in drn.groups]
    assert channels[1:] == enc["channels"] and channels[0] == enc["channels"][0]
    assert blocks == enc["blocks"]
    assert drn.fc.weight.shape[0] == enc["img_f"] == drn.out_channels


def test_calibration_keeps_every_level_order_one():
    """After the calibration every DRN group's output and the head's have a
    variance between 0.1 and 10 on the calibrated photos (with random
    running statistics the residual groups let it grow block by block), and
    the mask covers between 5% and 60% of the pixels."""
    cell = small("float32", batch=4)
    pool, weights, _ = _setup(cell, 11)
    ref = cell.reference.Reference(cell.config, weights, harness.Ops())
    enc = cell.config["encoder"]
    for kind in ("src", "ref"):
        p = f"generator.{kind}_encoder."
        x = pool[0][kind].permute(0, 3, 1, 2).float()
        with torch.no_grad():
            x = torch.relu(ref._bn(f"{p}bn1", ref._dconv(f"{p}conv1", x)))
            levels = [x.var()]
            for name, cin, cout, blocks, stride, dil, residual in \
                    cell.reference.drn_plan(enc):
                for b in range(blocks):
                    x = ref._basic_block(f"{p}{name}.block{b}.", x, cin, cout, stride, dil,
                                         residual, b == 0)
                levels.append(x.var())
            levels.append(ref._dconv(f"{p}fc", x).var())
        assert len(levels) == 10
        assert all(0.1 < float(v) < 10.0 for v in levels), [float(v) for v in levels]
    with torch.no_grad():
        share = float(ref.mask(pool[0]).mean())
    assert 0.05 < share < 0.6, share


def test_control_fails_where_the_program_passes():
    """The port in bfloat16 keeps inside the configuration's limits, the
    float8 control exceeds one of them."""
    cell = small("bfloat16", batch=4)
    seed = 7
    pool, weights, calib = _setup(cell, seed)
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


# -- spans -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def drn_forward():
    """A DRN ReferenceFill forward at small decoder widths on 32x32 photos,
    as a call of no arguments."""
    gen = torch.Generator().manual_seed(0)
    model = ReferenceFill(dict(type="drn", img_f=16, init_type="normal"),
                          dict(ngf=8, img_f=32, L=0, layers=3, norm="instance",
                               activation="LeakyReLU", init_type="normal"),
                          use_att=True, out_size=(32, 32), generator=gen)
    src, ref = torch.rand(2, 2, 32, 32, 3, generator=gen)
    mask = (torch.rand(2, 32, 32, generator=gen) > 0.5).float()
    return lambda: model(src, ref, mask)


def test_drn_spans_two_a_forward_inside_the_encoders(drn_forward):
    reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = drn_forward()
    table = span_table()
    for name in ("drn_strided", "drn_dilated"):
        assert (table[name]["calls"], table[name]["parent"]) == (2, "encoder")
    assert table["encoder"]["calls"] == 2 and table["generator"]["calls"] == 1
    assert table["encoder"]["host_ms"] >= table["drn_strided"]["host_ms"] + \
        table["drn_dilated"]["host_ms"]
    reset_spans()
    assert torch.equal(on, drn_forward())  # the same output with the spans off


def test_drn_spans_off_record_nothing(drn_forward, monkeypatch):
    def made(name):
        raise AssertionError(f"span {name!r} made with no profiler running")

    reset_spans()
    monkeypatch.setattr(profiling, "_Span", made)
    drn_forward()
    assert profiling._records == [] and profiling._open == []


# -- readers -------------------------------------------------------------------------

def test_dilated_flops_from_the_keys_match_the_port():
    """60.26 GFLOP an image a trunk at 256^2: the configuration's count
    equals FlopCounterMode over the port's layer5-8 and head, on the meta
    device, at the 32^2 feature side."""
    config = harness.Cell(CELL).config
    _, flops = _reader("roofline.drn_dilated").counts(config, 1, 256)
    with torch.device("meta"):
        drn = drn_c_42(head_features=config["encoder"]["img_f"])
        x = torch.empty(1, config["encoder"]["channels"][3], 32, 32)
        with FlopCounterMode(display=False) as counter:
            for g in drn.groups[4:]:
                x = getattr(drn, g)(x)
            drn.fc(x)
    assert flops / 2 == counter.get_total_flops()
    assert flops / 2 / 1e9 == pytest.approx(60.26, abs=5e-3)
    bound = _reader("roofline.drn_dilated").bound_s(config, 128, 256)
    assert bound * 1e3 == pytest.approx(15.599, abs=1e-3)  # FLOPs over 989 TFLOP/s
    flagship = harness.Cell("refill_flagship.offline_b128").config
    assert _reader("roofline.drn_dilated").bound_s(flagship, 128, 256) is None


def test_model_flops_on_the_meta_device():
    """``mfu`` counts the reference's forward on the meta device: the two
    trunks' 131.2 GFLOP an image and the rest of the flagship's model."""
    cell = harness.Cell(CELL)
    flops = _reader("mfu").model_flops(cell)
    assert 470e9 < flops < 480e9, flops


TABLE = {  # three batches
    "generator": {"calls": 3, "device_ms": 900.0, "host_ms": 80.0, "parent": None},
    "encoder": {"calls": 6, "device_ms": 210.0, "host_ms": 30.0, "parent": "generator"},
    "drn_strided": {"calls": 6, "device_ms": 45.0, "host_ms": 10.0, "parent": "encoder"},
    "drn_dilated": {"calls": 6, "device_ms": 156.0, "host_ms": 19.0, "parent": "encoder"},
}


@pytest.mark.parametrize("metric", READERS)
def test_readers_on_a_table_and_without_spans(metric, monkeypatch):
    ctx = harness.Context(cell=harness.Cell(CELL), batch=128)
    expect = {"span_ms.drn_strided": 15.0, "span_ms.drn_dilated": 52.0,
              "roofline.drn_dilated": 100.0 * 15.5991 / 52.0}
    read = _reader(metric).read
    monkeypatch.setattr(profiling, "span_table", lambda: TABLE)
    assert read(ctx) == pytest.approx(expect[metric], rel=1e-4)
    no_device = {k: dict(r, device_ms=None) for k, r in TABLE.items()}
    monkeypatch.setattr(profiling, "span_table", lambda: no_device)
    assert read(ctx) is None
    no_drn = {k: r for k, r in TABLE.items() if not k.startswith("drn_")}
    monkeypatch.setattr(profiling, "span_table", lambda: no_drn)
    assert read(ctx) is None
    monkeypatch.delattr(profiling, "span_table")  # a program without spans
    assert read(ctx) is None
