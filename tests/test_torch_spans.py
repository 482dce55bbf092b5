"""The port's spans (``utils/profiling.py``) on the CPU, and the benchmark's
readers of them.

- With no profiler running, a forward of each stack records nothing and
  makes no span object: ``span()`` hands out the one shared no-op object.
- Outputs are the same, bit for bit, with the spans on and off.
- Under ``torch.profiler``, each stack's CLI step holds ``fmi.step``, with
  ``fmi.detector`` and ``fmi.generator`` inside it, and ``fmi.encoder`` x2,
  ``fmi.fusion`` and ``fmi.decoder`` inside the generator; ``span_table()``
  gives the same calls and parents (no device time without CUDA).
- A span that raises leaves no span open; ``ProfileWindow`` resets the table
  when its window opens and logs it when it writes the trace.
- The benchmark's ``span_ms.*`` readers on a hand-made table (the children
  and the generator's self time add up to the generator) and
  ``idle_ms.program`` on a synthetic device trace; on a program without
  spans each reads None.

Small widths: Stack A at 32^2 (the data-parallel GAN test's encoder and
decoder), Stack B's PSP at output 32 with IR-SE num_layers=4 on 64^2
photos, the UNet detector at its published widths.
"""

from __future__ import annotations

import logging
from types import SimpleNamespace

import pytest
import torch

from benchmark import devtrace
from benchmark.harness import BENCH_DIR, load_file_module
from face_mask_inpaint_tpu_torch.cli.picnet_inference import make_infer_batch as refill_step
from face_mask_inpaint_tpu_torch.cli.psp_inference import make_infer_batch as psp_step
from face_mask_inpaint_tpu_torch.models.psp import PSP
from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
from face_mask_inpaint_tpu_torch.utils import profiling
from face_mask_inpaint_tpu_torch.utils.profiling import (
    ProfileWindow, reset_spans, span, span_table)

ENC = dict(type="pluralistic", ngf=4, z_nc=8, img_f=16, L=1, layers=3,
           norm="none", activation="LeakyReLU", init_type="normal")
DEC = dict(ngf=8, z_nc=8, img_f=32, L=0, layers=3, norm="instance",
           activation="LeakyReLU", init_type="normal")
STACKS = ("refill", "psp")
PER_STEP = {"step": (1, None), "detector": (1, "step"), "generator": (1, "step"),
            "encoder": (2, "generator"), "fusion": (1, "generator"),
            "decoder": (1, "generator")}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def steps():
    """stack -> the CLI's per-batch step on seeded small models and photos,
    as a call of no arguments (Stack A's noise drawn from a fresh seed)."""
    gen = torch.Generator().manual_seed(0)
    detector = MaskDetector(generator=gen)
    refill = ReferenceFill(ENC, DEC, use_att=True, out_size=(32, 32), generator=gen)
    psp = PSP(output_size=32, num_layers=4, decoder_base_channels=32, use_attention=True,
              start_from_latent_avg=True, generator=gen).eval()
    a = torch.rand(2, 2, 32, 32, 3, generator=gen)
    b = torch.rand(2, 2, 64, 64, 3, generator=gen) * 2 - 1
    step_a, step_b = refill_step(detector, refill), psp_step(detector, psp, use_ref=True)
    return {"refill": lambda: step_a(a[0], a[1], torch.Generator().manual_seed(1)),
            "psp": lambda: step_b(b[0], b[1])}


def _profiled(call):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = call()
    return out, prof


@pytest.mark.parametrize("stack", STACKS)
def test_spans_off_record_nothing(stack, steps, monkeypatch):
    """No profiler: the forward makes no span object and records nothing."""
    def made(name):
        raise AssertionError(f"span {name!r} made with no profiler running")

    reset_spans()
    monkeypatch.setattr(profiling, "_Span", made)
    steps[stack]()
    assert profiling._records == [] and profiling._open == []
    assert span("encoder") is span("decoder") is profiling._OFF


@pytest.mark.parametrize("stack", STACKS)
def test_outputs_bit_identical_with_spans_on_and_off(stack, steps):
    off = steps[stack]()
    on, _ = _profiled(steps[stack])
    assert all(torch.equal(x, y) for x, y in zip(off, on))


@pytest.mark.parametrize("stack", STACKS)
def test_spans_nest_at_the_layer_boundaries(stack, steps):
    reset_spans()
    _, prof = _profiled(steps[stack])
    ranges = {}
    for e in prof.events():
        if e.name.startswith(profiling.SPAN_PREFIX):
            ranges.setdefault(e.name[len(profiling.SPAN_PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    assert {k: len(v) for k, v in ranges.items()} == {k: n for k, (n, _) in PER_STEP.items()}

    def inside(name, parent):
        (lo, hi), = ranges[parent]
        return all(lo <= s and e <= hi for s, e in ranges[name])

    for name, (_, parent) in PER_STEP.items():
        if parent is not None:
            assert inside(name, parent), name
    assert not inside("detector", "generator")

    table = span_table()
    assert {k: (r["calls"], r["parent"]) for k, r in table.items()} == PER_STEP
    assert all(r["device_ms"] is None and r["host_ms"] > 0 for r in table.values())
    assert table["generator"]["host_ms"] >= sum(
        table[k]["host_ms"] for k in ("encoder", "fusion", "decoder"))
    reset_spans()


def test_a_span_that_raises_leaves_no_span_open():
    reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with span("generator"):
                with span("encoder"):
                    raise ValueError("inside the encoder")
        assert profiling._open == []
        with span("decoder"):
            pass
    table = span_table()
    assert {k: (r["calls"], r["parent"]) for k, r in table.items()} == {
        "generator": (1, None), "encoder": (1, "generator"), "decoder": (1, None)}
    reset_spans()


def test_profile_window_resets_and_logs_the_spans(tmp_path, caplog):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("detector"):
            pass
    assert "detector" in span_table()
    window = ProfileWindow(str(tmp_path / "prof"), num_steps=2, start_step=1)
    with caplog.at_level(logging.INFO):
        for step in range(4):
            window.tick(step)
            if step == 1:
                assert span_table() == {}  # reset as the window opened
            with span("generator"):
                torch.ones(4).sum()
        window.close()
    table = span_table()
    assert list(table) == ["generator"] and table["generator"]["calls"] == 2
    assert any("span fmi.generator (in -)" in r.getMessage() and "1 calls a step over 2 steps"
               in r.getMessage() for r in caplog.records)
    assert (tmp_path / "prof" / "trace.json").is_file()
    reset_spans()


# -- the benchmark's readers -------------------------------------------------------

def _reader(name):
    return load_file_module(BENCH_DIR / "metrics" / f"{name}.py").read


TABLE = {  # three batches
    "step": {"calls": 3, "device_ms": 300.0, "host_ms": 90.0, "parent": None},
    "detector": {"calls": 3, "device_ms": 60.0, "host_ms": 6.0, "parent": "step"},
    "generator": {"calls": 3, "device_ms": 210.0, "host_ms": 80.0, "parent": "step"},
    "encoder": {"calls": 6, "device_ms": 90.0, "host_ms": 30.0, "parent": "generator"},
    "fusion": {"calls": 3, "device_ms": 30.0, "host_ms": 10.0, "parent": "generator"},
    "decoder": {"calls": 3, "device_ms": 75.0, "host_ms": 35.0, "parent": "generator"},
}
SPAN_MS = {"span_ms.encoder": 30.0, "span_ms.fusion": 10.0, "span_ms.decoder": 25.0,
           "span_ms.generator_self": 5.0}


@pytest.mark.parametrize("metric", sorted(SPAN_MS))
def test_span_readers_on_a_table(metric, monkeypatch):
    monkeypatch.setattr(profiling, "span_table", lambda: TABLE)
    assert _reader(metric)(None) == pytest.approx(SPAN_MS[metric])
    assert sum(SPAN_MS.values()) == pytest.approx(TABLE["generator"]["device_ms"] / 3)
    no_device = {k: dict(r, device_ms=None) for k, r in TABLE.items()}
    monkeypatch.setattr(profiling, "span_table", lambda: no_device)
    assert _reader(metric)(None) is None
    monkeypatch.setattr(profiling, "span_table", lambda: {})
    assert _reader(metric)(None) is None
    monkeypatch.delattr(profiling, "span_table")  # a program without spans
    assert _reader(metric)(None) is None


def test_program_idle_reader_on_a_synthetic_trace(monkeypatch):
    """Gaps that began inside an ``fmi.*`` range count; the one that began in
    the caller's copy does not."""
    device = [("kernel_a", 0.0, 1.0), ("kernel_b", 2.0, 3.0), ("kernel_c", 5.0, 6.0)]
    host = [("batch", 0.0, 8.0), ("fmi.step", 0.5, 4.0), ("fmi.generator", 1.5, 3.5),
            ("aten::copy_", 4.5, 7.0)]
    summary = devtrace.Summary(device, host, (0.0, 8.0), batches=2)
    assert sorted(summary.gaps()) == [(1.0, 1.0), (3.0, 2.0), (6.0, 2.0)]
    read = _reader("idle_ms.program")
    assert read(SimpleNamespace(summary=summary)) == pytest.approx(1e3 * (1.0 + 2.0) / 2)
    no_spans = devtrace.Summary(device, host[:1] + host[3:], (0.0, 8.0), batches=2)
    assert read(SimpleNamespace(summary=no_spans)) is None
    monkeypatch.delattr(profiling, "SPAN_PREFIX")  # a program without spans
    assert read(SimpleNamespace(summary=summary)) is None
