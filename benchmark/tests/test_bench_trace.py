"""The device-trace arithmetic on synthetic traces: the busy time is the
union of the device intervals, not their sum."""

from __future__ import annotations

import pytest

from benchmark import devtrace


def test_union_merges_overlaps_and_drops_empty():
    got = devtrace.union([(5, 7), (0, 2), (1, 3), (6, 9), (4, 4)])
    assert got == [(0, 3), (5, 9)]


def _summary():
    device = [("kernel_a", 1.0, 3.0), ("kernel_b", 2.0, 4.0),      # overlap: 3 s busy
              ("Memcpy DtoH (Device -> Pageable)", 6.0, 7.0),
              ("kernel_a", 8.0, 8.5), ("kernel_c", 9.5, 12.0)]     # past the window's end
    host = [("batch", 0.0, 10.0), ("aten::copy_", 5.0, 7.5), ("aten::conv2d", 0.2, 1.2)]
    return devtrace.Summary(device, host, (0.0, 10.0), batches=2)


def test_busy_is_the_union_inside_the_window():
    s = _summary()
    assert s.busy_s() == pytest.approx(3.0 + 1.0 + 0.5 + 0.5)
    assert s.idle_share() == pytest.approx(0.5)


def test_kernels_leave_out_copies_and_sum_by_name():
    s = _summary()
    assert len(s.kernels()) == 4
    assert s.kernel_seconds(("kernel_a",)) == pytest.approx(2.5)


def test_gaps_are_named_by_the_innermost_host_span():
    s = _summary()
    gaps = sorted(s.gaps())
    assert [round(g[1], 6) for g in gaps] == [1.0, 2.0, 1.0, 1.0]
    br = s.breakdown(top=2)
    assert br["idle_gaps"][0] == ["batch", pytest.approx(2.0)]
    assert br["device_ops"][0][0] == "kernel_c" or br["device_ops"][0][0] == "kernel_a"
    assert s.host_at(0.5) == "aten::conv2d"


def test_idle_metric_reads_the_traced_window():
    """device_idle_pct is the profiled window's share with no device
    interval, in %: never below zero, whatever the batch time outside."""
    from types import SimpleNamespace

    from benchmark.harness import BENCH_DIR, load_file_module

    reader = load_file_module(BENCH_DIR / "metrics" / "device_idle_pct.py").read
    assert reader(SimpleNamespace(summary=_summary())) == pytest.approx(50.0)
    empty = devtrace.Summary([], [], (0.0, 1.0), batches=1)
    assert reader(SimpleNamespace(summary=empty)) is None
