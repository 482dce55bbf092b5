"""The benchmark's operation and byte counts reproduce the port's kernel
table (PERF.md, table of every TPU kernel) at batch 16."""

from __future__ import annotations

import pytest

from benchmark import harness, roofline
from benchmark.harness import BENCH_DIR, load_file_module

FLAGSHIP = harness.Cell("refill_flagship.offline_b128").config
PSP = harness.Cell("psp_config4.offline_b64").config
K = {k: load_file_module(BENCH_DIR / "metrics" / f"roofline.{k}.py")
     for k in ("k1", "k2", "k6", "k7a")}


def bound_s(kernel, config, batch, side):
    calls = K[kernel].calls(config, batch, side)
    return sum(roofline.bound_of(*c) for c in calls) if calls else None


def totals(kernel, config, batch, side):
    calls = K[kernel].calls(config, batch, side)
    return sum(c[0] for c in calls), sum(c[1] for c in calls)


def test_k1_bound_is_operations():
    nbytes, ops = totals("k1", FLAGSHIP, 16, 256)
    assert ops == pytest.approx(2.749e12, rel=1e-3)
    assert bound_s("k1", FLAGSHIP, 16, 256) * 1e3 == pytest.approx(2.779, abs=5e-4)


def test_k2_ten_calls_bound_by_bytes():
    assert len(K["k2"].calls(FLAGSHIP, 16, 256)) == 10
    assert bound_s("k2", FLAGSHIP, 16, 256) * 1e3 == pytest.approx(0.891, abs=5e-4)


def test_k6_sixteen_calls_move_4385_mb():
    assert len(K["k6"].calls(PSP, 16, 256)) == 16
    nbytes, _ = totals("k6", PSP, 16, 256)
    assert nbytes / 1e9 == pytest.approx(4.385, abs=5e-4)
    assert bound_s("k6", PSP, 16, 256) * 1e3 == pytest.approx(1.309, abs=5e-4)


def test_k7a_seventeen_calls_move_8410_mb():
    assert len(K["k7a"].calls(PSP, 16, 256)) == 17
    nbytes, _ = totals("k7a", PSP, 16, 256)
    assert nbytes / 1e9 == pytest.approx(8.410, abs=5e-4)
    assert bound_s("k7a", PSP, 16, 256) * 1e3 == pytest.approx(2.510, abs=5e-4)


def test_kernels_of_the_other_stack_have_no_bound():
    for k in ("k6", "k7a"):
        assert bound_s(k, FLAGSHIP, 64, 256) is None
    for k in ("k1", "k2"):
        assert bound_s(k, PSP, 64, 256) is None


def test_counts_follow_the_configuration_keys():
    """K1 needs ``use_att``, K2 an instance-norm decoder; the pipeline's name
    plays no part."""
    no_att = dict(FLAGSHIP, use_att=False, pipeline="other")
    assert bound_s("k1", no_att, 16, 256) is None
    assert len(K["k2"].calls(no_att, 16, 256)) == 10
    no_norm = dict(FLAGSHIP, decoder=dict(FLAGSHIP["decoder"], norm="none"))
    assert bound_s("k2", no_norm, 16, 256) is None
    half = dict(PSP, psp=dict(PSP["psp"], output_size=512))
    assert len(K["k6"].calls(half, 16, 256)) == 14
    assert len(K["k7a"].calls(half, 16, 256)) == 15


def test_batch_64_scales_linearly():
    for k, cfg in (("k1", FLAGSHIP), ("k2", FLAGSHIP), ("k6", PSP), ("k7a", PSP)):
        b16, b64 = bound_s(k, cfg, 16, 256), bound_s(k, cfg, 64, 256)
        assert b64 == pytest.approx(4 * b16, rel=1e-3)
