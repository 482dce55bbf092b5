"""BENCHMARK.json against the benchmark's contract, and every file it names."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert isinstance(MANIFEST["run_seconds"], int) and 10 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=[e["name"] for _, e in _names()])
def test_names_units_and_keys(group, entry):
    assert NAME.match(entry["name"])
    if group == "configs":
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert entry["reduced"] == [] and (ROOT / entry["file"]).is_file()
        assert entry["file"].startswith("benchmark/")
    elif group == "workloads":
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] == 1
        assert (ROOT / "benchmark" / "traffic" / f"{entry['traffic']}.json").is_file()
    else:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        extra = {"bound"} if group == "end_to_end" else {"layer", "moves"}
        assert set(entry) - {"workloads"} == METRIC_KEYS | extra
    texts = ("why", "layer") + (("source",) if group == "configs" else ())
    for key in texts:
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_bounds_and_sources():
    names = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in names
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in names


def test_every_cell_reports_enough():
    for cell in MANIFEST["workloads"]:
        e2e = [m for m in MANIFEST["end_to_end"]
               if cell["name"] in m.get("workloads", [cell["name"]])]
        layer = [m for m in MANIFEST["per_layer"]
                 if cell["name"] in m.get("workloads", [cell["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_found_by_name(cell):
    """Each cell's configuration, mix, pipeline, reference and metric readers
    load from their files."""
    c = harness.Cell(cell, manifest=MANIFEST)
    assert c.config["name"] == c.entry["config"]
    assert set(c.config["checks"]) == {"mask_flip_pct", "image_err_ratio"}
    for m in c.per_layer:
        assert callable(c.metric_reader(m["name"]))
    assert hasattr(c.reference, "weight_specs") and hasattr(c.reference, "Reference")


def test_file_names_use_name_characters():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel
