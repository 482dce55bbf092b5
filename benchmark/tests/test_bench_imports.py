"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
references import nothing of the port: each import's top-level name (the
part before the first dot) is compared whole, since the port's name begins
with the JAX package's."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "face_mask_inpaint_tpu"}
PORT = "face_mask_inpaint_tpu_torch"


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=[p.relative_to(BENCH).as_posix() for p in SOURCES])
def test_no_jax_side_import(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert PORT not in names
    assert names <= {"__future__", "benchmark", "torch", "math", "itertools", "contextlib",
                     "typing"}


def test_whole_name_comparison():
    """The port's name starts with the JAX package's and must not match it."""
    from benchmark import run

    saved = dict(sys.modules)
    try:
        sys.modules.pop("jax", None)
        sys.modules[PORT + ".fake"] = sys.modules[__name__]
        assert "face_mask_inpaint_tpu" not in run.forbidden_modules()
        sys.modules["jax.numpy"] = sys.modules[__name__]
        assert run.forbidden_modules() == ["jax"]
    finally:
        for k in list(sys.modules):
            if k not in saved:
                del sys.modules[k]
