"""The port imports no JAX: every module of face_mask_inpaint_tpu_torch, and
chip_smoke.py, import in a subprocess where ``jax`` and ``flax`` cannot be
imported. Nor pandas, which the card's machine lacks: no source file of the
port imports it, at the top or inside a function."""

import ast

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "face_mask_inpaint_tpu", "pandas"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import face_mask_inpaint_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
assert not any(m.split(".")[0] in ("jax", "flax") for m in sys.modules)
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split()[-1]) >= 20  # every module of the package was imported


def test_port_imports_no_pandas():
    files = sorted((REPO / "face_mask_inpaint_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] in ("pandas", "jax", "flax", "face_mask_inpaint_tpu")
                           for n in names), f"{path}:{node.lineno} imports {names}"
