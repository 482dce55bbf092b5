"""The port imports no JAX: every module of face_mask_inpaint_tpu_torch, and
chip_smoke.py, import in a subprocess where ``jax``, ``flax``, ``optax``,
``orbax`` and ``tensorstore`` cannot be imported. Nor pandas, which the card's
machine lacks: no source file of the port imports any of them, at the top or
inside a function."""

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
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
                                  "face_mask_inpaint_tpu", "pandas"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import face_mask_inpaint_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
assert not any(m.split(".")[0] in ("jax", "flax", "optax", "orbax", "tensorstore")
               for m in sys.modules)
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
            assert not any(n.split(".")[0] in ("pandas", "jax", "flax", "optax", "orbax",
                                               "tensorstore", "face_mask_inpaint_tpu")
                           for n in names), f"{path}:{node.lineno} imports {names}"


COLLECTIVES_ALLOWED = {"all_reduce", "broadcast", "init_process_group", "destroy_process_group",
                       "is_available", "is_initialized"}


def test_parallel_package_imports_without_jax():
    """face_mask_inpaint_tpu_torch.parallel and its dist module import where
    jax, flax and the JAX package cannot, and are among the modules the
    probe above walks."""
    probe = PROBE.replace('importlib.import_module("chip_smoke")\n', "").replace(
        "print(len(names))",
        'print("face_mask_inpaint_tpu_torch.parallel.dist" in names, '
        'len([importlib.import_module("face_mask_inpaint_tpu_torch.parallel.dist")]))')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split()[-2:] == ["True", "1"]


def test_port_uses_only_all_reduce_and_broadcast():
    """Data parallel uses all-reduce and broadcast alone (gloo cannot
    all-gather CUDA tensors) and no DistributedDataParallel wrapper (the
    steps take their gradients with torch.autograd.grad): every use of
    torch.distributed in the port and chip_smoke.py is one of
    COLLECTIVES_ALLOWED."""
    files = sorted((REPO / "face_mask_inpaint_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    seen = set()
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        assert not any(isinstance(n, (ast.Name, ast.Attribute, ast.alias))
                       and "DistributedDataParallel" in ast.dump(n) for n in ast.walk(tree)), path
        aliases = {"torch.distributed"}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                aliases |= {a.asname for a in node.names
                            if a.name == "torch.distributed" and a.asname}
            elif isinstance(node, ast.ImportFrom) and node.module == "torch":
                aliases |= {a.asname or a.name for a in node.names if a.name == "distributed"}
            elif isinstance(node, ast.ImportFrom) and node.module == "torch.distributed":
                seen |= {a.name for a in node.names}
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and ast.unparse(node.value) in aliases:
                seen.add(node.attr)
    assert seen and seen <= COLLECTIVES_ALLOWED, seen - COLLECTIVES_ALLOWED
