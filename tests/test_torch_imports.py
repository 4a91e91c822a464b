"""The port never imports jax: every module of ``kmers_anno_tpu_torch``
imports with ``import jax`` blocked.  Runs in a subprocess, because the
test session itself has imported jax (tests/conftest.py).

The port reaches the reference package's jax-free host modules only
through ``kmers_anno_tpu_torch/host.py``, and ``chip_smoke.py`` imports
nothing of the reference package at all.
"""

import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"import of {name} is blocked")
        return None

sys.meta_path.insert(0, BlockJax())
import kmers_anno_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    kmers_anno_tpu_torch.__path__, "kmers_anno_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    got = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr
    assert int(got.stdout.split()[-1]) >= 15   # every module was imported


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


def _names_reference(module):
    return module.split(".")[0] in ("kmers_anno_tpu", "jax", "jaxlib")


PORT_FILES = sorted(
    os.path.relpath(p, ROOT) for p in glob.glob(
        os.path.join(ROOT, "kmers_anno_tpu_torch", "**", "*.py"),
        recursive=True)
    if not p.endswith(os.path.join("kmers_anno_tpu_torch", "host.py")))


@pytest.mark.parametrize("path", ["chip_smoke.py"] + PORT_FILES)
def test_only_the_host_module_names_the_reference(path):
    named = [m for m in _imported_modules(os.path.join(ROOT, path))
             if _names_reference(m)]
    assert not named, f"{path} imports {named}"


def test_host_module_imports_only_the_reference():
    """host.py names reference modules and nothing else; that they load
    without jax is what test_port_imports_without_jax shows."""
    host = os.path.join(ROOT, "kmers_anno_tpu_torch", "host.py")
    modules = list(_imported_modules(host))
    assert modules
    assert all(m.split(".")[0] == "kmers_anno_tpu" for m in modules)
