"""The port stands alone: no module of ``kmers_anno_tpu_torch`` and not
``chip_smoke.py`` imports jax or anything of the JAX package
(``kmers_anno_tpu``), not even its jax-free host modules; the port keeps
its own copies of those.  Every module of the port imports with all three
blocked; that runs in a subprocess, because the test session itself has
imported jax (tests/conftest.py).
"""

import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("kmers_anno_tpu", "jax", "jaxlib")

SCRIPT = r"""
import importlib, pkgutil, sys

BLOCKED = %r

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"import of {name} is blocked")
        return None

sys.meta_path.insert(0, Block())
import kmers_anno_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    kmers_anno_tpu_torch.__path__, "kmers_anno_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print(len(names))
""" % (BLOCKED,)


def _run(script):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax():
    """Every module of the port imports with jax, jaxlib and the JAX
    package blocked."""
    got = _run(SCRIPT)
    assert got.returncode == 0, got.stderr
    assert int(got.stdout.split()[-1]) >= 40   # every module was imported


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


PORT_FILES = sorted(
    os.path.relpath(p, ROOT) for p in glob.glob(
        os.path.join(ROOT, "kmers_anno_tpu_torch", "**", "*.py"),
        recursive=True))


@pytest.mark.parametrize("path", ["chip_smoke.py"] + PORT_FILES)
def test_only_the_host_module_names_the_reference(path):
    """No file of the port names the JAX package or jax: the host modules
    the port needs are its own copies, under its own package."""
    named = [m for m in _imported_modules(os.path.join(ROOT, path))
             if m.split(".")[0] in BLOCKED]
    assert not named, f"{path} imports {named}"


def test_tune_malloc_runs_on_import():
    """Importing the port raises glibc's mmap and trim thresholds, as
    importing the JAX package does (kmers_anno_tpu/__init__.py), so the
    host row batches keep their pages without the reference imported."""
    script = SCRIPT.replace("import kmers_anno_tpu_torch\n", r'''
import ctypes
calls = []
_CDLL = ctypes.CDLL

class Libc:
    def mallopt(self, param, value):
        calls.append((param, value))
        return 1

def fake_cdll(name, *a, **kw):
    return Libc() if name is None else _CDLL(name, *a, **kw)

ctypes.CDLL = fake_cdll
import kmers_anno_tpu_torch
ctypes.CDLL = _CDLL
assert calls == [(-3, 1 << 30), (-1, 1 << 30)], calls
''', 1)
    got = _run(script)
    assert got.returncode == 0, got.stderr
