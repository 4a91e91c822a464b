"""What the benchmark loads: never JAX or the JAX package (top-level names
compared whole: ``kmers_anno_tpu_torch`` is the port and allowed), and a
reference that imports nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

SCRIPT = """
import sys
from kanbench import run, trace
from kanbench.tests.small import WARM, WEIGHTED, run_small
class MP:
    def setattr(self, obj, attr, value):
        setattr(obj, attr, value)
for w in (WARM, "apply10m_stream", WEIGHTED):
    run_small(MP(), w, seconds=0.5, trace=True)
for kind in ("metrics", "counts"):
    for p in sorted((trace.HERE / kind).glob("[!_]*.py")):
        trace.load_module(kind, p.stem)
import kanbench.control
print("forbidden:" + ",".join(run.forbidden_modules()))
"""


def test_no_jax_in_a_run():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "forbidden:", out.stdout


def test_forbidden_names_compared_whole(monkeypatch):
    from kanbench import run

    monkeypatch.setitem(sys.modules, "kmers_anno_tpu_torch_fake", sys)
    assert "kmers_anno_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in run.forbidden_modules()


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    files = sorted((HERE / "reference").glob("*.py"))
    assert files
    for path in files:
        got = _imports(path)
        assert not got & {"kmers_anno_tpu_torch", "kmers_anno_tpu", "jax",
                          "jaxlib", "flax"}, (path.name, got)
        assert got <= {"__future__", "numpy", "torch"}, (path.name, got)


def test_no_source_imports_jax():
    for path in sorted(HERE.rglob("*.py")):
        got = _imports(path)
        assert not got & {"kmers_anno_tpu", "jax", "jaxlib", "flax"}, \
            (path, got)
