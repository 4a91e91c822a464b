"""The kernel library's build, on the CPU (no nvcc needed): nvcc is given
only the ``.cu`` translation units, one process each, all started before
any is waited on, then one link; and the library counts as stale when any
``.cu`` source or ``.cuh`` header is newer than it."""

import os

import pytest

from kmers_anno_tpu_torch import kernels


def test_sources_are_the_cu_files_and_headers_are_inputs():
    sources = [os.path.basename(p) for p in kernels._sources()]
    inputs = [os.path.basename(p) for p in kernels._inputs()]
    assert sources and all(s.endswith(".cu") for s in sources)
    assert {"apply_rows.cu", "probe_wide.cu", "contig_scan.cu",
            "hash_chunk.cu", "apply_flat.cu", "dna_probe.cu",
            "probe_keys.cu"} <= set(sources)
    for header in ("wide_probe.cuh", "bucket_probe.cuh", "key_filter.cuh"):
        assert header in inputs and header not in sources
    assert set(sources) < set(inputs)
    # every header a source includes is an input
    for path in kernels._sources():
        for line in open(path, encoding="utf-8"):
            if line.startswith("#include \""):
                assert line.split('"')[1] in inputs


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("a.cu", "b.cuh"):
        (src / name).write_text("// source\n")
    lib = tmp_path / "libkan_cuda.so"
    monkeypatch.setattr(kernels, "SRC_DIR", str(src))
    monkeypatch.setattr(kernels, "LIB_PATH", str(lib))
    return src, lib


def _touch(path, when):
    path.write_text(path.read_text() if path.exists() else "")
    os.utime(path, (when, when))


@pytest.mark.parametrize("newer", [None, "a.cu", "b.cuh"])
def test_stale_watches_sources_and_headers(fake_tree, newer):
    src, lib = fake_tree
    assert kernels._stale()                     # no library yet
    for name in ("a.cu", "b.cuh"):
        _touch(src / name, 1_000_000)
    _touch(lib, 2_000_000)
    if newer:
        _touch(src / newer, 3_000_000)
    assert kernels._stale() == bool(newer)


class _FakeNvcc:
    """Stands in for ``subprocess``: records each command and when it was
    started and waited on, and writes the file named after ``-o``."""

    def __init__(self, fail=None):
        self.events = []
        self.fail = fail

    def _run(self, cmd):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "w") as fh:
            fh.write("built")
        return 1 if self.fail and self.fail in cmd[-1] else 0

    def popen(self, cmd, **kw):
        fake = self
        fake.events.append(("start", cmd))

        class Proc:
            returncode = None

            def communicate(self):
                fake.events.append(("wait", cmd))
                self.returncode = fake._run(cmd)
                return f"ptxas info for {os.path.basename(cmd[-1])}\n", None
        return Proc()

    def run(self, cmd, **kw):
        self.events.append(("link", cmd))

        class Done:
            returncode = self._run(cmd)
            stdout, stderr = "", ""
        return Done()


@pytest.mark.parametrize("fail", [None, "apply_rows.cu"])
def test_build_compiles_each_source_in_parallel_then_links(
        tmp_path, monkeypatch, fail):
    fake = _FakeNvcc(fail)
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(kernels, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(kernels, "LIB_PATH", str(build_dir / "lib.so"))
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "Popen", fake.popen)
    monkeypatch.setattr(kernels.subprocess, "run", fake.run)
    sources = kernels._sources()
    if fail:
        with pytest.raises(RuntimeError, match="apply_rows.cu"):
            kernels.build()
        assert not (build_dir / "lib.so").exists()
        assert not any(e[0] == "link" for e in fake.events)
    else:
        output = kernels.build()
        assert (build_dir / "lib.so").read_text() == "built"
        assert all(f"ptxas info for {os.path.basename(s)}" in output
                   for s in sources)
        link = fake.events[-1]
        assert link[0] == "link" and "-shared" in link[1]
        assert sum(a.endswith(".o") for a in link[1]) == len(sources)
    kinds = [e[0] for e in fake.events]
    n = len(sources)
    assert kinds[: 2 * n] == ["start"] * n + ["wait"] * n
    compiled = [e[1] for e in fake.events if e[0] == "start"]
    assert [c[-1] for c in compiled] == sources
    assert all("-c" in c and not any(a.endswith(".cuh") for a in c)
               for c in compiled)
    assert os.listdir(build_dir) in ([], ["lib.so"])   # objects removed


def test_build_of_another_tree_uses_its_own_paths(tmp_path, monkeypatch):
    """A build of another source tree compiles that tree's sources into
    its own library and leaves the default one alone."""
    fake = _FakeNvcc()
    monkeypatch.setattr(kernels, "LIB_PATH", str(tmp_path / "default.so"))
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "Popen", fake.popen)
    monkeypatch.setattr(kernels.subprocess, "run", fake.run)
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "x.cu").write_text("// source\n")
    lib = tmp_path / "other" / "lib.so"
    kernels.build(str(src), str(lib))
    compiled = [e[1] for e in fake.events if e[0] == "start"]
    assert [c[-1] for c in compiled] == [str(src / "x.cu")]
    assert not any(a.startswith("-D") for a in compiled[0])
    assert lib.read_text() == "built"
    assert not (tmp_path / "default.so").exists()
    assert kernels.build(str(src), str(lib)) == ""       # up to date
