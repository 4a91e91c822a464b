"""The port's multi-device CLI paths against the reference CLI, on the CPU.

``apply --mesh`` (replicated, pmax and routed, weighted, DNA) on virtual
CPU members writes the reference CLI's report with the same ``--mesh``
and the port's own single-device report, byte for byte; ``batch
--data-parallel 3`` and ``hashAnno --data-parallel 3`` write the
sequential run's files and the reference's (the cases of
``tests/test_fused_scan.py`` and ``tests/test_hashanno.py``); and the
lanes (``parallel.lanes``) count and re-raise as the reference does.
"""

import json
import logging
import os
import sys
import threading

import pytest
import torch

from kmers_anno_tpu.commands.app import main as ref_main
from kmers_anno_tpu_torch.commands.app import main as port_main
from kmers_anno_tpu_torch.parallel import lanes
from tests.fixtures import ROLE_DEFS, make_genome, write_role_files
from tests.test_dna_mode import make_dna_genome
from tests.test_fused_scan import _batch_setup
from tests.test_torch_mesh import one_thread  # noqa: F401 (autouse)

K = 8


def _read(path):
    return open(path, "rb").read()


@pytest.fixture(scope="module")
def protein_db(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cli")
    gto_dir = tmp / "gtos"
    gto_dir.mkdir()
    for i in range(6):
        make_genome(f"310{i}.1", seed=900 + i).save(
            str(gto_dir / f"310{i}.1.gto"))
    role_file, use_file = write_role_files(tmp)
    dbs = {}
    for weights in ("none", "balance"):
        dbs[weights] = str(tmp / f"kmerdb.{weights}.tbl")
        assert ref_main(["build", "-K", str(K), "--weights", weights, "-o",
                         dbs[weights], role_file, use_file,
                         str(gto_dir)]) == 0
    return tmp, dbs, use_file, str(gto_dir)


def _apply_both(tmp, tag, args, mesh):
    """The port's report with and without ``mesh``, and the reference's
    with it."""
    out = {}
    for name, main, extra in (("port", port_main, ["--device", "cpu", *mesh]),
                              ("single", port_main, ["--device", "cpu"]),
                              ("ref", ref_main, mesh)):
        out[name] = str(tmp / f"{tag}.{name}.tbl")
        assert main(["apply", *args, *extra, "-o", out[name]]) == 0
    return {n: _read(p) for n, p in out.items()}


@pytest.mark.parametrize("mesh", [
    ["--mesh", "8x1"],
    ["--mesh", "4x2"],
    ["--mesh", "4x2", "--table-mode", "pmax"],
    ["--mesh", "2x4", "--capacity-factor", "1.5"],
    ["--mesh", "2x4", "--capacity-factor", "0.01"],
])
def test_cli_mesh_report_matches_reference(protein_db, mesh):
    tmp, dbs, use_file, gto_dir = protein_db
    got = _apply_both(tmp, "_".join(mesh[1:]).replace(".", ""), [
        "--format", "VERIFY", "-m", "1", dbs["none"], use_file, gto_dir],
        mesh)
    assert got["port"] == got["single"] == got["ref"]
    assert got["port"].count(b"\n") > 20


@pytest.mark.parametrize("mesh", [
    ["--mesh", "8x1"],
    ["--mesh", "4x2"],
    ["--mesh", "4x2", "--table-mode", "pmax"],
])
def test_cli_weighted_mesh_matches_reference(protein_db, mesh):
    tmp, dbs, use_file, gto_dir = protein_db
    got = _apply_both(tmp, "w_" + "_".join(mesh[1:]), [
        "--format", "VERIFY", "-m", "1", "--weighted", "--min-weight", "0.5",
        dbs["balance"], use_file, gto_dir], mesh)
    assert got["port"] == got["single"] == got["ref"]
    assert got["port"].count(b"\n") > 20


def test_cli_dna_mesh_matches_reference(tmp_path):
    gto_dir = tmp_path / "gtos"
    gto_dir.mkdir()
    for i in range(5):
        specs = [(name, 300 + 30 * j, "+" if (i + j) % 2 else "-")
                 for j, (rid, name) in enumerate(ROLE_DEFS[:4])]
        make_dna_genome(f"88{i}.1", seed=700 + i, cds_specs=specs).save(
            str(gto_dir / f"88{i}.1.gto"))
    role_file, use_file = write_role_files(tmp_path)
    db = str(tmp_path / "kmerdb.tbl")
    assert ref_main(["build", "-K", str(K), "--dna", "-o", db, role_file,
                     use_file, str(gto_dir)]) == 0
    for mesh in (["--mesh", "8x1"], ["--mesh", "4x2"]):
        got = _apply_both(tmp_path, mesh[1], [
            "--format", "VERIFY", "-m", "3", db, use_file, str(gto_dir)],
            mesh)
        assert got["port"] == got["single"] == got["ref"]
        assert got["port"].count(b".region.") > 10


def test_cli_mesh_refuses_a_single_card(protein_db, capsys):
    tmp, dbs, use_file, gto_dir = protein_db
    assert port_main(["apply", "--mesh", "2x1", "--device", "cuda:0",
                      dbs["none"], use_file, gto_dir]) != 0
    assert "--mesh names its own members" in capsys.readouterr().err


def _normalized(path):
    d = json.load(open(path))
    for f in d["features"]:
        for a in f.get("annotations", []):
            a[2] = 0  # the epoch timestamp is the one run-varying field
    return d


def test_batch_data_parallel_matches_sequential_and_reference(tmp_path):
    """``batch --data-parallel 3`` over 6 genomes: three CPU lanes, the
    sequential run's GTOs and the reference's ``--data-parallel 3``
    (tests/test_fused_scan.py:133-146)."""
    runs = {}
    for tag, main, extra in (
            ("seq", port_main, ["--device", "cpu"]),
            ("par", port_main, ["--device", "cpu", "--data-parallel", "3"]),
            ("ref", ref_main, ["--data-parallel", "3"])):
        d, cache, outs = _batch_setup(tmp_path, tag)
        assert main(["batch", "--cache", str(cache), *extra,
                     str(d / "batch.tbl")]) == 0
        runs[tag] = [_normalized(p) for p in outs]
    assert runs["par"] == runs["seq"] == runs["ref"]
    assert all(g["features"] for g in runs["seq"])


def test_hash_anno_data_parallel_matches_sequential_and_reference(tmp_path):
    """``hashAnno --batch 2 --data-parallel 3`` over 6 genomes (3 batches,
    3 lanes): the sequential run's files byte for byte, and the
    reference's ``--data-parallel 3`` (tests/test_hashanno.py:251-280)."""
    gto_dir = tmp_path / "gtos"
    gto_dir.mkdir()
    genomes = [make_genome(f"80{i}.1", seed=60 + i, n_per_role=2)
               for i in range(6)]
    for g in genomes:
        g.save(str(gto_dir / f"{g.id}.gto"))
    pegs = [f for f in genomes[0].pegs if f.protein_translation]
    anno_file = str(tmp_path / "annos.tbl")
    with open(anno_file, "w") as fh:
        fh.write("protein\tannotation\n")
        fh.write(f"{pegs[0].protein_translation}\t{pegs[0].peg_function}\n")
        fh.write(f"{pegs[1].protein_translation}\tShiny new function\n")
    outs = {}
    for tag, main, extra in (
            ("seq", port_main, ["--device", "cpu"]),
            ("par", port_main, ["--device", "cpu", "--data-parallel", "3"]),
            ("ref", ref_main, ["--data-parallel", "3"])):
        out = str(tmp_path / tag)
        assert main(["hashAnno", "-K", str(K), "-D", out, "--minLen", "10",
                     "--batch", "2", *extra, anno_file, str(gto_dir)]) == 0
        outs[tag] = {n: _read(os.path.join(out, n))
                     for n in sorted(os.listdir(out))}
    assert len(outs["seq"]) == 7
    assert outs["par"] == outs["seq"] == outs["ref"]
    assert outs["seq"]["changes.tbl"].count(b"\n") > 1


class _Lines(logging.Handler):
    """The messages of the hashAnno command's logger (the CLI reconfigures
    the root logger, so pytest's capture does not see them)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger = logging.getLogger(
            "kmers_anno_tpu_torch.commands.hash_anno_cmd")
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def test_hash_anno_lanes_under_thread_switches(tmp_path):
    """Stress: 12 lanes, one a genome, more threads than this test's
    cores, with the interpreter switching threads every microsecond.  The
    lanes' shared state (the changes gathered a genome, the totals) loses
    no update: the files equal the sequential run's, and so do the logged
    totals."""
    gto_dir = tmp_path / "gtos"
    gto_dir.mkdir()
    genomes = [make_genome(f"81{i:02d}.1", seed=90 + i, n_per_role=1)
               for i in range(12)]
    for g in genomes:
        g.save(str(gto_dir / f"{g.id}.gto"))
    pegs = [f for f in genomes[0].pegs if f.protein_translation]
    anno_file = str(tmp_path / "annos.tbl")
    with open(anno_file, "w") as fh:
        fh.write("protein\tannotation\n")
        fh.write(f"{pegs[0].protein_translation}\tShiny new function\n")
    outs, totals = {}, {}
    switch = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        for dp in ("1", "12"):
            out = str(tmp_path / f"dp{dp}")
            with _Lines() as lines:
                assert port_main(["hashAnno", "--device", "cpu", "-K",
                                  str(K), "-D", out, "--minLen", "10",
                                  "--batch", "1", "--data-parallel", dp,
                                  anno_file, str(gto_dir)]) == 0
            outs[dp] = {n: _read(os.path.join(out, n))
                        for n in sorted(os.listdir(out))}
            totals[dp] = [m for m in lines.messages
                          if "total proteins" in m
                          or "annotations confirmed" in m]
    finally:
        sys.setswitchinterval(switch)
    assert len(outs["1"]) == 13 and outs["12"] == outs["1"]
    assert len(totals["1"]) == 2 and totals["12"] == totals["1"]


def test_lane_devices(monkeypatch):
    cpu = torch.device("cpu")
    assert lanes.lane_devices(cpu, 3, 6) == [cpu] * 3
    assert lanes.lane_devices(cpu, 8, 2) == [cpu] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = torch.device("cuda", 0)
    assert lanes.lane_devices(cuda, 3, 6) == [torch.device("cuda", 0),
                                              torch.device("cuda", 1)]
    assert lanes.lane_devices(cuda, 3, 1) == [torch.device("cuda", 0)]


def test_run_lanes_runs_each_lane_in_its_own_thread():
    """The three lanes run at once (each waits at a barrier for the other
    two, which would time out in one thread), none in the caller's."""
    barrier = threading.Barrier(3, timeout=30)
    seen = {}

    def lane(i):
        seen[i] = threading.get_ident()
        barrier.wait()

    lanes.run_lanes([torch.device("cpu")] * 3, lane)
    assert sorted(seen) == [0, 1, 2] and len(set(seen.values())) == 3
    assert threading.get_ident() not in seen.values()


def test_run_lanes_raises_a_lanes_error():
    def lane(i):
        if i == 1:
            raise KeyError("lane 1 failed")

    with pytest.raises(KeyError, match="lane 1 failed"):
        lanes.run_lanes([torch.device("cpu")] * 3, lane)
