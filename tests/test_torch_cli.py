"""The port's CLI against the reference CLI: ``kmers`` and ``batch`` write
the same GTOs (annotation timestamps normalised), ``build`` the same kmer
database and ``apply`` the same reports, byte for byte; the commands not
yet ported answer so with a non-zero exit."""

import json
import os
import subprocess
import sys

import pytest
import torch

from kmers_anno_tpu.commands.app import main as ref_main
from kmers_anno_tpu.engine import protein_kmers as ref_pk
from kmers_anno_tpu_torch.commands.app import main as port_main
from kmers_anno_tpu_torch.device import resolve_device
from kmers_anno_tpu_torch.engine import protein_kmers as port_pk
from tests.fixtures import (make_genome, make_projection_pair,
                            random_protein, write_role_files)
from tests.test_fused_scan import _workload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _normalized(path):
    d = json.load(open(path))
    for f in d["features"]:
        for a in f.get("annotations", []):
            a[2] = 0  # the epoch timestamp is the one run-varying field
    return d


def _kmers_setup(tmp_path):
    new_g, olds = _workload()
    cache = tmp_path / "cache"
    cache.mkdir()
    for gid, og in olds.items():
        og.save(str(cache / f"{gid}.gto"))
    new_path = tmp_path / "new.gto"
    new_g.save(str(new_path))
    return str(cache), str(new_path)


def test_kmers_cli_matches_reference(tmp_path):
    cache, new_path = _kmers_setup(tmp_path)
    ref_out = str(tmp_path / "ref.gto")
    port_out = str(tmp_path / "port.gto")
    args = ["kmers", "--cache", cache, "-i", new_path, "--trace",
            "Projected role number 3"]
    assert ref_main(args + ["-o", ref_out]) == 0
    env = dict(os.environ, KMERS_ANNO_LOG="off")
    got = subprocess.run(
        [sys.executable, "-m", "kmers_anno_tpu_torch", *args,
         "--device", "cpu", "-o", port_out],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr
    assert "Proposal stored using" in got.stderr
    want = _normalized(ref_out)
    assert _normalized(port_out) == want
    assert len(want["features"]) > 0


def _batch_setup(tmp_path, tag):
    d = tmp_path / tag
    d.mkdir()
    cache = d / "cache"
    cache.mkdir()
    jobs = []
    for i in range(3):
        new_g, olds = make_projection_pair(seed=200 + i, n_genes=8,
                                           new_id=f"41{i}.1",
                                           old_id=f"31{i}.1")
        new_g.save(str(d / f"in{i}.gto"))
        for gid, og in olds.items():
            og.save(str(cache / f"{gid}.gto"))
        jobs.append((f"in{i}.gto", f"out{i}.gto"))
    (d / "batch.tbl").write_text("".join(f"{a}\t{b}\n" for a, b in jobs))
    return d, str(cache), [str(d / b) for _, b in jobs]


def test_batch_cli_matches_reference(tmp_path):
    d1, cache1, outs1 = _batch_setup(tmp_path, "ref")
    assert ref_main(["batch", "--cache", cache1,
                     str(d1 / "batch.tbl")]) == 0
    d2, cache2, outs2 = _batch_setup(tmp_path, "port")
    assert port_main(["batch", "--device", "cpu", "--cache", cache2,
                      str(d2 / "batch.tbl")]) == 0
    for a, b in zip(outs1, outs2):
        want = _normalized(a)
        assert _normalized(b) == want
        assert len(want["features"]) > 0


def test_batch_data_parallel_is_not_yet_ported(tmp_path):
    """``batch --data-parallel 2`` now runs two CPU lanes and writes the
    sequential run's GTOs."""
    d1, cache1, outs1 = _batch_setup(tmp_path, "seq")
    assert port_main(["batch", "--device", "cpu", "--cache", cache1,
                      str(d1 / "batch.tbl")]) == 0
    d2, cache2, outs2 = _batch_setup(tmp_path, "dp")
    assert port_main(["batch", "--device", "cpu", "--cache", cache2,
                      "--data-parallel", "2", str(d2 / "batch.tbl")]) == 0
    for a, b in zip(outs1, outs2):
        assert _normalized(b) == _normalized(a)


@pytest.mark.parametrize("command", ["genes", "funApply", "compare",
                                     "merge"])
def test_unported_command_says_so(command, capsys):
    """These four commands are ported now: with no arguments each stops
    with its usage error (argparse's exit code 2), as the reference's
    does, and no message says "not yet ported"."""
    with pytest.raises(SystemExit) as got:
        port_main([command])
    assert got.value.code == 2
    err = capsys.readouterr().err
    assert f"usage: kmers_anno_tpu_torch {command}" in err
    assert "the following arguments are required" in err
    assert "not yet ported" not in err


def test_help_lists_every_reference_command(capsys):
    from kmers_anno_tpu.commands.app import COMMANDS

    assert port_main(["-h"]) == 0
    err = capsys.readouterr().err
    assert all(name in err for name in COMMANDS)
    assert port_main(["noSuchCommand"]) == 2


def test_cuda_without_cuda_raises(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    cache, new_path = _kmers_setup(tmp_path)
    rc = port_main(["kmers", "--cache", cache, "-i", new_path,
                    "-o", str(tmp_path / "out.gto")])   # default: cuda
    assert rc != 0
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "out.gto").exists()


def _signature_setup(tmp_path):
    """Three genomes (one carries a protein under two roles, so kmers are
    pruned; every genome has kill-list pegs) and the role files."""
    import random

    shared = random_protein(random.Random(999), 70)
    gto_dir = tmp_path / "gtos"
    gto_dir.mkdir()
    for i in range(3):
        make_genome(f"100{i}.1", seed=i,
                    shared_protein=shared if i == 0 else None).save(
                        str(gto_dir / f"100{i}.1.gto"))
    role_file, use_file = write_role_files(tmp_path)
    return str(gto_dir), role_file, use_file


BUILD_APPLY_CASES = {
    "apply": ([], ["-m", "1"]),
    "verify": ([], ["--format", "VERIFY", "-m", "5"]),
    "verify_k12_binary": (["-K", "12"], ["--format", "VERIFY", "-m", "2"]),
    "weighted": (["--weights", "balance"],
                 ["--weighted", "--format", "VERIFY", "--min-weight", "2"]),
    "drop_last": (["--dropLast"], ["--dropLast", "--format", "VERIFY",
                                   "-m", "3"]),
}


@pytest.mark.parametrize("case", list(BUILD_APPLY_CASES))
def test_build_apply_cli_matches_reference(tmp_path, case):
    """build, then apply, through both CLIs: the kmer databases and the
    reports are byte-identical."""
    gto_dir, role_file, use_file = _signature_setup(tmp_path)
    build_opts, apply_opts = BUILD_APPLY_CASES[case]
    suffix = ".kdb" if case.endswith("binary") else ".tbl"
    try:
        outs = {}
        for name, main, extra in (("ref", ref_main, []),
                                  ("port", port_main, ["--device", "cpu"])):
            db = str(tmp_path / f"{name}{suffix}")
            report = str(tmp_path / f"{name}.report")
            assert main(["build", *build_opts, *extra, "-o", db, role_file,
                         use_file, gto_dir]) == 0
            assert main(["apply", *apply_opts, *extra, "-o", report, db,
                         use_file, gto_dir]) == 0
            outs[name] = (open(db, "rb").read(), open(report, "rb").read())
    finally:
        ref_pk.set_drop_last(False)
        port_pk.set_drop_last(False)
    if suffix == ".tbl":
        assert outs["port"][0] == outs["ref"][0]
        assert len(outs["ref"][0].splitlines()) > 100
    assert outs["port"][1] == outs["ref"][1]
    lines = outs["ref"][1].decode().splitlines()
    if case == "apply":
        assert len(lines) == 3 and any(
            int(c) for line in lines for c in line.split("\t")[1:])
    else:
        assert lines[0].startswith("genome_id") and len(lines) > 3


@pytest.mark.parametrize("command,args,message", [
    ("apply", ["--mesh", "4y2"],
     "bad mesh spec '4y2'; expected DATAxTABLE, e.g. 4x2"),
])
def test_unported_options_say_so(tmp_path, capsys, command, args, message):
    """An option the port takes but cannot run as given fails with the
    reference's message: since the mesh is ported, a bad mesh spec."""
    gto_dir, role_file, use_file = _signature_setup(tmp_path)
    db = tmp_path / "db.tbl"
    db.write_text("ACDEFGHI\tRoleA\n")
    files = ([str(db), use_file] if command == "apply"
             else [role_file, use_file])
    assert port_main([command, *args, "--device", "cpu", *files,
                      gto_dir]) != 0
    err = capsys.readouterr().err
    assert message in err and "not yet ported" not in err
    assert ref_main([command, *args, *files, gto_dir]) != 0
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("command", ["build", "apply"])
def test_build_apply_default_cuda_without_cuda(monkeypatch, tmp_path,
                                               capsys, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gto_dir, role_file, use_file = _signature_setup(tmp_path)
    db = tmp_path / "db.tbl"
    db.write_text("ACDEFGHI\tRoleA\n")
    out = tmp_path / "out"
    files = ([str(db), use_file] if command == "apply"
             else [role_file, use_file])
    assert port_main([command, "-o", str(out), *files, gto_dir]) != 0
    assert "CUDA is not available" in capsys.readouterr().err
    assert not out.exists()


def test_weighted_balance_report_bytes_match_reference(tmp_path):
    """F3 at a few thousand proteins: ``build --weights balance`` then
    ``apply --weighted --format VERIFY`` on two synthetic genomes of 1,310
    pegs (non-integer fp16 weights, tallies printed to four places): the
    port's report differs from the reference CLI's in no byte."""
    import numpy as np

    from chip_smoke import make_signature_genomes

    genomes, role_map = make_signature_genomes(np.random.default_rng(3), 2,
                                               700, 600, 10)
    gto_dir = tmp_path / "gtos"
    gto_dir.mkdir()
    for g in genomes:
        g.save(str(gto_dir / f"{g.id}.gto"))
    role_file, use_file = str(tmp_path / "roles"), str(tmp_path / "use")
    role_map.save(role_file)
    with open(use_file, "w") as fh:
        fh.writelines(f"{rid}\n" for rid in role_map.ids())
    reports = {}
    for name, main, extra in (("ref", ref_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        db, report = str(tmp_path / f"{name}.tbl"), str(tmp_path / name)
        assert main(["build", "--weights", "balance", *extra, "-o", db,
                     role_file, use_file, str(gto_dir)]) == 0
        assert main(["apply", "--weighted", "--format", "VERIFY",
                     "--min-weight", "2", *extra, "-o", report, db,
                     use_file, str(gto_dir)]) == 0
        reports[name] = open(report, "rb").read()
    want, got = reports["ref"], reports["port"]
    differing = sum(a != b for a, b in zip(want, got)) + abs(
        len(want) - len(got))
    assert differing == 0
    lines = want.decode().splitlines()
    assert len(lines) > 1000
    assert any(float(line.split("\t")[3]) % 1 for line in lines[1:])
