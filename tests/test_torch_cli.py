"""The port's CLI against the reference CLI: ``kmers`` and ``batch`` write
the same GTOs (annotation timestamps normalised), and the commands not yet
ported answer so with a non-zero exit."""

import json
import os
import subprocess
import sys

import pytest
import torch

from kmers_anno_tpu.commands.app import main as ref_main
from kmers_anno_tpu_torch.commands.app import main as port_main
from kmers_anno_tpu_torch.device import resolve_device
from tests.fixtures import make_projection_pair
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


def test_batch_data_parallel_is_not_yet_ported(tmp_path, capsys):
    d, cache, _ = _batch_setup(tmp_path, "dp")
    rc = port_main(["batch", "--device", "cpu", "--cache", cache,
                    "--data-parallel", "2", str(d / "batch.tbl")])
    assert rc != 0
    assert "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize("command", ["apply", "build", "hashAnno", "merge"])
def test_unported_command_says_so(command, capsys):
    assert port_main([command]) != 0
    assert "not yet ported" in capsys.readouterr().err


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
