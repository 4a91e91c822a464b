"""The port's multi-process start-up (``parallel.distributed``) and the
mesh's process plumbing (``engine.mesh_apply._MeshPlumbing``).

The environment cases follow ``tests/test_distributed.py``, with torchrun's
names where the reference reads JAX's.  Two real processes on gloo (each
with its own timeout, so a rendezvous that hangs fails the test) join the
group, gather a host object in rank order, split a mesh's rows between
them and refuse a row whose members span both.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from kmers_anno_tpu.parallel.distributed import (
    distributed_env as ref_distributed_env)
from kmers_anno_tpu_torch.parallel import distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_no_coordinator_is_single_process():
    assert distributed.distributed_env({}) is None
    assert distributed.distributed_env({"KAN_NUM_PROCESSES": "4"}) is None
    assert distributed.distributed_env({"MASTER_ADDR": "h0"}) is None


def test_kan_vars_win():
    env = {"KAN_COORDINATOR": "10.0.0.1:1234",
           "MASTER_ADDR": "ignored", "MASTER_PORT": "1",
           "KAN_NUM_PROCESSES": "4", "KAN_PROCESS_ID": "2",
           "WORLD_SIZE": "9", "RANK": "7"}
    assert distributed.distributed_env(env) == {
        "coordinator_address": "10.0.0.1:1234",
        "num_processes": 4, "process_id": 2}


@pytest.mark.parametrize("env", [
    {"KAN_COORDINATOR": "10.0.0.1:1234", "KAN_NUM_PROCESSES": "4",
     "KAN_PROCESS_ID": "2"},
    {"KAN_COORDINATOR": "h0:999"},
    {"KAN_NUM_PROCESSES": "2"},
])
def test_kan_vars_as_the_reference_reads_them(env):
    assert distributed.distributed_env(env) == ref_distributed_env(env)


def test_torchrun_vars_stand_in_for_jax_vars():
    env = {"MASTER_ADDR": "h0", "MASTER_PORT": "999", "WORLD_SIZE": "2",
           "RANK": "1"}
    assert distributed.distributed_env(env) == {
        "coordinator_address": "h0:999", "num_processes": 2,
        "process_id": 1}
    # world size and rank left out, as the reference leaves them to
    # auto-detection
    assert distributed.distributed_env(
        {"MASTER_ADDR": "h0", "MASTER_PORT": "999"}) == {
        "coordinator_address": "h0:999"}


def test_single_process_needs_no_group():
    assert not distributed.maybe_init_distributed({})
    assert not dist.is_initialized()
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0
    assert distributed.is_primary()
    assert distributed.allgather({"a": 1}) == [{"a": 1}]


def test_a_coordinator_needs_the_world_size_and_rank():
    with pytest.raises(ValueError, match="KAN_NUM_PROCESSES"):
        distributed.maybe_init_distributed({"KAN_COORDINATOR": "h0:1"})
    assert not dist.is_initialized()


_WORKER = r"""
import torch
from kmers_anno_tpu_torch.engine.mesh_apply import _MeshPlumbing
from kmers_anno_tpu_torch.parallel import distributed

assert distributed.maybe_init_distributed()
assert distributed.maybe_init_distributed()      # idempotent
rank = distributed.process_index()
assert distributed.process_count() == 2
assert distributed.is_primary() == (rank == 0)
assert distributed.allgather(10 * rank) == [0, 10]
cpu = torch.device("cpu")
assert _MeshPlumbing(2, 2, [cpu, cpu]).rows_mine == [rank]
rows = _MeshPlumbing(3, 1, [cpu, cpu])
assert rows.rows_mine == ([0, 1] if rank == 0 else [2])
got = rows._host((torch.full((len(rows.rows_mine), 2), rank),))[0]
assert got.tolist() == [[0, 0], [0, 0], [1, 1]], got
for n_data, n_table, n_mine, message in (
        (1, 4, 2, "within one process"),
        (1, 1, 1 + rank, "same number of members")):
    try:
        _MeshPlumbing(n_data, n_table, [cpu] * n_mine)
    except ValueError as exc:
        assert message in str(exc), exc
    else:
        raise SystemExit(f"no error for {n_data}x{n_table}")
print("ok", rank)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, port: int) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["KAN_COORDINATOR"] = f"127.0.0.1:{port}"
    env["KAN_NUM_PROCESSES"] = "2"
    env["KAN_PROCESS_ID"] = str(rank)
    env["OMP_NUM_THREADS"] = "1"    # small work; the suite runs in parallel
    return env


def run_ranks(args: list[str], timeout: float = 120,
              outs: list[str] | None = None) -> list:
    """Start two processes, ranks 0 and 1, on a fresh port (an argument
    "{out}" becomes ``outs[rank]``), wait for each with a timeout (killing
    both on a hang), and return their (returncode, stdout, stderr)."""
    port = free_port()
    procs = [subprocess.Popen(
        [outs[rank] if a == "{out}" else a for a in args], cwd=ROOT,
        env=rank_env(rank, port), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def test_two_processes_share_the_mesh_rows():
    runs = run_ranks([sys.executable, "-c", _WORKER])
    for rank, (rc, out, err) in enumerate(runs):
        assert rc == 0, err[-3000:]
        assert out.split() == ["ok", str(rank)]
