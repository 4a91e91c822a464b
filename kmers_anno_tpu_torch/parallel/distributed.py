"""Multi-process start-up for the mesh (``torch.distributed`` on gloo).

Counterpart of ``kmers_anno_tpu/parallel/distributed.py``.  Every process
runs the same program; ``maybe_init_distributed`` joins them into one
process group before any mesh is built.  The group carries only host
exchanges: the count of members each process contributes, at start-up,
and the allgather of each data row's results (``engine.mesh_apply``).
Every table-axis exchange stays among one process's own members, as the
reference requires (``engine/mesh_apply.py:86-102``), so nothing on a
card crosses a process and the backend is gloo.  NCCL is not used: it
would carry no traffic, and it refuses two ranks on one card, the way
this package proves a two-process mesh on a one-card machine.

Configuration, read from the environment:

* ``KAN_COORDINATOR`` — "host:port" of process 0; without it,
  torchrun's ``MASTER_ADDR`` and ``MASTER_PORT``.  Neither set:
  single-process mode, nothing to do.
* ``KAN_NUM_PROCESSES`` (or ``WORLD_SIZE``) — the number of processes.
* ``KAN_PROCESS_ID`` (or ``RANK``) — this process's rank.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch.distributed as dist

log = logging.getLogger(__name__)

# how long a process waits for the others, at start-up and at each
# exchange, before the run fails
TIMEOUT = datetime.timedelta(minutes=10)


def distributed_env(environ=None) -> dict | None:
    """The process group's configuration from the environment: None in
    single-process mode, else a dict with ``coordinator_address`` and,
    where set, ``num_processes`` and ``process_id``."""
    env = os.environ if environ is None else environ

    def pick(*names):
        for n in names:
            v = env.get(n)
            if v:
                return v
        return None

    coord = pick("KAN_COORDINATOR")
    if coord is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coord = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coord is None:
        return None
    config: dict = {"coordinator_address": coord}
    n = pick("KAN_NUM_PROCESSES", "WORLD_SIZE")
    if n is not None:
        config["num_processes"] = int(n)
    pid = pick("KAN_PROCESS_ID", "RANK")
    if pid is not None:
        config["process_id"] = int(pid)
    return config


def maybe_init_distributed(environ=None) -> bool:
    """Join the process group when a coordinator is configured.

    Idempotent; returns True iff running multi-process after the call.
    Must run before any mesh is built."""
    if dist.is_initialized():
        return True
    config = distributed_env(environ)
    if config is None:
        return False
    if "num_processes" not in config or "process_id" not in config:
        raise ValueError("a coordinator needs KAN_NUM_PROCESSES and "
                         "KAN_PROCESS_ID (or WORLD_SIZE and RANK)")
    log.info("Joining the process group: %s", config)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{config['coordinator_address']}",
        world_size=config["num_processes"], rank=config["process_id"],
        timeout=TIMEOUT)
    log.info("Process group up: process %d of %d.", dist.get_rank(),
             dist.get_world_size())
    return True


def process_count() -> int:
    """Processes in the group; 1 when not initialised."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 when not initialised."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes reports (rank 0).  Every process
    of a mesh run holds the same allgathered results; only the primary
    writes them, as the reference's single JVM writes one report."""
    return process_index() == 0


def allgather(obj) -> list:
    """Every process's ``obj``, in rank order (a host exchange on gloo);
    ``[obj]`` in single-process mode."""
    if process_count() == 1:
        return [obj]
    out: list = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
