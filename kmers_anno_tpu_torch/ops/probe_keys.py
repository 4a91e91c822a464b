"""The key lookup of the mesh's table shards: packed keys looked up in one
8-slot table.

Counterpart of ``kmers_anno_tpu/ops/hashtable.py``'s ``probe_table``
(:186, XLA on the TPU) as the mesh steps call it
(``kmers_anno_tpu/parallel/mesh.py``): the broadcast-sharded step probes
every window's packed key against its member's shard, and the routed step
probes the keys its member received, which lie in owner-bucket order, not
in protein order.  So this lookup takes packed keys, not codes, in any
order; the flat apply kernels, which pack from codes and need their
proteins in order, cannot serve it.

A CUDA tensor launches ``csrc/probe_keys.cu`` (``kan_probe_keys``: one
thread a key, the shard's key filter, ``ops.key_filter``, in front of the
walk of ``bucket_probe.cuh``).  A CPU tensor takes :func:`probe_keys_plain`,
``ops.hashtable.probe_table``, which reads no filter: a Bloom filter has no
false negatives, so it changes no output.
"""

from __future__ import annotations

import torch

from .. import kernels
from .hashtable import BUCKET, probe_table
from .key_filter import check_filter, filter_args
from .widetable import check_table

EMPTY_KEY = -1      # EMPTY's int32 bits: a routed buffer's empty slot
KERNEL_TILE = 256    # keys a block of the kernel takes (kThreads)


def _check_args(table, lo, hi, valid, max_probes) -> None:
    check_table("probe_keys", 3 * BUCKET, table, max_probes)
    if lo.dtype != torch.int32 or hi.dtype != torch.int32:
        raise ValueError("probe_keys: lo and hi must be int32 keys")
    if lo.shape != hi.shape:
        raise ValueError("probe_keys: lo and hi must have one shape")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != lo.shape):
        raise ValueError("probe_keys: valid must be bool, shaped like lo")
    devs = {t.device for t in (table, lo, hi, valid) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"probe_keys: arguments span devices {devs}")


def probe_keys_plain(table: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, valid: torch.Tensor | None, *,
                     max_probes: int) -> torch.Tensor:
    """Plain-PyTorch version of :func:`probe_keys`, on any device."""
    _check_args(table, lo, hi, valid, max_probes)
    if valid is None:
        valid = lo != EMPTY_KEY
    return probe_table(table, lo, hi, valid, max_probes)


def probe_keys(table: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
               valid: torch.Tensor | None, *, max_probes: int,
               key_filter: torch.Tensor | None = None) -> torch.Tensor:
    """Look up packed keys in an 8-slot table.

    table: (B, 24) int32, the uint32 words of ``hashtable.build_table``
    lo, hi: (...,) int32 packed keys
    valid: (...,) bool, or None: valid where ``lo != EMPTY`` (a routed
    buffer's empty slots)
    key_filter: (sectors, 8) int32, the table's key filter, or None
    returns (...,) int32: the payload under each key, -1 on a miss or an
    invalid key

    A CPU tensor takes :func:`probe_keys_plain`; a CUDA tensor launches
    the kernel or raises.
    """
    _check_args(table, lo, hi, valid, max_probes)
    check_filter("probe_keys", key_filter, table)
    if table.device.type == "cpu":
        return probe_keys_plain(table, lo, hi, valid, max_probes=max_probes)
    if table.device.type != "cuda":
        raise ValueError(f"probe_keys: unsupported device {table.device}")
    for name, t in (("table", table), ("lo", lo), ("hi", hi),
                    ("valid", valid), ("key_filter", key_filter)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"probe_keys: {name} must be contiguous")
    if table.data_ptr() % 16 or (key_filter is not None
                                 and key_filter.data_ptr() % 16):
        raise ValueError("probe_keys: table and key_filter must be 16-byte "
                         "aligned")
    out = torch.empty(lo.shape, dtype=torch.int32, device=lo.device)
    if not lo.numel():
        return out
    with torch.cuda.device(table.device):
        err = kernels.lib().kan_probe_keys(
            table.data_ptr(), table.shape[0], max_probes,
            *filter_args(key_filter), lo.data_ptr(), hi.data_ptr(),
            None if valid is None else valid.data_ptr(), lo.numel(),
            out.data_ptr(), kernels.stream_of(table))
    kernels.check(err, "probe_keys kernel")
    probe_keys.launches += 1
    return out


probe_keys.launches = 0
