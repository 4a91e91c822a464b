"""The DNA window probe: every valid k-mer window of a flat DNA code
stream looked up in the 8-slot table.

Counterpart of ``kmers_anno_tpu/engine/dna_apply.py``'s ``probe_dna_flat``
(:48-58), an XLA kernel on the TPU: ``pack_dna_windows`` then
``ops/hashtable.probe_table``.  The stream is the two strands of every
contig of a genome back to back (``engine.dna_apply.DnaContigBatch``), and
``valid`` says which window starts lie wholly inside one entry and hold no
ambiguous base.  A window that crosses from one entry into the next may
hold only unambiguous codes and is still invalid, so the probe honours
``valid`` as given and never derives it from the codes.

A CUDA tensor launches ``csrc/dna_probe.cu``: a block a tile of
``KERNEL_TILE`` window starts staged in shared memory, a rolling 2-bit
pack of each thread's run of windows, and the walk of
``bucket_probe.cuh`` (``kan_dna_probe``; ``kan_dna_probe_filtered`` with
the table's key filter, ``ops.key_filter``, in front of the walk, as
``DnaApplyEngine`` calls it).  A CPU tensor takes :func:`probe_dna_plain`,
the reference's composition in torch, which reads no filter: a Bloom
filter has no false negatives, so it changes no output.
"""

from __future__ import annotations

import torch

from .. import kernels
from .dna_kmers import _check_k, pack_dna_windows
from .hashtable import BUCKET, probe_table
from .key_filter import check_filter, filter_args
from .widetable import check_table

# window starts a block of the kernel takes (csrc/dna_probe.cu kTile)
KERNEL_TILE = 512


def _check_args(table, codes, valid, k, max_probes) -> None:
    check_table("probe_dna", 3 * BUCKET, table, max_probes)
    _check_k(k)
    if codes.dim() != 1 or codes.dtype != torch.uint8:
        raise ValueError("probe_dna: codes must be a (T,) uint8 tensor")
    if valid.dtype != torch.bool or valid.shape != codes.shape:
        raise ValueError("probe_dna: valid must be bool, shaped like codes")
    devs = {t.device for t in (table, codes, valid)}
    if len(devs) != 1:
        raise ValueError(f"probe_dna: arguments span devices {devs}")


def probe_dna_plain(table: torch.Tensor, codes: torch.Tensor,
                    valid: torch.Tensor, *, k: int,
                    max_probes: int) -> torch.Tensor:
    """Plain-PyTorch version of :func:`probe_dna`, on any device."""
    _check_args(table, codes, valid, k, max_probes)
    lo, hi = pack_dna_windows(codes, k)
    return probe_table(table, lo, hi, valid, max_probes)


def probe_dna(table: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor,
              *, k: int, max_probes: int,
              key_filter: torch.Tensor | None = None) -> torch.Tensor:
    """Probe every valid DNA kmer window of a flat code stream.

    table: (B, 24) int32, the uint32 words of ``hashtable.build_table``
    codes: (T,) uint8 DNA codes (``DNA_PAD`` padding)
    valid: (T,) bool window-start validity
    key_filter: (sectors, 8) int32, the table's key filter, or None
    returns (T,) int32: the payload of each window (a role index, or
    ``fp16_bits(weight) << 16 | role`` for a weighted table), -1 on a miss
    or an invalid window

    A CPU tensor takes :func:`probe_dna_plain`; a CUDA tensor launches the
    kernel or raises.
    """
    _check_args(table, codes, valid, k, max_probes)
    check_filter("probe_dna", key_filter, table)
    if table.device.type == "cpu":
        return probe_dna_plain(table, codes, valid, k=k,
                               max_probes=max_probes)
    if table.device.type != "cuda":
        raise ValueError(f"probe_dna: unsupported device {table.device}")
    for name, t in (("table", table), ("codes", codes), ("valid", valid),
                    ("key_filter", key_filter)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"probe_dna: {name} must be contiguous")
    if table.data_ptr() % 16 or (key_filter is not None
                                 and key_filter.data_ptr() % 16):
        raise ValueError("probe_dna: table and key_filter must be 16-byte "
                         "aligned")
    out = torch.empty(codes.shape, dtype=torch.int32, device=codes.device)
    if not codes.numel():
        return out
    lib = kernels.lib()
    args = (codes.data_ptr(), valid.data_ptr(), codes.numel(), k,
            out.data_ptr(), kernels.stream_of(table))
    with torch.cuda.device(table.device):
        if key_filter is None:
            err = lib.kan_dna_probe(table.data_ptr(), table.shape[0],
                                    max_probes, *args)
        else:
            err = lib.kan_dna_probe_filtered(
                table.data_ptr(), table.shape[0], max_probes,
                *filter_args(key_filter), *args)
    kernels.check(err, "probe_dna kernel")
    probe_dna.launches += 1
    return out


probe_dna.launches = 0
