"""Carry state from the JAX reference's host and device arrays into the
port's tensors, so that both packages can be fed the same state.

Nothing here imports jax: the reference's device arrays are read through
``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch


def wide_table_from_numpy(table: np.ndarray,
                          device: torch.device) -> torch.Tensor:
    """A uint32 hash table (wide-bucket ``(rows, 72)`` or 8-slot
    ``(buckets, 24)``) → an int32 tensor of the same bits on ``device``
    (``EMPTY`` reads as -1)."""
    words = np.ascontiguousarray(table, np.uint32)
    return torch.from_numpy(words.view(np.int32).copy()).to(device)


def signature_table_from_reference(table):
    """A reference ``SignatureTable`` (host NumPy arrays, role ids,
    weights) → the port's, so that both packages apply one table."""
    from .signature import SignatureTable

    return SignatureTable(
        k=int(table.k),
        key_lo=np.array(table.key_lo, np.uint32),
        key_hi=np.array(table.key_hi, np.uint32),
        role_idx=np.array(table.role_idx, np.int32),
        role_ids=list(table.role_ids), alphabet=table.alphabet,
        weights=(None if table.weights is None
                 else np.array(table.weights, np.float32)),
        stats=dict(table.stats))


def stream_index_from_jax(index, device: torch.device):
    """A reference ``StreamWindowIndex`` → the port's, on ``device``.

    The window keys and validity come across as they are (the reference's
    padded stream length included); the segment metadata and the
    per-contig codes are host NumPy in both packages.
    """
    from .projection import StreamWindowIndex

    def tensor(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(device)

    return StreamWindowIndex(
        k=index.k, gc=index.gc,
        d_lo=tensor(index.d_lo, np.int32),
        d_hi=tensor(index.d_hi, np.int32),
        d_valid=tensor(index.d_valid, np.bool_),
        seg_start=np.array(index.seg_start, np.int64),
        seg_contig=np.array(index.seg_contig, np.int32),
        seg_strand=np.array(index.seg_strand, np.int8),
        seg_len=np.array(index.seg_len, np.int64),
        contig_ids=list(index.contig_ids),
        n_windows=index.n_windows,
        contig_codes=[np.array(c, np.uint8) for c in index.contig_codes])
