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
    """A ``(rows, 72)`` uint32 wide-bucket table → an int32 tensor of the
    same bits on ``device`` (``EMPTY`` reads as -1)."""
    words = np.ascontiguousarray(table, np.uint32)
    return torch.from_numpy(words.view(np.int32).copy()).to(device)


def stream_index_from_jax(index, device: torch.device):
    """A reference ``StreamWindowIndex`` → the port's, on ``device``.

    The window keys and validity come across as they are (the reference's
    padded stream length included); the segment metadata is host NumPy
    in both packages.
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
        n_windows=index.n_windows)
