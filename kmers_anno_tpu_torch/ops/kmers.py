"""Protein k-mer window packing (host NumPy and plain PyTorch).

Same bit layout as ``kmers_anno_tpu/ops/kmers.py``: 5 bits per residue,
residues 0..5 in ``lo`` and 6..11 in ``hi`` (K <= 12), so two kmers are
equal iff their (lo, hi) pairs are.  A packed word holds at most 30 bits,
so the torch versions keep it in ``int32`` without ever going negative
(torch has no ``<<`` on ``uint32``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..host import PROT_PAD

MAX_K = 12


def pack_kmers_np(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All length-k windows of a protein code array, packed 5 bits/char.

    codes: (L,) uint8; returns (lo, hi): (L-k+1,) uint32 each.
    Bit layout identical to :func:`pack_kmer_windows`.
    """
    if k > MAX_K:
        raise ValueError(f"protein kmer packing supports k <= 12, got {k}")
    n = len(codes) - k + 1
    if n <= 0:
        z = np.zeros(0, np.uint32)
        return z, z
    lo = np.zeros(n, np.uint32)
    hi = np.zeros(n, np.uint32)
    c = codes.astype(np.uint32)
    for j in range(k):
        w = c[j: j + n]
        if j < 6:
            lo |= w << np.uint32(5 * j)
        else:
            hi |= w << np.uint32(5 * (j - 6))
    return lo, hi


def pack_kmer_windows(codes: torch.Tensor,
                      k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack every length-k window of a protein-code array.

    codes: (..., L) uint8
    returns (lo, hi): (..., L) int32 — position i packs codes[i : i+k]
    (positions past L-k read PROT_PAD; mask them with a validity mask).
    """
    if k > MAX_K:
        raise ValueError(
            f"kmer size {k} > {MAX_K} not supported by 2x32-bit packing")
    length = codes.shape[-1]
    c = codes.to(torch.int32)
    pad = torch.full(codes.shape[:-1] + (k,), PROT_PAD, dtype=torch.int32,
                     device=codes.device)
    cp = torch.cat([c, pad], dim=-1)
    lo = torch.zeros(codes.shape, dtype=torch.int32, device=codes.device)
    hi = torch.zeros_like(lo)
    for j in range(k):
        w = cp[..., j: j + length]
        if j < 6:
            lo |= w << (5 * j)
        else:
            hi |= w << (5 * (j - 6))
    return lo, hi


def window_any(flags: torch.Tensor, k: int) -> torch.Tensor:
    """OR-reduce each length-k window: out[i] = any(flags[i : i+k])."""
    length = flags.shape[-1]
    pad = torch.zeros(flags.shape[:-1] + (k,), dtype=torch.bool,
                      device=flags.device)
    fp = torch.cat([flags, pad], dim=-1)
    out = torch.zeros(flags.shape, dtype=torch.bool, device=flags.device)
    for j in range(k):
        out |= fp[..., j: j + length]
    return out
