"""Nucleotide k-mer window packing and validity masks (host NumPy and
plain PyTorch).

Counterpart of ``kmers_anno_tpu/ops/dna_kmers.py``.  DNA mode packs each
k-mer into 2 bits a base (t,c,a,g → 0..3, the ``ops.encode`` DNA codes)
plus a marker bit at position 2k, all in the ``lo`` key word:

    lo = (1 << 2k) | sum(base[i] << 2i),   hi = 0

For k ≤ 15 every key is below 2^31, so it can never equal the EMPTY slot
sentinel (0xFFFFFFFF; a poly-G 16-mer would), the torch versions hold it
in ``int32`` without a sign, as ``ops.kmers`` holds protein keys; keys of
different k never compare equal (the marker moves).  Two k-mers are equal
iff their (lo, hi) pairs are, so the 8-slot table of ``ops.hashtable``
serves both alphabets.  The reverse complement in code space is
``code XOR 2``.

Unlike protein windows, DNA windows have no drop-last quirk: all L-k+1
windows of a sequence count.
"""

from __future__ import annotations

import numpy as np
import torch

from .encode import DNA_AMBIG

DNA_MIN_K = 4
DNA_MAX_K = 15


def _check_k(k: int) -> None:
    if not DNA_MIN_K <= k <= DNA_MAX_K:
        raise ValueError(
            f"DNA kmer size {k} outside supported range "
            f"{DNA_MIN_K}..{DNA_MAX_K} (2-bit packing + marker bit)")


def pack_dna_windows(codes: torch.Tensor,
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack every length-k window of a DNA-code tensor.

    codes: (..., L) uint8; a window touching an ambiguous base packs its
    codes folded ``& 3`` and must be masked off (``dna_valid_mask``).
    returns (lo, hi): (..., L) int32; position i packs codes[i : i+k]
    (positions past L read code 0); hi is all zeros.
    """
    _check_k(k)
    length = codes.shape[-1]
    c = (codes & 3).to(torch.int32)
    pad = torch.zeros(codes.shape[:-1] + (k,), dtype=torch.int32,
                      device=codes.device)
    cp = torch.cat([c, pad], dim=-1)
    lo = torch.full(codes.shape, 1 << (2 * k), dtype=torch.int32,
                    device=codes.device)
    for j in range(k):
        lo |= cp[..., j: j + length] << (2 * j)
    return lo, torch.zeros_like(lo)


def pack_dna_np(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Host mirror of :func:`pack_dna_windows` over all L-k+1 full windows.

    codes: (L,) uint8 DNA codes; returns (lo, hi): (L-k+1,) uint32 each.
    Windows containing ambiguous bases are still packed (codes folded & 3);
    filter with :func:`dna_valid_np` before use.
    """
    _check_k(k)
    n = len(codes) - k + 1
    if n <= 0:
        z = np.zeros(0, np.uint32)
        return z, z
    lo = np.full(n, np.uint32(1 << (2 * k)), np.uint32)
    c = (codes & np.uint8(3)).astype(np.uint32)
    for j in range(k):
        lo |= c[j: j + n] << np.uint32(2 * j)
    return lo, np.zeros(n, np.uint32)


def unpack_dna_np(lo: np.ndarray, hi: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`pack_dna_np`: (N,) lo → (N, k) uint8 DNA codes."""
    _check_k(k)
    out = np.zeros((len(lo), k), np.uint8)
    for j in range(k):
        out[:, j] = (np.asarray(lo, np.uint32) >> np.uint32(2 * j)) & 3
    return out


def dna_valid_np(codes: np.ndarray, k: int) -> np.ndarray:
    """Host validity of each full window start: True iff no ambiguous or
    pad base in codes[i : i+k].  Returns (L-k+1,) bool."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, bool)
    bad = np.concatenate([[0], np.cumsum(codes >= DNA_AMBIG)])
    return (bad[k:] - bad[:-k][: n]) == 0


def dna_valid_mask(codes: torch.Tensor, lengths: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Validity of each window start position.

    codes:   (..., L) uint8 DNA codes
    lengths: (...,) int32 true sequence lengths
    returns  (..., L) bool: the window lies inside the sequence and holds
    no ambiguous or pad base
    """
    length = codes.shape[-1]
    bad = (codes >= DNA_AMBIG).to(torch.int32)
    zero = torch.zeros(codes.shape[:-1] + (1,), dtype=torch.int32,
                       device=codes.device)
    cs = torch.cat([zero, torch.cumsum(bad, dim=-1, dtype=torch.int32)],
                   dim=-1)
    # bad count in window [i, i+k) = cs[i+k] - cs[i]; windows reading past
    # L are cut by the in_range test below
    pad = cs[..., -1:].expand(codes.shape[:-1] + (k,))
    cse = torch.cat([cs, pad], dim=-1)
    win_bad = cse[..., k: k + length] - cse[..., :length]
    pos = torch.arange(length, dtype=torch.int32, device=codes.device)
    in_range = pos <= (lengths[..., None] - k)
    return in_range & (win_bad == 0)


def reverse_complement_device(codes: torch.Tensor) -> torch.Tensor:
    """Reverse complement in code space: complement = code ^ 2 for
    unambiguous codes, ambiguity and pad kept; order reversed."""
    comp = torch.where(codes < 4, codes ^ 2, codes)
    return torch.flip(comp, dims=(-1,))
