"""Salted murmur3 mixing of the two kmer key words, in int64 torch.

Bit-equal to ``kmers_anno_tpu/ops/hashing.py``, which wraps modulo 2^32 in
uint32.  torch has no ``*`` or ``>>`` on ``uint32``, so the values live in
``int64`` holding the 32-bit pattern, and every product is taken in two
16-bit halves and masked back to 32 bits: no intermediate leaves int64's
range, so no signed overflow is ever relied on.
"""

from __future__ import annotations

import torch

from ..host import M1, M2

MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant m."""
    lo = x * (m & 0xFFFF)                       # < 2^48
    hi = ((x * (m >> 16)) & 0xFFFF) << 16       # < 2^32
    return (lo + hi) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, M1)
    x = x ^ (x >> 13)
    x = _mul32(x, M2)
    return x ^ (x >> 16)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """An int32 (or int64) tensor's 32-bit pattern as non-negative int64."""
    return x.to(torch.int64) & MASK32


def mix_kmer_salted(lo: torch.Tensor, hi: torch.Tensor,
                    salt: int) -> torch.Tensor:
    """Salted kmer hash → int64 tensor of uint32 values (hashing.py:34-42)."""
    lo = as_u32(lo)
    hi = as_u32(hi)
    return fmix32(lo ^ fmix32(hi ^ (int(salt) & MASK32)))
