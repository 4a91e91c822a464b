"""Salted murmur3 mixing of the two kmer key words, in NumPy and in torch.

The constants, the NumPy mixers and the salt sequence are a copy of the
reference package's ``ops/hashing.py``; the host table builds use them.
The torch mixers are bit-equal to them: torch has no ``*`` or ``>>`` on
``uint32``, so the values live in ``int64`` holding the 32-bit pattern, and
every product is taken in two 16-bit halves and masked back to 32 bits: no
intermediate leaves int64's range, so no signed overflow is ever relied
on.
"""

from __future__ import annotations

import numpy as np
import torch

GOLDEN = 0x9E3779B9
M1 = 0x85EBCA6B
M2 = 0xC2B2AE35
MASK32 = 0xFFFFFFFF


# ----- NumPy (uint32, wrap-around arithmetic) -----

def _fmix32_np(x):
    """Murmur3 finalizer on uint32 arrays."""
    u32 = np.uint32
    x = x ^ (x >> u32(16))
    x = x * u32(M1)
    x = x ^ (x >> u32(13))
    x = x * u32(M2)
    x = x ^ (x >> u32(16))
    return x


def mix_kmer_salted_np(lo, hi, salt):
    """Salted kmer hash of uint32 key arrays → uint32.  The wide-bucket
    table's build retries salts until no bucket overflows its slots;
    salt == GOLDEN gives :func:`mix_kmer_np`."""
    return _fmix32_np(lo ^ _fmix32_np(hi ^ np.uint32(salt)))


def mix_kmer_np(lo, hi):
    """Hash of a packed kmer key pair → uint32."""
    return mix_kmer_salted_np(lo, hi, GOLDEN)


def salt_sequence(n: int) -> list[int]:
    """Deterministic salt candidates for the overflow-free table build;
    the first is GOLDEN so unsalted and salted hashes usually agree.
    Pure-Python wrap-around arithmetic (numpy uint32 scalars warn)."""
    out = [GOLDEN]
    x = GOLDEN
    for _ in range(n - 1):
        x = (x + 0x6A09E667) & MASK32
        x ^= x >> 16
        x = (x * M1) & MASK32
        x ^= x >> 13
        x = (x * M2) & MASK32
        x ^= x >> 16
        out.append(x)
    return out


# ----- torch (int64 holding uint32) -----

def mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant m."""
    lo = x * (m & 0xFFFF)                       # < 2^48
    hi = ((x * (m >> 16)) & 0xFFFF) << 16       # < 2^32
    return (lo + hi) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = mul32(x, M1)
    x = x ^ (x >> 13)
    x = mul32(x, M2)
    return x ^ (x >> 16)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """An int32 (or int64) tensor's 32-bit pattern as non-negative int64."""
    return x.to(torch.int64) & MASK32


def mix_kmer_salted(lo: torch.Tensor, hi: torch.Tensor,
                    salt: int) -> torch.Tensor:
    """Salted kmer hash → int64 tensor of uint32 values."""
    lo = as_u32(lo)
    hi = as_u32(hi)
    return fmix32(lo ^ fmix32(hi ^ (int(salt) & MASK32)))


def mix_kmer(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Salt-free kmer hash: the salted mix at GOLDEN."""
    return mix_kmer_salted(lo, hi, GOLDEN)
