"""A split-block Bloom filter of an 8-slot table's keys, read in front of
the table walk of the flat-stream apply kernels (``csrc/apply_flat.cu``)
and of the DNA window probe (``csrc/dna_probe.cu``), through
``csrc/key_filter.cuh``.

A table past one wide table is 100 MB or more, past the card's 50 MB L2,
and most kmer windows of a protein miss it; without the filter each miss
reads a random sector of the table from device memory.  The filter is
``FILTER_BITS_PER_KEY`` bits a key (20 MB for 10M keys), small enough to
stay in L2.  Each key owns one 32-byte sector of 8 uint32 words and sets
one bit in each word: the sector is chosen by ``fmix32(lo ^ fmix32(hi ^
SECTOR_SALT))`` scaled to the sector count, the bits by ``fmix32(hi ^
fmix32(lo ^ BIT_SALT))`` times one odd constant a word, top 5 bits.  Both
hashes are independent of the bucket hash (salt ``GOLDEN``).  A query whose
sector lacks one of its 8 bits is surely absent; a Bloom filter has no false
negatives, so filtering changes no output.

The filter is a separate array beside the table: the table's bytes stay
those of ``ops.hashtable.build_table``.  It is built once, in torch on the
table's device, from the table's keys (setting bits is order-free, so any
key order gives the same bits).  :func:`may_hold` is the plain-torch check
the kernels make, for the tests and the measurements; :func:`check_filter`
and :func:`filter_args` are the wrappers' checks and C arguments.
"""

from __future__ import annotations

import numpy as np
import torch

from .hashing import MASK32, mix_kmer_salted, mul32
from .hashtable import BUCKET, EMPTY

FILTER_BITS_PER_KEY = 16
SECTOR_WORDS = 8                  # one 32-byte sector: 8 uint32 words
SECTOR_SALT = 0x3C6EF372
BIT_SALT = 0xA54FF53A
# one odd multiplier a word (the split-block Bloom filter of Apache Parquet)
WORD_SALTS = (0x47B6137B, 0x44974D91, 0x8824AD5B, 0xA2B7289D,
              0x705495C7, 0x2DF1424B, 0x9EFC4947, 0x5C6BFB31)


def filter_sectors(n_keys: int) -> int:
    """The sectors of a filter of ``n_keys`` keys (at least one)."""
    return max(1, -(-n_keys * FILTER_BITS_PER_KEY // (32 * SECTOR_WORDS)))


def table_keys(table: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The (lo, hi) keys an 8-slot table holds (``build_table``'s layout:
    EMPTY in a free lo slot; a packed kmer's lo word is below 2^30)."""
    lo = table[:, :BUCKET]
    used = lo != EMPTY
    return lo[used], table[:, BUCKET: 2 * BUCKET][used]


def build_key_filter(key_lo, key_hi,
                     device: str | torch.device = "cpu") -> torch.Tensor:
    """The filter of the uint32 keys (lo, hi), built on ``device``: a
    (sectors, 8) int32 tensor of the uint32 words."""
    lo, hi = (torch.from_numpy(np.asarray(k, np.uint32).view(np.int32)).to(
        device) for k in (key_lo, key_hi))
    n = filter_sectors(lo.numel())
    base = ((mix_kmer_salted(lo, hi, SECTOR_SALT) * n) >> 32) * (
        SECTOR_WORDS * 32)
    hb = mix_kmer_salted(hi, lo, BIT_SALT)
    bits = torch.zeros(n * SECTOR_WORDS * 32, dtype=torch.bool,
                       device=lo.device)
    for i, salt in enumerate(WORD_SALTS):
        bits[base + 32 * i + (mul32(hb, salt) >> 27)] = True
    shifts = torch.arange(8, dtype=torch.uint8, device=lo.device)
    octets = (bits.view(-1, 8).to(torch.uint8) << shifts).sum(
        1, dtype=torch.uint8)
    return octets.view(torch.int32).view(n, SECTOR_WORDS)


def may_hold(key_filter: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """Plain-torch filter check: False where the table surely lacks the
    key (lo, hi).  key_filter: (sectors, 8) int32 (the uint32 words);
    lo / hi: (...,) int32 keys.  Returns a bool tensor shaped like lo."""
    n = key_filter.shape[0]
    hs = mix_kmer_salted(lo, hi, SECTOR_SALT)
    sector = (hs * n) >> 32
    hb = mix_kmer_salted(hi, lo, BIT_SALT)
    words = key_filter.reshape(-1).to(torch.int64) & MASK32
    held = torch.ones(lo.shape, dtype=torch.bool, device=lo.device)
    for i, salt in enumerate(WORD_SALTS):
        pos = mul32(hb, salt) >> 27
        held &= ((words[sector * SECTOR_WORDS + i] >> pos) & 1).bool()
    return held


def check_filter(what, key_filter, table) -> None:
    """Raise unless ``key_filter`` is None or a (sectors, 8) int32 filter
    on the table's device."""
    if key_filter is None:
        return
    if (key_filter.dtype != torch.int32 or key_filter.dim() != 2
            or key_filter.shape[1] != SECTOR_WORDS
            or key_filter.shape[0] < 1):
        raise ValueError(f"{what}: key_filter must be a (sectors, "
                         f"{SECTOR_WORDS}) int32 tensor")
    if key_filter.device != table.device:
        raise ValueError(f"{what}: key_filter lies on {key_filter.device}, "
                         f"the table on {table.device}")


def filter_args(key_filter) -> tuple:
    """A kernel entry point's (filter pointer, sector count); (None, 0):
    no filter, every window walks."""
    if key_filter is None:
        return None, 0
    return key_filter.data_ptr(), key_filter.shape[0]
