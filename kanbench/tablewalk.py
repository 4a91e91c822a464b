"""What a lookup needs from a table, for the kernels' counts: the table
layouts the program serves (a wide table of 24-slot rows: 24 low key
words, 24 high, 24 payloads; an 8-slot table: 8 of each), their salted
murmur3 hash, and the walk from a key's home row.  Kept here as they stood
when the counts were fixed, so a count moves only with what its inputs
need.
"""

from __future__ import annotations

import torch

GOLDEN = 0x9E3779B9
M1 = 0x85EBCA6B
M2 = 0xC2B2AE35
MASK32 = 0xFFFFFFFF
WIDE_SLOTS = 24
BUCKET_SLOTS = 8
EMPTY = -1                      # an empty slot's low key word, as int32
PAD_CODE = 31                   # the letter code past a stream's end
BITS = 5


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, M1)
    x = x ^ (x >> 13)
    x = _mul32(x, M2)
    return x ^ (x >> 16)


def mix(lo: torch.Tensor, hi: torch.Tensor, salt: int) -> torch.Tensor:
    """Salted hash of key words (int32 or int64 holding uint32)."""
    lo = lo.to(torch.int64) & MASK32
    hi = hi.to(torch.int64) & MASK32
    return _fmix32(lo ^ _fmix32(hi ^ (int(salt) & MASK32)))


def pack_windows(codes: torch.Tensor, k: int):
    """(lo, hi) int64 key words of the length-k window at every position
    of a (T,) letter-code stream (positions past the end read PAD_CODE)."""
    n = codes.numel()
    c = torch.cat([codes.to(torch.int64),
                   torch.full((k,), PAD_CODE, dtype=torch.int64,
                              device=codes.device)])
    lo = torch.zeros(n, dtype=torch.int64, device=codes.device)
    hi = torch.zeros_like(lo)
    for j in range(k):
        w = c[j: j + n]
        if j < 6:
            lo |= w << (BITS * j)
        else:
            hi |= w << (BITS * (j - 6))
    return lo, hi


def wide_reads(table, lo, hi, valid, salt, max_probes) -> tuple[int, int]:
    """(distinct rows holding a hit, hits) of these lookups in a wide
    table: a key walks from its home row until its row is found or
    ``max_probes`` rows are read."""
    mask = table.shape[0] - 1
    hit_seen = torch.zeros(table.shape[0], dtype=torch.bool,
                           device=table.device)
    hits = 0
    lo, hi, valid = lo.reshape(-1), hi.reshape(-1), valid.reshape(-1)
    step = 1 << 20
    for s in range(0, lo.numel(), step):
        v = valid[s: s + step]
        qlo = lo[s: s + step][v].to(torch.int64) & MASK32
        qhi = hi[s: s + step][v].to(torch.int64) & MASK32
        row = mix(qlo, qhi, salt) & mask
        for _ in range(max_probes):
            if not row.numel():
                break
            rows = table[row].to(torch.int64) & MASK32
            hit = ((rows[:, :WIDE_SLOTS] == qlo[:, None])
                   & (rows[:, WIDE_SLOTS: 2 * WIDE_SLOTS]
                      == qhi[:, None])).any(1)
            hits += int(hit.sum())
            hit_seen[row[hit]] = True
            qlo, qhi, row = qlo[~hit], qhi[~hit], (row[~hit] + 1) & mask
    return int(hit_seen.sum()), hits


def bucket_reads(table, lo, hi, valid, max_probes,
                 hit_seen) -> int:
    """Hits of these lookups in an 8-slot table, marking the buckets that
    hold them in ``hit_seen``: a key walks from its home bucket (the hash
    at GOLDEN) until it is found, a bucket has a free slot, or
    ``max_probes`` are read."""
    mask = table.shape[0] - 1
    hits = 0
    lo, hi, valid = lo.reshape(-1), hi.reshape(-1), valid.reshape(-1)
    step = 1 << 22
    for s in range(0, lo.numel(), step):
        v = valid[s: s + step]
        qlo = lo[s: s + step][v].to(torch.int64) & MASK32
        qhi = hi[s: s + step][v].to(torch.int64) & MASK32
        b = mix(qlo, qhi, GOLDEN) & mask
        for _ in range(max_probes):
            if not b.numel():
                break
            rows = table[b].to(torch.int64) & MASK32
            lo_slots = rows[:, :BUCKET_SLOTS]
            hit = ((lo_slots == qlo[:, None])
                   & (rows[:, BUCKET_SLOTS: 2 * BUCKET_SLOTS]
                      == qhi[:, None])).any(1)
            hits += int(hit.sum())
            hit_seen[b[hit]] = True
            go = ~hit & (lo_slots != (EMPTY & MASK32)).all(1)
            qlo, qhi, b = qlo[go], qhi[go], (b[go] + 1) & mask
    return hits
