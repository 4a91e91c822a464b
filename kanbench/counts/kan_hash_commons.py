"""``kan_hash_commons``: one chunk of prototype kmers counted against a
genome batch's table and owner matrix, one kernel a call.

Bytes, each input read once and each output written once: 13 B a chunk
kmer (its two key words, its prototype, its flag), the 32 B of low keys of
each distinct bucket the lookups read, a hit's high key and payload words
(8 B), the 4 B owner slots of each distinct owner row the hits name, and
4 B a count cell the chunk makes non-zero (the buffer comes zeroed, so no
other cell need be written).  Operations: a valid kmer's hash (two fmix32
and a mask, 14), 16 a bucket read (8 low-key compares, 8 free-slot tests),
2 an owner slot of a hit (its bound test and its count).

The walk: each valid kmer from its home bucket (the hash at GOLDEN) until
its key is found, a bucket has a free slot, or ``max_probes`` buckets are
read; a hit's payload is its kmer's rank, the row of its owners."""

from __future__ import annotations

import torch

from ..tablewalk import BUCKET_SLOTS, EMPTY, GOLDEN, MASK32, mix

WRAPPERS = (("kmers_anno_tpu_torch.engine.hashanno", "hash_commons"),)
KERNELS = ("hash_commons_kernel",)
KMER_BYTES = 13
BUCKET_LO_BYTES = 32
HIT_BYTES = 8
HASH_OPS = 14
BUCKET_OPS = 16
OWNER_OPS = 2
STEP = 1 << 22                  # kmers a slice of the walk


def walk(table, lo, hi, valid, max_probes) -> tuple:
    """(distinct buckets whose low keys the lookups read, bucket reads,
    each kmer's payload or -1)."""
    mask = table.shape[0] - 1
    seen = torch.zeros(table.shape[0], dtype=torch.bool, device=table.device)
    ranks = torch.full(lo.shape, -1, dtype=torch.int64, device=lo.device)
    reads = 0
    for s in range(0, lo.numel(), STEP):
        idx = s + torch.nonzero(valid[s: s + STEP]).reshape(-1)
        qlo = lo[idx].to(torch.int64) & MASK32
        qhi = hi[idx].to(torch.int64) & MASK32
        b = mix(qlo, qhi, GOLDEN) & mask
        for _ in range(max_probes):
            if not b.numel():
                break
            seen[b] = True
            reads += b.numel()
            rows = table[b].to(torch.int64) & MASK32
            lo_slots = rows[:, :BUCKET_SLOTS]
            slot = ((lo_slots == qlo[:, None])
                    & (rows[:, BUCKET_SLOTS: 2 * BUCKET_SLOTS]
                       == qhi[:, None]))
            hit = slot.any(1)
            at = slot.to(torch.int32).argmax(1)
            ranks[idx[hit]] = rows[hit, 2 * BUCKET_SLOTS + at[hit]]
            go = ~hit & (lo_slots != (EMPTY & MASK32)).all(1)
            idx, qlo, qhi, b = idx[go], qlo[go], qhi[go], (b[go] + 1) & mask
    return int(seen.sum()), reads, ranks


def cells(ranks, owner_mat, proto, n_rows: int, n_pad: int) -> int:
    """The distinct (prototype row, owner) cells the hits count into: rows
    below ``n_rows``, owners below ``n_pad``."""
    hit = (ranks >= 0) & (proto >= 0) & (proto < n_rows)
    own = owner_mat[ranks[hit]].to(torch.int64)
    row = proto[hit].to(torch.int64)[:, None].expand_as(own)
    keep = own < n_pad
    return int(torch.unique(row[keep] * n_pad + own[keep]).numel())


def count(table, max_probes, owner_mat, key_lo, key_hi, proto, valid,
          n_rows, n_pad, *, out=None, with_ranks=False):
    buckets, reads, ranks = walk(table, key_lo, key_hi, valid, max_probes)
    hit = ranks >= 0
    hits = int(hit.sum())
    cap = owner_mat.shape[1]
    owner_rows = int(ranks[hit].unique().numel())
    n_cells = cells(ranks, owner_mat, proto, n_rows, n_pad)
    n_bytes = (KMER_BYTES * key_lo.numel() + BUCKET_LO_BYTES * buckets
               + HIT_BYTES * hits + 4 * cap * owner_rows + 4 * n_cells)
    n_ops = (HASH_OPS * int(valid.sum()) + BUCKET_OPS * reads
             + OWNER_OPS * cap * hits)
    return n_bytes, n_ops
