"""Bucketed open-addressing hash table: host build and device probe.

Counterpart of ``kmers_anno_tpu/ops/hashtable.py`` (the 8-slot layout; the
wide-bucket layout is ``ops.widetable``).  A table is ``(B, 24)`` 32-bit
words, ``[8 lo keys | 8 hi keys | 8 payloads]`` per bucket, with ``EMPTY``
(0xFFFFFFFF) in free key slots.  A key whose home bucket
``mix_kmer(lo, hi) & (B-1)`` is full walks to the next bucket, and a probe
stops at the first bucket that is not full.

``table_size_for``, ``build_table``, ``MAX_DEVICE_PROBES`` and
``device_table_buckets`` are NumPy copies of the reference (the reference
module imports jax) and give byte-equal tables; the reference's
``build_table_device`` is ``ops.table_build.build_bucketed`` at
``BUCKETED``.  ``probe_table`` is the
reference's XLA probe as plain torch, on whatever device the table lies:
on the device it is tensor code, not a kernel of this package.  The hash
runs in the int64 emulation of ``ops.hashing`` (uint32 bits held in
int64), and the table as an ``int32`` tensor of the uint32 bits, as for
the wide table.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .hashing import mix_kmer, mix_kmer_np
from .widetable import PROBE_CHUNK, check_probe_args

EMPTY = np.uint32(0xFFFFFFFF)
BUCKET = 8  # slots per bucket

_SCRATCH = threading.local()


def table_size_for(n_keys: int, load_factor: float = 0.5) -> int:
    """Power-of-two bucket count targeting the given load factor."""
    want = max(2, int(n_keys / (load_factor * BUCKET)))
    return 1 << (want - 1).bit_length()


def build_table(key_lo, key_hi, values, n_buckets: int | None = None,
                load_factor: float = 0.5):
    """Build a bucketed table from unique keys (host-side, vectorized).

    key_lo/key_hi: (N,) uint32 packed kmer keys (must be deduplicated)
    values:        (N,) uint32/int32 payloads (role indices; >= 0)
    returns (table (n_buckets, 3*BUCKET) uint32 np.ndarray,
             max_probes int — the longest bucket walk, probe loop bound)
    """
    key_lo = np.asarray(key_lo, np.uint32)
    key_hi = np.asarray(key_hi, np.uint32)
    values = np.asarray(values).astype(np.uint32)
    n = len(key_lo)
    if n_buckets is None:
        n_buckets = table_size_for(n, load_factor)
    if n > n_buckets * BUCKET:
        raise ValueError(f"{n} keys do not fit {n_buckets}x{BUCKET} slots")
    mask = np.uint32(n_buckets - 1)
    # Reuse per-thread scratch planes: fresh multi-MB allocations fault in
    # new pages on every call, dwarfing the actual build work.
    cache = _SCRATCH.__dict__.setdefault("planes", {})
    planes = cache.get(n_buckets)
    if planes is None:
        planes = tuple(np.empty(n_buckets * BUCKET, np.uint32)
                       for _ in range(3))
        cache[n_buckets] = planes
    flat_lo, flat_hi, flat_val = planes
    flat_lo.fill(EMPTY)
    flat_hi.fill(EMPTY)
    flat_val.fill(0)
    walk_max = 0

    if n:
        # Greedy placement for keys sorted by home bucket equals consecutive
        # slot fill: pos[k] = max(pos[k-1] + 1, 8*home[k]), a running
        # maximum.  The probe invariant holds: a key landing in bucket
        # B > home implies every bucket home..B-1 was already full.
        home = (mix_kmer_np(key_lo, key_hi) & mask).astype(np.int64)
        order = np.argsort(home, kind="stable")
        hb = home[order]
        ar = np.arange(n, dtype=np.int64)
        pos = ar + np.maximum.accumulate(hb * BUCKET - ar)
        ok = pos < n_buckets * BUCKET
        flat_lo[pos[ok]] = key_lo[order[ok]]
        flat_hi[pos[ok]] = key_hi[order[ok]]
        flat_val[pos[ok]] = values[order[ok]]
        walk_max = int((pos[ok] // BUCKET - hb[ok]).max(initial=0))

        spill = np.flatnonzero(~ok)
        if len(spill):
            # Rare wraparound tail: these keys walked past the last bucket
            # (provably full through the end); continue from bucket 0.
            counts = np.bincount(pos[ok] // BUCKET, minlength=n_buckets)
            for k in spill:  # already in pos order
                bb = 0
                while counts[bb] >= BUCKET:
                    bb += 1
                    if bb >= n_buckets:
                        raise RuntimeError("bucketed table is over-full")
                i = order[k]
                p = bb * BUCKET + counts[bb]
                flat_lo[p] = key_lo[i]
                flat_hi[p] = key_hi[i]
                flat_val[p] = values[i]
                counts[bb] += 1
                walk_max = max(walk_max, n_buckets - int(hb[k]) + bb)

    table = np.concatenate([flat_lo.reshape(n_buckets, BUCKET),
                            flat_hi.reshape(n_buckets, BUCKET),
                            flat_val.reshape(n_buckets, BUCKET)], axis=1)
    return table, walk_max + 1


MAX_DEVICE_PROBES = 2   # static probe bound for device-built tables


def device_table_buckets(n_keys: int) -> int:
    """Bucket count for device builds: load factor 0.125 (mean 1
    key/bucket) makes a walk >= MAX_DEVICE_PROBES astronomically rare."""
    return max(2, 1 << (max(n_keys, 2) - 1).bit_length())


def probe_table(table: torch.Tensor, key_lo: torch.Tensor,
                key_hi: torch.Tensor, valid: torch.Tensor,
                max_probes: int) -> torch.Tensor:
    """Look up a batch of keys (hashtable.py:185-218).

    table:   (B, 24) int32 — the uint32 words of ``build_table``
    key_lo/key_hi: (...,) int32 query keys
    valid:   (...,) bool — invalid queries return -1
    returns  (...,) int32 — stored value, or -1 on miss/invalid

    Walks at most ``max_probes`` buckets, in PROBE_CHUNK query slices; a
    query stops at its hit or at the first bucket with a free slot.
    """
    check_probe_args("probe_table", 3 * BUCKET, table, key_lo, key_hi,
                     valid, max_probes)
    n_buckets = table.shape[0]
    empty = int(EMPTY.view(np.int32))
    lo_f = key_lo.reshape(-1)
    hi_f = key_hi.reshape(-1)
    v_f = valid.reshape(-1)
    out = torch.full(lo_f.shape, -1, dtype=torch.int32, device=table.device)
    for s in range(0, lo_f.numel(), PROBE_CHUNK):
        lo = lo_f[s: s + PROBE_CHUNK]
        hi = hi_f[s: s + PROBE_CHUNK]
        active = v_f[s: s + PROBE_CHUNK]
        b = mix_kmer(lo, hi) & (n_buckets - 1)
        val = torch.full(lo.shape, -1, dtype=torch.int32,
                         device=table.device)
        for _ in range(max_probes):
            rows = table[b]                              # (chunk, 24)
            tlo = rows[:, :BUCKET]
            hitmask = (tlo == lo[:, None]) & (rows[:, BUCKET: 2 * BUCKET]
                                              == hi[:, None])
            anyhit = hitmask.any(1)
            # keys are unique: at most one slot matches; sum selects it
            hv = torch.where(hitmask, rows[:, 2 * BUCKET:], 0).sum(
                1, dtype=torch.int32)
            val = torch.where(active & anyhit, hv, val)
            full = (tlo != empty).all(1)
            active = active & ~anyhit & full
            b = (b + 1) & (n_buckets - 1)
        out[s: s + PROBE_CHUNK] = val
    return out.reshape(key_lo.shape)
