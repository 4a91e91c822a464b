"""Wide-bucket hash table: host build and device probe.

Counterpart of ``kmers_anno_tpu/ops/widetable.py``.  A table is
``(rows, 72)`` 32-bit words, ``[24 lo keys | 24 hi keys | 24 payloads]``
per row, with ``EMPTY`` (0xFFFFFFFF) in free key slots.  The build retries
hash salts until no row overflows its 24 slots, so almost every lookup
reads exactly one row.  On the device the table is an ``int32`` tensor
holding the uint32 bits (``EMPTY`` reads as -1): packed kmer words use
at most 30 bits and payloads keep bit 31 clear, so no comparison or
payload ever depends on the sign.

``build_wide_table`` and ``wide_rows_for`` are NumPy copies of the
reference (the reference module imports jax) and give byte-equal tables
and the same salt.  ``probe_wide`` launches ``csrc/probe_wide.cu`` for CUDA
tensors and takes :func:`probe_wide_plain` for CPU tensors.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .. import kernels
from ..host import mix_kmer_salted_np, salt_sequence
from .hashing import mix_kmer_salted

log = logging.getLogger(__name__)

EMPTY = np.uint32(0xFFFFFFFF)   # no packed kmer key word is all-ones
SLOTS = 24                      # slots per bucket (row = 3*SLOTS words)
MAX_WIDE_ROWS = 1 << 18         # the reference's row cap (see PERF.md)
TARGET_MU = 8.0                 # target mean keys/bucket (load 1/3)
MAX_MU = 12.0                   # absolute cap before giving up
PROBE_CHUNK = 1 << 19           # queries per step of the plain probe


def wide_rows_for(n_keys: int) -> int | None:
    """Power-of-two row count targeting TARGET_MU keys/bucket, or None
    when the keys would not fit MAX_WIDE_ROWS rows at MAX_MU."""
    want = max(128, int(np.ceil(n_keys / TARGET_MU)))
    rows = 1 << (want - 1).bit_length()
    if rows > MAX_WIDE_ROWS:
        rows = MAX_WIDE_ROWS
    if n_keys / rows > MAX_MU:
        return None
    return rows


def build_wide_table(key_lo, key_hi, values, n_rows: int | None = None,
                     max_salts: int = 32):
    """Build the wide-bucket table from unique keys (host, vectorized).

    key_lo/key_hi: (N,) uint32 packed kmer keys (deduplicated)
    values:        (N,) uint32/int32 payloads with bit 31 clear
    returns (table (rows, 3*SLOTS) uint32, salt int, max_probes int)

    Tries ``max_salts`` hash salts for an overflow-free placement
    (max_probes == 1).  If every salt overflows, keeps the best salt with
    a bounded bucket walk — still correct, one extra row per probe round.
    """
    key_lo = np.asarray(key_lo, np.uint32)
    key_hi = np.asarray(key_hi, np.uint32)
    values = np.asarray(values).astype(np.uint32)
    n = len(key_lo)
    if n_rows is None:
        n_rows = wide_rows_for(n)
        if n_rows is None:
            raise ValueError(
                f"{n} keys exceed the wide-table capacity")
    if n > n_rows * SLOTS:
        raise ValueError(f"{n} keys do not fit {n_rows}x{SLOTS} slots")
    mask = np.uint32(n_rows - 1)

    best = None  # (overflow_count, salt, home)
    for salt in salt_sequence(max_salts):
        home = (mix_kmer_salted_np(key_lo, key_hi, np.uint32(salt), np)
                & mask).astype(np.int64)
        over = int(np.maximum(
            np.bincount(home, minlength=n_rows) - SLOTS, 0).sum())
        if over == 0:
            best = (0, salt, home)
            break
        if best is None or over < best[0]:
            best = (over, salt, home)
    over, salt, home = best
    if over:
        log.warning("wide table: no overflow-free salt in %d tries; "
                    "%d keys walk (max_probes > 1)", max_salts, over)

    flat = np.empty((3, n_rows * SLOTS), np.uint32)
    flat[0].fill(EMPTY)
    flat[1].fill(EMPTY)
    flat[2].fill(0)
    max_probes = 1
    if n:
        # greedy placement on home-sorted keys: pos = running max of
        # (rank, home*SLOTS) — overflow walks to the next bucket.
        order = np.argsort(home, kind="stable")
        hb = home[order]
        ar = np.arange(n, dtype=np.int64)
        pos = ar + np.maximum.accumulate(hb * SLOTS - ar)
        ok = pos < n_rows * SLOTS
        flat[0][pos[ok]] = key_lo[order[ok]]
        flat[1][pos[ok]] = key_hi[order[ok]]
        flat[2][pos[ok]] = values[order[ok]]
        max_probes = int((pos[ok] // SLOTS - hb[ok]).max(initial=0)) + 1
        spill = np.flatnonzero(~ok)
        if len(spill):  # wrapped past the last bucket: continue from 0
            counts = np.bincount(pos[ok] // SLOTS, minlength=n_rows)
            for s in spill:
                bb = 0
                while counts[bb] >= SLOTS:
                    bb += 1
                    if bb >= n_rows:
                        raise RuntimeError("wide table is over-full")
                i = order[s]
                p = bb * SLOTS + counts[bb]
                flat[0][p] = key_lo[i]
                flat[1][p] = key_hi[i]
                flat[2][p] = values[i]
                counts[bb] += 1
                max_probes = max(max_probes, n_rows - int(hb[s]) + bb + 1)

    table = np.concatenate([flat[0].reshape(n_rows, SLOTS),
                            flat[1].reshape(n_rows, SLOTS),
                            flat[2].reshape(n_rows, SLOTS)], axis=1)
    return table, salt, max_probes


def _check_args(table, key_lo, key_hi, valid, max_probes) -> None:
    n_rows = table.shape[0]
    if table.dim() != 2 or table.shape[1] != 3 * SLOTS:
        raise ValueError(f"table must be (rows, {3 * SLOTS})")
    if table.dtype != torch.int32:
        raise ValueError("table must be int32 (the uint32 bits)")
    if n_rows < 1 or n_rows & (n_rows - 1):
        raise ValueError(f"table rows must be a power of two, got {n_rows}")
    if key_lo.dtype != torch.int32 or key_hi.dtype != torch.int32:
        raise ValueError("query keys must be int32")
    if valid.dtype != torch.bool:
        raise ValueError("valid must be a bool tensor")
    if not key_lo.shape == key_hi.shape == valid.shape:
        raise ValueError("key_lo, key_hi and valid must have one shape")
    if max_probes < 1:
        raise ValueError("max_probes must be >= 1")
    devs = {t.device for t in (table, key_lo, key_hi, valid)}
    if len(devs) != 1:
        raise ValueError(f"probe_wide arguments span devices {devs}")


def probe_wide_plain(table: torch.Tensor, key_lo: torch.Tensor,
                     key_hi: torch.Tensor, valid: torch.Tensor, salt: int,
                     max_probes: int = 1) -> torch.Tensor:
    """Plain-PyTorch probe; same contract as :func:`probe_wide`.

    Works in PROBE_CHUNK query slices, like the reference's
    ``_chunked_pay``, so the gathered (chunk, 72) row buffer stays bounded.
    """
    _check_args(table, key_lo, key_hi, valid, max_probes)
    n_rows = table.shape[0]
    lo_f = key_lo.reshape(-1)
    hi_f = key_hi.reshape(-1)
    v_f = valid.reshape(-1)
    out = torch.full(lo_f.shape, -1, dtype=torch.int32, device=table.device)
    for s in range(0, lo_f.numel(), PROBE_CHUNK):
        lo = lo_f[s: s + PROBE_CHUNK]
        hi = hi_f[s: s + PROBE_CHUNK]
        v = v_f[s: s + PROBE_CHUNK]
        b = mix_kmer_salted(lo, hi, salt) & (n_rows - 1)
        b = torch.where(v, b, 0)        # invalid queries read row 0
        val = torch.full(lo.shape, -1, dtype=torch.int32,
                         device=table.device)
        for _ in range(max_probes):
            rows = table[b]                              # (chunk, 72)
            hit = ((rows[:, :SLOTS] == lo[:, None])
                   & (rows[:, SLOTS: 2 * SLOTS] == hi[:, None]))
            # keys are unique: at most one slot matches; sum selects it
            hv = torch.where(hit, rows[:, 2 * SLOTS:], 0).sum(
                1, dtype=torch.int32)
            val = torch.where((val < 0) & hit.any(1), hv, val)
            b = (b + 1) & (n_rows - 1)
        out[s: s + PROBE_CHUNK] = torch.where(v, val, -1)
    return out.reshape(key_lo.shape)


def probe_wide(table: torch.Tensor, key_lo: torch.Tensor,
               key_hi: torch.Tensor, valid: torch.Tensor, salt: int,
               max_probes: int = 1) -> torch.Tensor:
    """Look a batch of keys up in a wide-bucket table.

    table:  (rows, 72) int32 — the uint32 words of ``build_wide_table``
    key_lo/key_hi: (...,) int32 query keys
    valid:  (...,) bool — invalid queries return -1 without a row read
    salt:   the salt ``build_wide_table`` chose
    returns (...,) int32 — stored payload, or -1 on a miss / invalid

    A CPU tensor takes :func:`probe_wide_plain`; a CUDA tensor launches
    the kernel (``csrc/probe_wide.cu``) or raises.
    """
    _check_args(table, key_lo, key_hi, valid, max_probes)
    if table.device.type == "cpu":
        return probe_wide_plain(table, key_lo, key_hi, valid, salt,
                                max_probes)
    if table.device.type != "cuda":
        raise ValueError(f"probe_wide: unsupported device {table.device}")
    table = table.contiguous()
    if table.data_ptr() % 16:
        raise ValueError("probe_wide: table must be 16-byte aligned")
    lo = key_lo.contiguous()
    hi = key_hi.contiguous()
    v = valid.contiguous()
    out = torch.empty(lo.shape, dtype=torch.int32, device=lo.device)
    q = lo.numel()
    if q == 0:
        return out
    with torch.cuda.device(table.device):
        err = kernels.lib().kan_probe_wide(
            table.data_ptr(), table.shape[0], lo.data_ptr(), hi.data_ptr(),
            v.data_ptr(), q, int(salt) & 0xFFFFFFFF, max_probes,
            out.data_ptr(), kernels.stream_of(table))
    kernels.check(err, "probe_wide kernel")
    probe_wide.launches += 1
    return out


probe_wide.launches = 0
