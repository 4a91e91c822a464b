"""The probe-window table and the sort-and-stream sliced probe, plain torch.

Counterpart of ``kmers_anno_tpu/ops/sliced_probe.py``.  ``windowed_table``
lays the 8-slot table (``ops.hashtable``) out so that row b holds buckets
b .. b+P-1 (mod B), P = ``max_probes``: one row read covers a whole walk.
``probe_table_sliced`` sorts the queries by home bucket, cuts the table into
slices of ``MAX_SLICE_ROWS`` rows and gathers each query's row from its
slice, with the reference's overflow fallback (a slice with more queries
than its window probes the whole table instead) and payload mode (a rider
rides the bucket sort, and values come back in bucket-sorted order, for
consumers whose reductions do not depend on order).

The port's engine never lays a table out in windows: on the card the apply
kernel (``csrc/apply_flat.cu``) walks the plain table, one thread a query,
since a walk there leaves its home bucket for under 1% of lookups.  These
functions are plain-torch counterparts of the reference's sliced path, for
the parity tests and the chip smoke run's timing of the sort-and-stream
probe against the kernel's walk.  ``SLICED_THRESHOLD_BYTES`` and
``pick_probe`` give the size at which the reference switches layout.  The
reference's matrix-unit gather (``mxu=``) is not carried over.
"""

from __future__ import annotations

import numpy as np
import torch

from .hashing import mix_kmer
from .hashtable import BUCKET
from .widetable import check_probe_args

ROW = 3 * BUCKET          # 32-bit words per bucket
MAX_SLICE_ROWS = 1 << 16  # table rows a slice holds
SLICED_THRESHOLD_BYTES = 48 << 20   # tables past this take the window layout


def windowed_table(table: np.ndarray, max_probes: int) -> np.ndarray:
    """(B, 24) bucket table -> (B, 24 * P) probe-window table whose row b
    holds buckets b .. b+P-1 (mod B) (``sliced_probe.py:70-77``)."""
    table = np.asarray(table)
    if max_probes <= 1:
        return np.ascontiguousarray(table)
    return np.ascontiguousarray(np.concatenate(
        [np.roll(table, -i, axis=0) for i in range(max_probes)], axis=1))


def pick_probe(table_bytes: int) -> bool:
    """True when a table of this size takes the probe-window layout."""
    return table_bytes > SLICED_THRESHOLD_BYTES


def _compare_window(rows: torch.Tensor, ql: torch.Tensor, qh: torch.Tensor,
                    max_probes: int) -> torch.Tensor:
    """The first hit of each query over its gathered (Q, 24 * P) window
    (``sliced_probe.py:84-98``), or -1."""
    val = torch.full(rows.shape[:-1], -1, dtype=torch.int32,
                     device=rows.device)
    for i in range(max_probes):
        tlo = rows[:, i * ROW: i * ROW + BUCKET]
        thi = rows[:, i * ROW + BUCKET: i * ROW + 2 * BUCKET]
        tv = rows[:, i * ROW + 2 * BUCKET: (i + 1) * ROW]
        hit = (tlo == ql[:, None]) & (thi == qh[:, None])
        # keys are unique: at most one slot matches; sum selects it
        hv = torch.where(hit, tv, 0).sum(1, dtype=torch.int32)
        val = torch.where((val < 0) & hit.any(1), hv, val)
    return val


def _check_windowed(what, wtable, key_lo, key_hi, valid, max_probes):
    if wtable.dim() != 2 or wtable.shape[1] != ROW * max(max_probes, 1):
        raise ValueError(f"{what}: a windowed table is (B, {ROW} x "
                         "max_probes)")
    check_probe_args(what, wtable.shape[1], wtable, key_lo, key_hi, valid,
                     max_probes)
    if key_lo.dim() != 1:
        raise ValueError(f"{what}: query keys must be 1-D")


def _home(wtable, key_lo, key_hi) -> torch.Tensor:
    return mix_kmer(key_lo, key_hi) & (wtable.shape[0] - 1)


def probe_windowed(wtable: torch.Tensor, key_lo: torch.Tensor,
                   key_hi: torch.Tensor, valid: torch.Tensor,
                   max_probes: int) -> torch.Tensor:
    """Plain gather walk on a windowed table, one row a query
    (``sliced_probe.py:101-113``); equal to ``hashtable.probe_table`` on
    the table it was made from.

    wtable: (B, 24 * max_probes) int32 from :func:`windowed_table`
    key_lo/key_hi: (N,) int32 query keys; valid: (N,) bool
    returns (N,) int32, the stored payload or -1 on a miss / invalid
    """
    _check_windowed("probe_windowed", wtable, key_lo, key_hi, valid,
                    max_probes)
    b = _home(wtable, key_lo, key_hi)
    val = _compare_window(wtable[b], key_lo, key_hi, max_probes)
    return torch.where(valid, val, -1)


def probe_table_sliced(wtable: torch.Tensor, key_lo: torch.Tensor,
                       key_hi: torch.Tensor, valid: torch.Tensor,
                       max_probes: int, payload: torch.Tensor | None = None):
    """Sort-and-stream probe of a windowed table (``sliced_probe.py:151-242``).

    wtable: (B, 24 * max_probes) int32, B a power of two
    key_lo/key_hi: (N,) int32 query keys; valid: (N,) bool
    payload: optional (N,) int32 rider (segment ids).  When given, the
            values are not put back in query order: the return is
            (values, payload), both in the stable bucket-sorted order
    returns (N,) int32, the stored payload or -1 on a miss / invalid, or
            the (values, payload) pair in sorted order
    """
    _check_windowed("probe_table_sliced", wtable, key_lo, key_hi, valid,
                    max_probes)
    dev = wtable.device
    n = key_lo.shape[0]
    nb = wtable.shape[0]
    s_rows = min(nb, MAX_SLICE_ROWS)
    n_slices = nb // s_rows
    # slice populations of hash-uniform keys sit close to n / n_slices; the
    # window is 1.25x that, in steps of 1,024
    qwin = -(-max(1024, (5 * n) // (4 * n_slices)) // 1024) * 1024
    b = _home(wtable, key_lo, key_hi)
    b_s, order = torch.sort(b, stable=True)   # lax.sort(num_keys=1) is stable
    lo_s, hi_s = key_lo[order], key_hi[order]
    b_p = torch.cat([b_s, torch.full((qwin,), nb, dtype=b_s.dtype,
                                     device=dev)])
    lo_p = torch.cat([lo_s, torch.zeros(qwin, dtype=lo_s.dtype, device=dev)])
    hi_p = torch.cat([hi_s, torch.zeros(qwin, dtype=hi_s.dtype, device=dev)])
    bounds = torch.arange(n_slices + 1, dtype=b_s.dtype, device=dev) * s_rows
    starts = torch.searchsorted(b_s, bounds).tolist()
    overflow = any(e - s > qwin for s, e in zip(starts[:-1], starts[1:]))
    if overflow:
        # a slice holds more queries than its window (duplicate skew):
        # probe the whole table, in bucket-sorted order in payload mode
        out = _compare_window(wtable[b], key_lo, key_hi, max_probes)
        if payload is not None:
            out = out[order]
    else:
        out = torch.full((n + qwin,), -1, dtype=torch.int32, device=dev)
        for g in range(n_slices):
            start = starts[g]
            lb = b_p[start: start + qwin] - g * s_rows
            sl = wtable[g * s_rows: (g + 1) * s_rows]
            rows = sl[torch.clamp(lb, 0, s_rows - 1)]
            # a window reaches into later slices; their steps overwrite it
            out[start: start + qwin] = _compare_window(
                rows, lo_p[start: start + qwin], hi_p[start: start + qwin],
                max_probes)
        out = out[:n]
        if payload is None:
            restored = torch.empty_like(out)
            restored[order] = out
            out = restored
    if payload is not None:
        return torch.where(valid[order], out, -1), payload[order]
    return torch.where(valid, out, -1)
