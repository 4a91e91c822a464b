"""Device builds of the wide-bucket and the 8-slot hash tables.

Counterpart of the reference's ``build_wide_table_device``
(``kmers_anno_tpu/ops/widetable.py:153``) and ``build_table_device``
(``kmers_anno_tpu/ops/hashtable.py:129``), which the projection engine
runs for each close genome's singleton table.  Both take EMPTY-padded
unique keys and try one placement: the keys sorted stably by home row,
key i of that order at slot ``i + max-scan(home * S - i)``, a row's
overflow walking on to the next row.  A real key that would walk
``max_walk`` rows or more, or wrap past the last row, sets ``bad``, and
the caller then builds the table on the host instead.  The wide layout
(24 slots a row, the given salt, ``max_walk`` 1) drops the keys that
walk; the 8-slot layouts (the unsalted hash) keep them: ``BUCKETED``
(``max_walk`` ``MAX_DEVICE_PROBES``, the projection's tables) and
``OPEN_WALK`` (hashAnno's index, whose probe walks as far as the table's
longest walk: a ``max_walk`` no key reaches, and the keys past the last
row placed from row 0 as the host ``build_table`` places them, so that
the table is ``build_table``'s byte for byte and nothing is bad).  The
8-slot build also reports that longest walk, ``build_table``'s
``max_probes`` less one wherever no key is left out.

:func:`build_wide` and :func:`build_bucketed` launch
``csrc/table_build.cu`` for CUDA tensors (``kan_table_build``: row
counts, a scan over rows, the keys grouped by home and ranked by index,
the table written once, and for ``OPEN_WALK`` the keys past the last row
placed by one block) and take :func:`build_table_plain`, which follows
the reference line by line, for CPU tensors.  Tables are ``int32``
tensors of the uint32 words, as for the host builds (``EMPTY`` reads as
-1).

:func:`union_dedupe` and :func:`union_build` build the projection close
set's union table from the close genomes' raw singleton keys, duplicates
and all, where the reference takes ``np.unique`` and the host
``build_wide_table`` (``kmers_anno_tpu/engine/projection.py:1239-1250``):
the distinct keys grouped by home row at ``MAX_WIDE_ROWS`` and their count
(one device read), then the table at ``wide_rows_for`` of that count, at
salt ``GOLDEN``.  Where no row overflows it is ``build_wide_table``'s
table of ``np.unique``'s keys byte for byte; a row that does reports
``bad`` and the caller takes the host's salt-retry build.  CUDA tensors
launch ``kan_union_dedupe`` and ``kan_union_build``; CPU tensors take
``np.unique`` and :func:`union_table_plain`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from .hashing import GOLDEN, MASK32, mix_kmer_salted, mix_kmer_salted_np
from .hashtable import BUCKET, MAX_DEVICE_PROBES
from .widetable import EMPTY, MAX_WIDE_ROWS, SLOTS

EMPTY_KEY = -1          # EMPTY's int32 bits
SCAN_TILE = 4096        # rows a block of the kernel's scan (kScanTile)
NO_WALK_BOUND = 1 << 30     # more rows than a table of int32 slots holds


class Layout(NamedTuple):
    """What sets the two builds apart."""

    slots: int          # slots a row
    max_walk: int       # a real key walking this many rows is bad
    keep_walkers: bool  # whether keys that walk are written
    wraps: bool         # whether keys past the last row go on from row 0


WIDE = Layout(SLOTS, 1, False, False)
BUCKETED = Layout(BUCKET, MAX_DEVICE_PROBES, True, False)
OPEN_WALK = Layout(BUCKET, NO_WALK_BOUND, True, True)


def _check(key_lo, key_hi, values, n_rows: int) -> None:
    for name, t in (("key_lo", key_lo), ("key_hi", key_hi),
                    ("values", values)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"table build: {name} must be 1-D int32")
    if not key_lo.shape == key_hi.shape == values.shape:
        raise ValueError("table build: keys and values must have one shape")
    devs = {t.device for t in (key_lo, key_hi, values)}
    if len(devs) != 1:
        raise ValueError(f"table build: arguments span devices {devs}")
    if n_rows < 1 or n_rows & (n_rows - 1):
        raise ValueError(
            f"table build: rows must be a power of two, got {n_rows}")


def build_table_plain(key_lo: torch.Tensor, key_hi: torch.Tensor,
                      values: torch.Tensor, n_rows: int, layout: Layout,
                      salt: int) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain-PyTorch build, on any device: (table (n_rows, 3 * slots)
    int32, bad 0-dim bool tensor, the longest walk: the largest
    ``pos // slots - home`` of a real key written, a 0-dim int32 tensor, 0
    with no key).  Where ``layout.wraps``, the keys past the last row take
    the table's free slots from row 0 in order, a walk of ``n_rows - home``
    plus the row, as ``build_table``'s wraparound tail; its
    ``max_probes - 1`` is then the walk."""
    _check(key_lo, key_hi, values, n_rows)
    s = layout.slots
    n = key_lo.numel()
    dev = key_lo.device
    cap = n_rows * s
    real = key_lo != EMPTY_KEY
    home = torch.where(real, mix_kmer_salted(key_lo, key_hi, salt)
                       & (n_rows - 1), n_rows)     # pads sort last, then drop
    hb, order = torch.sort(home, stable=True)
    ar = torch.arange(n, dtype=torch.int64, device=dev)
    if n:
        pos = ar + torch.cummax(hb * s - ar, 0).values
    else:
        pos = ar
    ok = pos < cap
    walk = torch.where(ok, pos // s - hb, 0)
    past = real[order] & ~ok            # the stable order's last keys
    if layout.wraps and n:
        # a row's keys fill it from slot 0: its free slots are its last
        used = torch.bincount(pos[ok] // s, minlength=n_rows)
        free = torch.nonzero(torch.arange(cap, device=dev) % s
                             >= used.repeat_interleave(s)).flatten()
        idx = torch.nonzero(past).flatten()[: free.numel()]
        to = free[: idx.numel()]
        pos[idx] = to
        walk[idx] = n_rows - hb[idx] + to // s
        ok[idx] = True
        past[idx] = False                # what is left finds no slot
    bad = (past | (real[order] & ok & (walk >= layout.max_walk))).any()
    longest = walk.max() if n else torch.zeros((), dtype=torch.int64,
                                                device=dev)
    keep = ok if layout.keep_walkers else ok & (walk < 1)
    drop = torch.where(keep, pos, cap)
    flat = torch.full((3, cap + 1), EMPTY_KEY, dtype=torch.int32, device=dev)
    flat[2] = 0
    for plane, src in zip(flat, (key_lo, key_hi, values)):
        plane[drop] = src[order]
    table = torch.cat([plane[:cap].reshape(n_rows, s) for plane in flat], 1)
    return table, bad, longest.to(torch.int32)


def _align16(n_bytes: int) -> int:
    return -(-n_bytes // 16) * 16


def scratch_bytes(n: int, n_rows: int, layout: Layout) -> int:
    """Device scratch of one kernel build, as ``carve`` in
    ``csrc/table_build.cu`` lays it out: row counts, the scan's status
    words (8 B a tile) and ticket (zeroed); each row's pair (8 B); each
    key's arrival slot (4 B) and record (16 B); for the 8-slot layout the
    stable order (16 B a key)."""
    tiles = -(-n_rows // SCAN_TILE)
    return (_align16(_align16(4 * n_rows) + 8 * tiles + 4)
            + _align16(8 * n_rows) + _align16(4 * n)
            + 16 * n * (2 if layout.keep_walkers else 1))


def _launch(key_lo, key_hi, values, n_rows: int, layout: Layout,
            salt: int) -> tuple[torch.Tensor, torch.Tensor,
                                torch.Tensor | None]:
    """The kernel's build on CUDA tensors: one entry point writes the
    whole table, ``bad`` and, for the 8-slot layouts, the longest walk
    (0-dim int32; None for the wide layout)."""
    s = layout.slots
    dev = key_lo.device
    lo, hi, val = (t.contiguous() for t in (key_lo, key_hi, values))
    n = lo.numel()
    if n_rows * s + n >= 1 << 31:
        raise ValueError(f"table build: {n} keys into {n_rows} rows of {s} "
                         f"slots pass the kernel's int32 positions")
    table = torch.empty((n_rows, 3 * s), dtype=torch.int32, device=dev)
    bad = torch.empty((), dtype=torch.bool, device=dev)
    walk = (torch.empty((), dtype=torch.int32, device=dev)
            if layout.keep_walkers else None)
    n_scratch = scratch_bytes(n, n_rows, layout)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = kernels.lib().kan_table_build(
            lo.data_ptr(), hi.data_ptr(), val.data_ptr(), n, n_rows,
            int(salt) & MASK32, s, layout.max_walk,
            int(layout.keep_walkers), int(layout.wraps), scratch.data_ptr(),
            n_scratch,
            table.data_ptr(), bad.data_ptr(),
            0 if walk is None else walk.data_ptr(), kernels.stream_of(lo))
    kernels.check(err, "table build kernel")
    return table, bad, walk


def _on_card(key_lo) -> bool:
    """True for CUDA tensors (the kernel), False for CPU ones (the plain
    version); any other device raises."""
    if key_lo.device.type not in ("cpu", "cuda"):
        raise ValueError(f"table build: unsupported device {key_lo.device}")
    return key_lo.device.type == "cuda"


def build_wide(key_lo: torch.Tensor, key_hi: torch.Tensor,
               values: torch.Tensor, n_rows: int,
               salt: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Wide-bucket table (``(n_rows, 72)`` int32) of EMPTY-padded unique
    keys at one salt, and ``bad``: a 0-dim bool tensor, True when a real
    key would leave its home row.  Keys and payloads are 1-D int32 (the
    uint32 bits; payloads keep bit 31 clear)."""
    _check(key_lo, key_hi, values, n_rows)
    if not _on_card(key_lo):
        return build_table_plain(key_lo, key_hi, values, n_rows, WIDE,
                                 salt)[:2]
    table, bad, _ = _launch(key_lo, key_hi, values, n_rows, WIDE, salt)
    build_wide.launches += 1
    return table, bad


def build_bucketed(key_lo: torch.Tensor, key_hi: torch.Tensor,
                   values: torch.Tensor, n_buckets: int,
                   layout: Layout) -> tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """8-slot table (``(n_buckets, 24)`` int32) of EMPTY-padded unique keys
    under the unsalted hash in an 8-slot ``layout``, ``bad`` and the
    longest walk (0-dim int32).  ``BUCKETED`` (the projection's tables):
    ``bad`` when a real key would walk ``MAX_DEVICE_PROBES`` buckets or
    more, or wrap past the last one.  ``OPEN_WALK`` (hashAnno's index):
    ``build_table``'s table, and ``bad`` only where the keys outnumber
    the slots."""
    _check(key_lo, key_hi, values, n_buckets)
    if not layout.keep_walkers:
        raise ValueError("table build: build_bucketed takes an 8-slot "
                         "layout")
    if not _on_card(key_lo):
        return build_table_plain(key_lo, key_hi, values, n_buckets, layout,
                                 GOLDEN)
    out = _launch(key_lo, key_hi, values, n_buckets, layout, GOLDEN)
    build_bucketed.launches += 1
    return out


build_wide.launches = 0
build_bucketed.launches = 0


# ---------------------------------------------------------------------------
# the close set's union table
# ---------------------------------------------------------------------------

class UnionRows(NamedTuple):
    """A union's distinct keys grouped by home row at ``MAX_WIDE_ROWS``,
    from :func:`union_dedupe`, for :func:`union_build`."""

    n_keys: int         # distinct real keys (a partial count where bad)
    bad: bool           # a row at MAX_WIDE_ROWS holds more than SLOTS keys
    scratch: torch.Tensor | None   # CUDA: the kernel's grouped keys
    n_raw: int          # CUDA: the raw keys the scratch was carved for
    keys: tuple | None  # CPU: the sorted distinct (lo, hi) uint32 arrays


def union_scratch_bytes(n: int) -> int:
    """Device scratch of ``kan_union_dedupe`` over ``n`` raw keys, as
    ``carve_union`` in ``csrc/table_build.cu`` lays it out: row counts,
    the scan's status words (8 B a tile) and ticket (zeroed); each row's
    run end (8 B); each key's (lo, hi) grouped by row (8 B)."""
    return (_align16(_align16(4 * MAX_WIDE_ROWS)
                     + 8 * (MAX_WIDE_ROWS // SCAN_TILE) + 4)
            + _align16(8 * MAX_WIDE_ROWS) + _align16(8 * n))


def _homes(lo: np.ndarray, hi: np.ndarray,
           n_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """Each key's home row at salt ``GOLDEN`` over ``n_rows`` rows, and
    the keys each row holds."""
    home = (mix_kmer_salted_np(lo, hi, GOLDEN)
            & np.uint32(n_rows - 1)).astype(np.int64)
    return home, np.bincount(home, minlength=n_rows)


def union_table_plain(u_lo: np.ndarray, u_hi: np.ndarray,
                      n_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's table of sorted distinct keys, in NumPy: each key in
    its home row at ``GOLDEN``, at its rank by key among the row's, EMPTY
    and 0 past them; a row of more than ``SLOTS`` keys is left empty and
    sets ``bad``.  (table ``(n_rows, 72)`` int32, bad 0-dim bool)."""
    home, cnt = _homes(u_lo, u_hi, n_rows)
    order = np.argsort(home, kind="stable")
    hb = home[order]
    slot = np.arange(len(hb)) - (np.cumsum(cnt) - cnt)[hb]
    keep = cnt[hb] <= SLOTS
    table = np.zeros((n_rows, 3 * SLOTS), np.uint32)
    table[:, : 2 * SLOTS] = EMPTY
    rows, slot, at = hb[keep], slot[keep], order[keep]
    table[rows, slot] = u_lo[at]
    table[rows, SLOTS + slot] = u_hi[at]
    return (torch.from_numpy(table.view(np.int32)),
            torch.tensor(bool((cnt > SLOTS).any())))


def union_dedupe(key_lo: torch.Tensor, key_hi: torch.Tensor) -> UnionRows:
    """The distinct real keys of raw 1-D int32 keys (duplicates and EMPTY
    pads allowed), grouped by home row at ``MAX_WIDE_ROWS``, with their
    count and ``bad``: one read of the device.  ``n_keys`` decides the
    table's rows (``wide_rows_for``); where ``bad`` no table is built."""
    for name, t in (("key_lo", key_lo), ("key_hi", key_hi)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"union build: {name} must be 1-D int32")
    if key_lo.shape != key_hi.shape or key_lo.device != key_hi.device:
        raise ValueError("union build: keys must have one shape and device")
    if not _on_card(key_lo):
        lo = key_lo.numpy().view(np.uint32)
        hi = key_hi.numpy().view(np.uint32)
        real = lo != EMPTY
        keys = np.unique(hi[real].astype(np.uint64) << np.uint64(32)
                         | lo[real])
        u_lo = (keys & np.uint64(MASK32)).astype(np.uint32)
        u_hi = (keys >> np.uint64(32)).astype(np.uint32)
        _, cnt = _homes(u_lo, u_hi, MAX_WIDE_ROWS)
        return UnionRows(len(keys), bool((cnt > SLOTS).any()), None, 0,
                         (u_lo, u_hi))
    lo, hi = key_lo.contiguous(), key_hi.contiguous()
    n = lo.numel()
    if n >= 1 << 31:
        raise ValueError(f"union build: {n} keys pass the kernel's int32 "
                         f"positions")
    dev = lo.device
    n_scratch = union_scratch_bytes(n)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
    totals = torch.empty(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = kernels.lib().kan_union_dedupe(
            lo.data_ptr(), hi.data_ptr(), n, scratch.data_ptr(), n_scratch,
            totals.data_ptr(), kernels.stream_of(lo))
    kernels.check(err, "union dedupe kernel")
    union_dedupe.launches += 1
    n_keys, bad = totals.tolist()
    return UnionRows(n_keys, bool(bad), scratch, n, None)


def union_build(rows: UnionRows,
                n_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The union's wide table (``(n_rows, 72)`` int32, payload 0, salt
    ``GOLDEN``) and ``bad``, a 0-dim bool tensor: True when a row holds
    more than ``SLOTS`` keys.  ``n_rows`` is a power of two up to
    ``MAX_WIDE_ROWS``; ``rows`` must not be bad."""
    if rows.bad:
        raise ValueError("union build: the keys' dedupe reported bad")
    if not 1 <= n_rows <= MAX_WIDE_ROWS or n_rows & (n_rows - 1):
        raise ValueError(f"union build: rows must be a power of two up to "
                         f"{MAX_WIDE_ROWS}, got {n_rows}")
    if rows.scratch is None:
        return union_table_plain(*rows.keys, n_rows)
    dev = rows.scratch.device
    table = torch.empty((n_rows, 3 * SLOTS), dtype=torch.int32, device=dev)
    bad = torch.empty((), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = kernels.lib().kan_union_build(
            rows.scratch.data_ptr(), rows.n_raw, n_rows, table.data_ptr(),
            bad.data_ptr(), kernels.stream_of(table))
    kernels.check(err, "union build kernel")
    union_build.launches += 1
    return table, bad


union_dedupe.launches = 0
union_build.launches = 0
