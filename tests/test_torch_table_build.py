"""The device table builds against the JAX reference, on the CPU.

The port's plain versions of the reference's ``build_wide_table_device``
and ``build_table_device`` (``ops/table_build.py``'s ``build_wide`` and
``build_bucketed`` at ``BUCKETED``, the plain side of
``csrc/table_build.cu``) against the reference's (``ops/widetable.py:153``,
``ops/hashtable.py:129``, run under JAX on the CPU): table and ``bad`` bit
for bit on EMPTY-padded random keys and on forced overflows, walks and
wraps.  The kernel's placement by rows (row counts, their exclusive
sums, a max-scan over rows, each key's rank among its home's keys by input
index, each row written from the runs that reach it), written out in
numpy here, against the plain version key by key.  The 8-slot build's
longest walk (``build_table_plain``) against the host ``build_table``'s
``max_probes - 1`` and the kernel's row-by-row walk, and hashAnno's
layout (``OPEN_WALK``: no walk bound, the keys past the last row placed
from row 0, written out in numpy as the kernel's wrap pass places them)
against the host build byte for byte, wraps included.  Then the projection
engine: the port's ``_close_set`` and ``_close_table`` (both layouts)
against the reference's, every table, salt and probe bound equal, the
table cache's eviction by ``table_cache_bytes``, and the host fallback,
taken when a device build reports ``bad``, giving the reference's
features.  The close set's union table from raw keys with duplicates
(``union_dedupe`` / ``union_build``, the plain side of
``kan_union_dedupe`` / ``kan_union_build``) against ``np.unique`` and the
host ``build_wide_table`` byte for byte, its ``bad`` against the host's
overflow at ``GOLDEN`` and the engine's salt-retry fallback on it, and the
close-set cache's eviction before a build.  Tolerance 0.
"""

import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kmers_anno_tpu.engine import projection as ref
from kmers_anno_tpu.ops import hashtable as ref_hashtable
from kmers_anno_tpu.ops import widetable as ref_widetable
from kmers_anno_tpu_torch.engine import projection as port
from kmers_anno_tpu_torch.ops import hashtable, table_build, widetable
from kmers_anno_tpu_torch.ops.hashing import GOLDEN, mix_kmer_salted_np

from chip_smoke import (TABLE_BUILD_EDGES, UNION_CASES, edge_keys, padded_keys,
                        random_keys, union_keys)
from tests.fixtures import make_projection_pair
from tests.test_fused_scan import _workload

EMPTY = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module's tests run (the suite runs
    in several worker processes; see test_torch_mesh.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(layout, lo, hi, val, n_rows, salt=0):
    """(reference table, reference bad, port table as uint32, port bad)."""
    args = [jnp.asarray(a) for a in (lo, hi, val)]
    mine = [torch.from_numpy(a.view(np.int32).copy()) for a in (lo, hi, val)]
    if layout == "wide":
        rt, rb = ref_widetable.build_wide_table_device(*args, n_rows, salt)
        pt, pb = table_build.build_wide(*mine, n_rows, salt)
    else:
        rt, rb = ref_hashtable.build_table_device(*args, n_rows)
        pt, pb = table_build.build_bucketed(*mine, n_rows,
                                            table_build.BUCKETED)[:2]
    assert pt.dtype == torch.int32 and pb.dtype == torch.bool
    return np.asarray(rt), bool(rb), pt.numpy().view(np.uint32), bool(pb)


# (real keys, padded length, rows, salt): odd counts, pads, full tables
RANDOM_CASES = {
    "odd_with_pads": (1_001, 4_096, 512, 0),
    "odd_salted": (2_999, 4_096, 512, 0x9E3779B9),
    "load_8": (4_095, 4_096, 512, 12_345),
    "crowded": (3_000, 4_096, 128, 0),
    "no_pads": (777, 777, 128, 7),
    "one_key": (1, 8, 2, 0),
    "all_pads": (0, 64, 4, 0),
}


@pytest.mark.parametrize("layout", ["wide", "bucketed"])
@pytest.mark.parametrize("case", list(RANDOM_CASES))
def test_builds_match_reference(layout, case):
    n, n_pad, n_rows, salt = RANDOM_CASES[case]
    rng = np.random.default_rng(n + n_pad)
    lo, hi, val = padded_keys([random_keys(rng, n)], n_pad, rng)
    rt, rb, pt, pb = _both(layout, lo, hi, val, n_rows, salt)
    np.testing.assert_array_equal(pt, rt)
    assert pb == rb
    placed = int((pt[:, : pt.shape[1] // 3] != EMPTY).sum())
    assert placed == n or rb          # every real key kept unless bad


@pytest.mark.parametrize("case", list(TABLE_BUILD_EDGES))
def test_forced_overflows_match_reference(case):
    layout, parts, keys, n_rows, salt, want_bad = edge_keys(case)
    rt, rb, pt, pb = _both(layout, *keys, n_rows, salt)
    np.testing.assert_array_equal(pt, rt)
    assert pb == rb == want_bad
    if case == "bucket_walk_of_1":
        # the ninth key of bucket 3 walked into bucket 4 and was kept
        lo3 = set(parts[0][0].tolist())
        assert sum(w in lo3 for w in pt[3, :8]) == 8
        assert sum(w in lo3 for w in pt[4, :8]) == 1
    if case == "wide_row_of_25":
        # the wide build drops the key that would walk
        assert int((pt[:, :24] != EMPTY).sum()) == sum(
            len(p[0]) for p in parts) - 1


def test_wrappers_reject_bad_arguments():
    keys = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        table_build.build_wide(keys, keys, keys, 6)
    with pytest.raises(ValueError):
        table_build.build_bucketed(keys, keys[:4], keys, 8,
                                   table_build.BUCKETED)
    with pytest.raises(ValueError):
        table_build.build_wide(keys.to(torch.int64), keys, keys, 8)


def test_plain_builds_launch_nothing():
    """On CPU tensors the wrappers take the plain version: no launch is
    counted."""
    before = (table_build.build_wide.launches,
              table_build.build_bucketed.launches)
    rng = np.random.default_rng(3)
    lo, hi, val = (torch.from_numpy(a.view(np.int32).copy())
                   for a in random_keys(rng, 100))
    table_build.build_wide(lo, hi, val, 128)
    table_build.build_bucketed(lo, hi, val, 128, table_build.BUCKETED)
    assert (table_build.build_wide.launches,
            table_build.build_bucketed.launches) == before


# ---------------------------------------------------------------------------
# the kernel's placement by rows, against the plain version
# ---------------------------------------------------------------------------

def row_placement(lo, hi, n_rows, layout, salt):
    """Each key's slot, the kernel's way, with no sort: row counts, their
    exclusive sums ``start``, the row max-scan ``C[h] = max over h' <= h
    of (h' * S - start[h'])`` and each key's rank among its home's keys by
    input index; ``pos = start + C + rank``.  ``bad`` is a test on each
    row's last key (past the last row is not bad where the layout wraps:
    :func:`wrap_rows` places it).  Returns (pos, -1 for pads; home; start;
    C; bad)."""
    s = layout.slots
    real = lo != EMPTY
    home = (mix_kmer_salted_np(lo, hi, salt)
            & np.uint32(n_rows - 1)).astype(np.int64)
    cnt = np.bincount(home[real], minlength=n_rows)
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    rows = np.arange(n_rows)
    c = np.maximum.accumulate(rows * s - start)
    rank = np.zeros(len(lo), np.int64)
    seen = np.zeros(n_rows, np.int64)
    for i in np.flatnonzero(real):
        rank[i] = seen[home[i]]
        seen[home[i]] += 1
    pos = np.where(real, start[home] + c[home] + rank, -1)
    last = start + c + cnt - 1
    limit = (rows + layout.max_walk) * s
    if not layout.wraps:
        limit = np.minimum(n_rows * s, limit)
    bad = bool(((cnt > 0) & (last >= limit)).any())
    return pos, home, start, c, bad


def rows_written(lo, hi, val, n_rows, layout, salt):
    """The table as the kernel's last pass writes it, row by row: the
    keys in stable order at ``start + rank``; in row h the walkers' run
    ``[h * S, F)``, ``F = start[h] + C[h - 1]``, holds stable index
    ``p - C[h - 1]`` (8-slot layout only: the wide layout drops walkers),
    then the home's own run from ``start[h] + C[h]``; EMPTY and 0 past
    them."""
    s = layout.slots
    pos, home, start, c, _ = row_placement(lo, hi, n_rows, layout, salt)
    real = pos >= 0
    cnt = np.bincount(home[real], minlength=n_rows)
    stable = np.zeros(int(real.sum()), np.int64)
    stable[(pos - c[home])[real]] = np.flatnonzero(real)
    table = np.zeros((n_rows, 3 * s), np.uint32)
    table[:, : 2 * s] = EMPTY
    for h in range(n_rows):
        walkers_end = start[h] + c[h - 1] if h else 0
        first = start[h] + c[h]
        for slot in range(s):
            p = h * s + slot
            if layout.keep_walkers and p < walkers_end:
                at = p - c[h - 1]
            elif first <= p < first + cnt[h]:
                at = start[h] + p - first
            else:
                continue
            i = stable[at]
            table[h, [slot, s + slot, 2 * s + slot]] = lo[i], hi[i], val[i]
    return table


def _hold_rows_to_plain(layout_name, lo, hi, val, n_rows, salt):
    """The row placement against ``build_table_plain``, key by key, and
    the rows written from it against the plain table, bit for bit."""
    layout = (table_build.WIDE if layout_name == "wide"
              else table_build.BUCKETED)
    s = layout.slots
    want, want_bad, _ = table_build.build_table_plain(
        *(torch.from_numpy(a.view(np.int32).copy()) for a in (lo, hi, val)),
        n_rows, layout, salt)
    want = want.numpy().view(np.uint32)
    pos, home, _, _, bad = row_placement(lo, hi, n_rows, layout, salt)
    assert bad == bool(want_bad)
    kept = (pos >= 0) & (pos < n_rows * s)
    if not layout.keep_walkers:
        kept &= pos < (home + 1) * s
    for i in np.flatnonzero(kept):
        h, slot = divmod(int(pos[i]), s)
        assert (want[h, slot], want[h, s + slot], want[h, 2 * s + slot]) == (
            lo[i], hi[i], val[i]), f"key {i}"
    assert int((want[:, :s] != EMPTY).sum()) == int(kept.sum())
    np.testing.assert_array_equal(
        rows_written(lo, hi, val, n_rows, layout, salt), want)


@pytest.mark.parametrize("layout", ["wide", "bucketed"])
@pytest.mark.parametrize("case", list(RANDOM_CASES))
def test_row_placement_matches_plain(layout, case):
    n, n_pad, n_rows, salt = RANDOM_CASES[case]
    rng = np.random.default_rng(n + n_pad)
    lo, hi, val = padded_keys([random_keys(rng, n)], n_pad, rng)
    _hold_rows_to_plain(layout, lo, hi, val, n_rows,
                        salt if layout == "wide" else GOLDEN)


@pytest.mark.parametrize("case", list(TABLE_BUILD_EDGES))
def test_row_placement_on_forced_cases(case):
    layout, _, keys, n_rows, salt, _ = edge_keys(case)
    _hold_rows_to_plain(layout, *keys, n_rows, salt)


def test_forced_cases_cover_the_kernels_edges():
    """The forced cases hold a row longer than a warp, every key in one
    row, a walk through several 8-slot buckets, pads between real keys,
    one real key and key counts off the kernel's block of 256."""
    shapes = {}
    for case in TABLE_BUILD_EDGES:
        layout, _, keys, n_rows, salt, want_bad = edge_keys(case)
        lo = keys[0]
        real = lo != EMPTY
        lay = (table_build.WIDE if layout == "wide"
               else table_build.BUCKETED)
        pos, home, _, _, _ = row_placement(lo, *keys[1:2], n_rows, lay, salt)
        shapes[case] = dict(
            longest=int(np.bincount(home[real]).max()),
            rows=len(np.unique(home[real])),
            walk=int((pos[real] // lay.slots - home[real]).max()),
            pads_between=bool((~real[:-1] & real[1:]).any()),
            n_real=int(real.sum()), n=len(lo), bad=want_bad)
    assert shapes["wide_row_of_300"]["longest"] == 300
    assert shapes["bucket_row_of_300"]["longest"] == 300
    for case in ("wide_all_in_one_row", "bucket_all_in_one_row"):
        assert shapes[case]["rows"] == 1 and shapes[case]["longest"] > 32
    assert shapes["bucket_chain"]["walk"] == 1
    assert not shapes["bucket_chain"]["bad"]
    assert shapes["bucket_chain"]["rows"] >= 4
    for case in ("wide_pads_between", "bucket_pads_between"):
        assert shapes[case]["pads_between"]
    for case in ("wide_one_key", "bucket_one_key"):
        assert shapes[case]["n_real"] == 1
    for case in ("wide_odd_count", "bucket_odd_count"):
        assert shapes[case]["n"] == shapes[case]["n_real"]
        assert shapes[case]["n"] % 256


def test_scan_tile_is_the_kernels():
    """``SCAN_TILE`` (which sizes the wrapper's scratch) is the kernel's
    rows a scan tile, kThreads * kScanItems."""
    path = os.path.join(os.path.dirname(table_build.__file__), "..", "csrc",
                        "table_build.cu")
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    items = int(re.search(r"constexpr int kScanItems = (\d+);", src)[1])
    assert "constexpr int kScanTile = kThreads * kScanItems;" in src
    assert threads * items == table_build.SCAN_TILE


# ---------------------------------------------------------------------------
# the 8-slot build's longest walk; hashAnno's layout with no walk bound
# ---------------------------------------------------------------------------

BUCKET_EDGES = [c for c, v in TABLE_BUILD_EDGES.items() if v[0] == "bucketed"]
# (real keys, buckets): hashAnno's load (table_size_for: under half the
# slots), half full, nearly full, two keys in two buckets, and more keys
# than slots
WALK_RANDOM = {"index_load": (3_850, 1_024), "half": (2_048, 512),
               "nearly_full": (3_990, 512), "two_keys": (2, 2),
               "over_full": (20, 2)}


def _walk_keys(case):
    """A walk case's (lo, hi, val) uint32 arrays and bucket count: a
    bucketed ``TABLE_BUILD_EDGES`` case, a ``WALK_RANDOM`` one or (with
    pads) a ``RANDOM_CASES`` one."""
    if case in WALK_RANDOM:
        n, n_rows = WALK_RANDOM[case]
        rng = np.random.default_rng(n + n_rows)
        return (*random_keys(rng, n), n_rows)
    if case in RANDOM_CASES:
        n, n_pad, n_rows, _ = RANDOM_CASES[case]
        rng = np.random.default_rng(n + n_pad)
        return (*padded_keys([random_keys(rng, n)], n_pad, rng), n_rows)
    _, _, keys, n_rows, _, _ = edge_keys(case)
    return (*keys, n_rows)


def _plain(lo, hi, val, n_rows, layout):
    """``build_table_plain`` on the uint32 arrays: (table as uint32, bad,
    longest walk)."""
    table, bad, walk = table_build.build_table_plain(
        *(torch.from_numpy(a.view(np.int32).copy()) for a in (lo, hi, val)),
        n_rows, layout, GOLDEN)
    assert walk.dtype == torch.int32 and walk.dim() == 0
    return table.numpy().view(np.uint32), bool(bad), int(walk)


def _row_walk(lo, hi, n_rows, layout):
    """The longest walk as the kernel's row pass finds it: each row's last
    key written, ``min(first + cnt - 1, rows * S - 1) // S - h`` where the
    row holds keys and ``first`` is below ``rows * S``."""
    s = layout.slots
    pos, home, start, c, _ = row_placement(lo, hi, n_rows, layout, GOLDEN)
    cnt = np.bincount(home[pos >= 0], minlength=n_rows)
    first = start + c
    rows = np.arange(n_rows)
    live = (cnt > 0) & (first < n_rows * s)
    last = np.minimum(first + cnt - 1, n_rows * s - 1)
    return int(np.max(last[live] // s - rows[live], initial=0))


def wrap_rows(table, lo, hi, val, n_rows):
    """The kernel's wrap pass on the rows written (``OPEN_WALK``): the
    stable order's last ``n_real + C[rows - 1] - rows * S`` keys, the t-th
    into the t-th free slot (an EMPTY lo word) in row order.  Returns the
    longest walk of those keys, ``rows - home + row``, and whether every
    one found a slot; ``table`` is written in place."""
    s = hashtable.BUCKET
    pos, home, _, c, _ = row_placement(lo, hi, n_rows,
                                       table_build.OPEN_WALK, GOLDEN)
    real = pos >= 0
    n_real = int(real.sum())
    n_spill = n_real + int(c[-1]) - n_rows * s
    stable = np.zeros(n_real, np.int64)
    stable[(pos - c[home])[real]] = np.flatnonzero(real)
    most, t = 0, 0
    for r in range(n_rows):
        free = int((table[r, :s] == EMPTY).sum())
        for q in range(free):
            if t >= n_spill:
                break
            i = stable[n_real - n_spill + t]
            slot = s - free + q
            table[r, [slot, s + slot, 2 * s + slot]] = lo[i], hi[i], val[i]
            most = max(most, n_rows - int(home[i]) + r)
            t += 1
    return most, t >= n_spill


WALK_CASES = BUCKET_EDGES + list(WALK_RANDOM)


@pytest.mark.parametrize("case", WALK_CASES)
def test_open_walk_is_the_host_build(case):
    """``OPEN_WALK`` is the host ``build_table``'s table byte for byte and
    its longest walk ``max_probes - 1``, however far keys walk and where
    they wrap past the last bucket; ``bad`` only where the keys outnumber
    the slots, as ``build_table`` refuses them.  ``BUCKETED`` reports the
    same walk of the keys it writes, and bad from a walk of
    ``MAX_DEVICE_PROBES`` on or a wrap."""
    lo, hi, val, n_rows = _walk_keys(case)
    table, bad, walk = _plain(lo, hi, val, n_rows, table_build.OPEN_WALK)
    real = lo != EMPTY
    pos = row_placement(lo, hi, n_rows, table_build.OPEN_WALK, GOLDEN)[0]
    wraps = bool((pos >= n_rows * hashtable.BUCKET).any())
    if real.sum() > n_rows * hashtable.BUCKET:
        assert bad
        with pytest.raises(ValueError):
            hashtable.build_table(lo[real], hi[real], val[real], n_rows)
        return
    assert not bad
    host, max_probes = hashtable.build_table(lo[real], hi[real], val[real],
                                             n_rows)
    np.testing.assert_array_equal(table, host)
    assert walk == max_probes - 1
    _, b_bad, b_walk = _plain(lo, hi, val, n_rows, table_build.BUCKETED)
    if not wraps:
        assert b_walk == walk
    assert b_bad == (wraps or b_walk >= hashtable.MAX_DEVICE_PROBES)


def test_walk_cases_reach_far():
    """The walk cases hold walks of 0, 1, 2 and past 30 buckets with no
    wrap, a wrap placed from bucket 0, and more keys than slots."""
    walks, wrapped, over = set(), False, False
    for case in WALK_CASES:
        lo, hi, val, n_rows = _walk_keys(case)
        _, bad, walk = _plain(lo, hi, val, n_rows, table_build.OPEN_WALK)
        pos = row_placement(lo, hi, n_rows, table_build.OPEN_WALK, GOLDEN)[0]
        wraps = bool((pos >= n_rows * hashtable.BUCKET).any())
        wrapped |= wraps and not bad
        over |= bad
        if not wraps:
            walks.add(walk)
    assert {0, 1, 2} <= walks and max(walks) > 30 and wrapped and over


@pytest.mark.parametrize("layout", ["bucketed", "open_walk"])
@pytest.mark.parametrize("case", WALK_CASES + list(RANDOM_CASES))
def test_kernel_row_walk_is_the_plain_walk(layout, case):
    """The kernel's passes written out in numpy (the rows, then for
    ``OPEN_WALK`` the wrap pass) against the plain version: table, bad and
    longest walk, in both 8-slot layouts."""
    lay = (table_build.BUCKETED if layout == "bucketed"
           else table_build.OPEN_WALK)
    lo, hi, val, n_rows = _walk_keys(case)
    want, want_bad, want_walk = _plain(lo, hi, val, n_rows, lay)
    table = rows_written(lo, hi, val, n_rows, lay, GOLDEN)
    walk = _row_walk(lo, hi, n_rows, lay)
    bad = row_placement(lo, hi, n_rows, lay, GOLDEN)[4]
    if lay.wraps:
        most, placed = wrap_rows(table, lo, hi, val, n_rows)
        walk, bad = max(walk, most), bad or not placed
    np.testing.assert_array_equal(table, want)
    assert (bad, walk) == (want_bad, want_walk)


def test_walk_wrapper_on_cpu_tensors():
    """``build_bucketed`` takes the plain version on CPU tensors (no launch
    counted), in either 8-slot layout, and refuses the wide one."""
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(a.view(np.int32).copy())
            for a in random_keys(rng, 700)]
    before = table_build.build_bucketed.launches
    for lay in (table_build.OPEN_WALK, table_build.BUCKETED):
        got = table_build.build_bucketed(*args, 256, lay)
        want = table_build.build_table_plain(*args, 256, lay, GOLDEN)
        assert torch.equal(got[0], want[0])
        assert (bool(got[1]), int(got[2])) == (bool(want[1]), int(want[2]))
    assert table_build.build_bucketed.launches == before
    with pytest.raises(ValueError):
        table_build.build_bucketed(*args, 256, table_build.WIDE)
    with pytest.raises(ValueError):
        table_build.build_bucketed(*args, 255, table_build.OPEN_WALK)


def test_no_walk_bound_is_past_any_table():
    """``OPEN_WALK``'s bound is past the rows of any table the kernel's
    int32 slot positions can address; it alone wraps."""
    assert (table_build.NO_WALK_BOUND * hashtable.BUCKET >= 1 << 31
            and table_build.OPEN_WALK.keep_walkers
            and table_build.OPEN_WALK.slots == hashtable.BUCKET)
    assert [lay.wraps for lay in (table_build.WIDE, table_build.BUCKETED,
                                  table_build.OPEN_WALK)] == [False, False,
                                                              True]


# ---------------------------------------------------------------------------
# the projection engine's close-genome tables
# ---------------------------------------------------------------------------

def _close_genomes():
    """Four close genomes of different sizes (one past 4,096 singletons,
    so the close set's common row count exceeds the others' own)."""
    olds = []
    for i, n_genes in enumerate((8, 60, 12, 20)):
        _, got = make_projection_pair(seed=20 + i, n_genes=n_genes,
                                      old_id=f"31{i}.1")
        olds.extend(got.values())
    return olds


def _words(table) -> np.ndarray:
    if isinstance(table, torch.Tensor):
        return table.numpy().view(np.uint32)
    return np.asarray(table)


def test_close_set_matches_reference():
    olds = _close_genomes()
    jcs = ref.ProjectionAnnotator(k=8, engine="device")._close_set(olds)
    before = port.host_fallback.count
    pcs = port.ProjectionAnnotator(k=8, device="cpu")._close_set(olds)
    assert port.host_fallback.count == before
    assert len(pcs.tables) == len(olds) == jcs.tables.shape[0]
    assert len({t.shape[0] for t in pcs.tables}) == 1
    assert min(pcs.n_singles) <= 4096 < max(pcs.n_singles)
    for j, t in enumerate(pcs.tables):
        np.testing.assert_array_equal(_words(t), _words(jcs.tables[j]))
    assert pcs.salts == [int(s) for s in np.asarray(jcs.salts)]
    assert max(pcs.mps) == jcs.mp_max == 1
    np.testing.assert_array_equal(_words(pcs.union_table),
                                  _words(jcs.union_table))
    assert (pcs.union_salt, pcs.union_mp) == (int(jcs.union_salt),
                                              jcs.union_mp)
    assert pcs.n_singles == jcs.n_singles
    assert pcs.n_union_keys == jcs.n_union_keys


@pytest.mark.parametrize("layout", ["wide", "bucketed"])
def test_close_table_matches_reference(layout, monkeypatch):
    if layout == "bucketed":
        # every singleton set counts as past the wide table's capacity
        for module in (ref, port):
            monkeypatch.setattr(module, "wide_rows_for", lambda n: None)
    jann = ref.ProjectionAnnotator(k=8, engine="device")
    pann = port.ProjectionAnnotator(k=8, device="cpu")
    for og in _close_genomes():
        want = jann._close_table(og)
        got = pann._close_table(og)
        np.testing.assert_array_equal(_words(got[0]), _words(want[0]))
        assert got[1:4] == want[1:4]           # max_probes, salt, n_keys
        width = 72 if layout == "wide" else 24
        assert got[0].shape[1] == width
        assert got[1] == (1 if layout == "wide"
                          else hashtable.MAX_DEVICE_PROBES)


def test_table_cache_evicts_as_the_reference():
    """With ``table_cache_bytes`` room for the largest table, the port's
    and the reference's caches keep the same close genomes after each
    table of the same sequence."""
    olds = _close_genomes()
    bound = max(port.ProjectionAnnotator(k=8, device="cpu")._close_table(
        og)[0].nbytes for og in olds)
    jann = ref.ProjectionAnnotator(k=8, engine="device",
                                   table_cache_bytes=bound)
    pann = port.ProjectionAnnotator(k=8, table_cache_bytes=bound,
                                    device="cpu")
    assert pann.table_cache_bytes == bound
    kept = []
    for j in (0, 1, 2, 3, 0, 2, 1, 1, 3):
        jann._close_table(olds[j])
        pann._close_table(olds[j])
        kept.append(list(pann._table_cache))
        assert list(pann._table_cache) == list(jann._table_cache)
    assert min(len(k) for k in kept) == 1 < max(len(k) for k in kept)


def _stats_and_features(annot):
    genome, olds = _workload()
    stats = annot.annotate_genome(genome, olds.get)
    return stats, [(f.id, f.function, f.location.contig_id,
                    f.location.strand, f.location.left, f.location.right,
                    f.protein_translation) for f in genome.features]


@pytest.mark.parametrize("route", ["fused", "rle_wide", "rle_bucketed"])
def test_host_fallback_on_bad_gives_the_same_features(route, monkeypatch):
    """Every device build reports ``bad``: each close genome's table is
    then the host build, and the features are the reference's."""
    want = _stats_and_features(ref.ProjectionAnnotator(k=8,
                                                       engine="device"))
    if route == "rle_bucketed":
        monkeypatch.setattr(port, "wide_rows_for", lambda n: None)

    def bad(build):
        def forced(*args):
            return build(*args)[0], torch.tensor(True)
        return forced

    monkeypatch.setattr(port, "build_wide", bad(port.build_wide))
    monkeypatch.setattr(port, "build_bucketed", bad(port.build_bucketed))
    annot = port.ProjectionAnnotator(k=8, device="cpu")
    if route != "fused":
        annot._close_set = lambda olds_: None
    before = port.host_fallback.count
    got = _stats_and_features(annot)
    assert port.host_fallback.count - before == 3      # one a close genome
    assert got == want and got[0]["pegs"] > 0
    tables = (next(iter(annot._closeset_cache.values())).salts
              if route == "fused"
              else [e[2] for e in annot._table_cache.values()])
    if route == "rle_bucketed":
        assert tables == [None] * 3
    else:
        assert all(s == GOLDEN for s in tables)   # the host build's salt


# ---------------------------------------------------------------------------
# the close set's union table from raw keys
# ---------------------------------------------------------------------------

def _int32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(
        np.int32).copy())


def _host_union(lo, hi):
    """The reference's union: ``np.unique`` of the real keys, then
    ``build_wide_table`` with payload 0 (salt retries and all)."""
    real = lo != EMPTY
    keys = np.unique(hi[real].astype(np.uint64) << np.uint64(32) | lo[real])
    u_lo = (keys & np.uint64(EMPTY)).astype(np.uint32)
    u_hi = (keys >> np.uint64(32)).astype(np.uint32)
    table, salt, mp = widetable.build_wide_table(
        u_lo, u_hi, np.zeros(len(keys), np.uint32))
    return u_lo, u_hi, table, salt, mp


# the realistic union (~9M raw keys) is the card tests'
UNION_GOOD = [c for c, (_, bad) in UNION_CASES.items()
              if bad is None and c != "realistic"]
UNION_BAD = [c for c, (_, bad) in UNION_CASES.items() if bad]


@pytest.mark.parametrize("case", UNION_GOOD)
def test_union_build_matches_unique_and_host_build(case):
    lo, hi = union_keys(case)
    u_lo, u_hi, want, salt, mp = _host_union(lo, hi)
    rows = table_build.union_dedupe(_int32(lo), _int32(hi))
    assert (rows.n_keys, rows.bad) == (len(u_lo), False)
    n_rows = widetable.wide_rows_for(rows.n_keys)
    assert n_rows == UNION_CASES[case][0] == want.shape[0]
    table, bad = table_build.union_build(rows, n_rows)
    assert not bool(bad) and (salt, mp) == (GOLDEN, 1)
    assert table.dtype == torch.int32 and table.shape == (n_rows, 72)
    np.testing.assert_array_equal(table.numpy().view(np.uint32), want)
    # the kernel's fold: every key sits in the row its home at the cap's
    # rows is congruent to
    cap_home = mix_kmer_salted_np(u_lo, u_hi, GOLDEN) & np.uint32(
        widetable.MAX_WIDE_ROWS - 1)
    row, slot = np.nonzero(want[:, :24] != EMPTY)
    placed = (want[row, 24 + slot].astype(np.uint64) << np.uint64(32)
              | want[row, slot])
    order = np.argsort(placed)
    np.testing.assert_array_equal(
        placed[order], u_hi.astype(np.uint64) << np.uint64(32) | u_lo)
    np.testing.assert_array_equal(row[order], cap_home % n_rows)
    if case == "table_row_of_24":
        assert int((want[5, :24] != EMPTY).sum()) == 24


@pytest.mark.parametrize("case", UNION_BAD)
def test_union_row_of_25_is_bad_and_falls_back(case):
    """25 distinct keys in one home: at the cap's rows the dedupe reports
    ``bad``; spread over the cap's rows but in one row of the table, the
    table build does.  The engine then takes the host's ``np.unique`` and
    salt-retry build, counted by ``host_fallback``."""
    lo, hi = union_keys(case)
    u_lo, u_hi, want, salt, mp = _host_union(lo, hi)
    n_rows, where = UNION_CASES[case]
    assert widetable.wide_rows_for(len(u_lo)) == n_rows
    rows = table_build.union_dedupe(_int32(lo), _int32(hi))
    assert rows.bad == (where == "dedupe")
    if not rows.bad:
        _, bad = table_build.union_build(rows, n_rows)
        assert bool(bad)
    else:
        with pytest.raises(ValueError):
            table_build.union_build(rows, n_rows)
    assert salt != GOLDEN                 # the host retried its salt
    annot = port.ProjectionAnnotator(k=8, device="cpu")
    before = port.host_fallback.count
    got = annot._union_table([(lo, hi, None, None)])
    assert port.host_fallback.count == before + 1
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), want)
    assert got[1:] == (salt, mp, len(u_lo))


def test_union_wrappers_reject_bad_arguments():
    keys = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        table_build.union_dedupe(keys.to(torch.int64), keys)
    with pytest.raises(ValueError):
        table_build.union_dedupe(keys, keys[:4])
    rows = table_build.union_dedupe(keys, keys)
    for n_rows in (0, 96, 2 * widetable.MAX_WIDE_ROWS):
        with pytest.raises(ValueError):
            table_build.union_build(rows, n_rows)
    before = (table_build.union_dedupe.launches,
              table_build.union_build.launches)
    table_build.union_build(rows, 128)
    assert (table_build.union_dedupe.launches,
            table_build.union_build.launches) == before


def test_union_scratch_is_the_kernels():
    """``union_scratch_bytes`` is ``carve_union``'s layout: the row cap
    is ``MAX_WIDE_ROWS`` and the salt ``GOLDEN`` in both."""
    path = os.path.join(os.path.dirname(table_build.__file__), "..", "csrc",
                        "table_build.cu")
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    rows_log2 = int(re.search(
        r"constexpr int64_t kUnionRows = int64_t\{1\} << (\d+);", src)[1])
    golden = int(re.search(r"constexpr uint32_t kGolden = (0x[0-9A-F]+)u;",
                           src)[1], 16)
    assert (1 << rows_log2, golden) == (widetable.MAX_WIDE_ROWS, GOLDEN)
    rows = widetable.MAX_WIDE_ROWS
    assert table_build.union_scratch_bytes(0) == (
        4 * rows + 8 * rows // table_build.SCAN_TILE + 16 + 8 * rows)
    assert (table_build.union_scratch_bytes(3)
            - table_build.union_scratch_bytes(0)) == 32


def test_close_set_evicts_the_oldest_before_building():
    """On a miss with a full cache, the oldest set goes before the union's
    keys are touched, and the cache never holds more than 4 sets."""
    olds = _close_genomes()
    annot = port.ProjectionAnnotator(k=8, device="cpu")
    seen = []
    dedupe = port.union_dedupe

    def spy(*args):
        seen.append(list(annot._closeset_cache))
        return dedupe(*args)

    port.union_dedupe = spy
    try:
        orders = [olds, olds[::-1], olds[1:] + olds[:1], olds[2:] + olds[:2],
                  olds[3:] + olds[:3], olds]
        keys = [(tuple(og.id for og in o), 8) for o in orders]
        for o in orders:
            annot._close_set(o)
            assert len(annot._closeset_cache) <= 4
    finally:
        port.union_dedupe = dedupe
    assert [len(s) for s in seen] == [0, 1, 2, 3, 3, 3]
    assert seen[4] == keys[1:4]           # the first set went before
    assert seen[5] == keys[2:5]           # ... and then the second
    assert list(annot._closeset_cache) == keys[2:6]
