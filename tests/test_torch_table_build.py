"""The device table builds against the JAX reference, on the CPU.

The port's plain versions of ``build_wide_table_device`` and
``build_table_device`` (``ops/table_build.py``, the plain side of
``csrc/table_build.cu``) against the reference's (``ops/widetable.py:153``,
``ops/hashtable.py:129``, run under JAX on the CPU): table and ``bad`` bit
for bit on EMPTY-padded random keys and on forced overflows, walks and
wraps.  The kernel's placement by rows (row counts, their exclusive
sums, a max-scan over rows, each key's rank among its home's keys by input
index, each row written from the runs that reach it), written out in
numpy here, against the plain version key by key.  Then the projection
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
        pt, pb = widetable.build_wide_table_device(*mine, n_rows, salt)
    else:
        rt, rb = ref_hashtable.build_table_device(*args, n_rows)
        pt, pb = hashtable.build_table_device(*mine, n_rows)
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
        table_build.build_bucketed(keys, keys[:4], keys, 8)
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
    table_build.build_bucketed(lo, hi, val, 128)
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
    row's last key.  Returns (pos, -1 for pads; home; start; C; bad)."""
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
    bad = bool(((cnt > 0) & (last >= np.minimum(
        n_rows * s, (rows + layout.max_walk) * s))).any())
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
    want, want_bad = table_build.build_table_plain(
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
            table, _ = build(*args)
            return table, torch.tensor(True)
        return forced

    monkeypatch.setattr(port, "build_wide_table_device",
                        bad(port.build_wide_table_device))
    monkeypatch.setattr(port, "build_table_device",
                        bad(port.build_table_device))
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
