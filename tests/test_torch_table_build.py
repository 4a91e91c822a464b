"""The device table builds against the JAX reference, on the CPU.

The port's plain versions of ``build_wide_table_device`` and
``build_table_device`` (``ops/table_build.py``, the plain side of
``csrc/table_build.cu``) against the reference's (``ops/widetable.py:153``,
``ops/hashtable.py:129``, run under JAX on the CPU): table and ``bad`` bit
for bit on EMPTY-padded random keys and on forced overflows, walks and
wraps.  Then the projection engine: the port's ``_close_set`` and
``_close_table`` (both layouts) against the reference's, every table,
salt and probe bound equal, and the host fallback, taken when a device
build reports ``bad``, giving the reference's features.  Tolerance 0.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kmers_anno_tpu.engine import projection as ref
from kmers_anno_tpu.ops import hashtable as ref_hashtable
from kmers_anno_tpu.ops import widetable as ref_widetable
from kmers_anno_tpu_torch.engine import projection as port
from kmers_anno_tpu_torch.ops import hashtable, table_build, widetable
from kmers_anno_tpu_torch.ops.hashing import GOLDEN

from chip_smoke import TABLE_BUILD_EDGES, edge_keys, padded_keys, random_keys
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
