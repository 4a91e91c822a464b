"""The port's projection slice against the JAX reference on the CPU.

Module by module (the Q1 and STRICT masks on a shared state, the stream
window index, the peg singletons, the per-close-genome hits against the
reference's expanded RLE runs) and as a whole: the port's annotator
against the reference's ``engine="device"`` annotator, with equal stats,
features and ``--trace`` lines.  Every comparison is exact.
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmers_anno_tpu.engine import projection as ref
from kmers_anno_tpu.genome.gto import Genome
from kmers_anno_tpu_torch.engine import projection as port
from kmers_anno_tpu_torch.engine.convert import (stream_index_from_jax,
                                                 wide_table_from_numpy)
from tests.fixtures import make_projection_pair
from tests.test_fused_scan import _multi_contig_workload, _workload

CPU = torch.device("cpu")
TRACE = "Projected role number 3"


def _doubled_contig_genome():
    """Two copies of one contig, so every kmer has two locations and
    STRICT mode drops them, plus a third, distinct contig."""
    new_g, olds = make_projection_pair(seed=5, n_genes=6)
    raw = json.loads(json.dumps(new_g.raw))
    twin = dict(raw["contigs"][0], id="twin")
    other, _ = make_projection_pair(seed=6, n_genes=4)
    raw["contigs"] += [twin, dict(other.raw["contigs"][0], id="other")]
    return Genome(raw), olds


@pytest.mark.parametrize("k", [8, 12])
def test_q1_mask_matches_jax(k):
    rng = np.random.default_rng(k)
    lens = np.array([1, 3 * k - 1, 3 * k, 3 * k + 2, 101, 5000, 77],
                    np.int64)
    starts = np.concatenate([[0], np.cumsum(lens + 3 * k)[:-1]])
    n_pad = int(starts[-1] + lens[-1] + 3 * k + 13)
    bad = (rng.random(n_pad) < 0.1).astype(np.int32)
    want = np.asarray(ref._q1_mask(
        jnp.asarray(starts.astype(np.int32)),
        jnp.asarray(lens.astype(np.int32)), jnp.asarray(bad),
        k=k, n_pad=n_pad))
    got = port._q1_mask(torch.from_numpy(starts), torch.from_numpy(lens),
                        torch.from_numpy(bad.astype(np.uint8)), k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [8, 12])
def test_strict_window_mask_matches_jax(k):
    genome, _ = _doubled_contig_genome()
    jidx = ref.StreamWindowIndex.build(genome, k, interpret=True)
    idx = stream_index_from_jax(jidx, CPU)
    want = np.asarray(ref._strict_window_mask(jidx.d_lo, jidx.d_hi,
                                              jidx.d_valid))
    got = port._strict_window_mask(idx.d_lo, idx.d_hi, idx.d_valid)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < np.asarray(jidx.d_valid).sum()


@pytest.mark.parametrize("k", [8, 12])
@pytest.mark.parametrize("strict", [False, True])
def test_stream_index_matches_jax(k, strict):
    genome, _ = _doubled_contig_genome()
    jidx = ref.StreamWindowIndex.build(genome, k, strict=strict,
                                       interpret=True)
    idx = port.StreamWindowIndex.build(genome, k, strict, CPU)
    for name in ("seg_start", "seg_contig", "seg_strand", "seg_len"):
        np.testing.assert_array_equal(getattr(idx, name),
                                      getattr(jidx, name))
    assert idx.contig_ids == jidx.contig_ids
    assert idx.n_windows == jidx.n_windows
    # the two streams pad to different lengths; past the shorter one
    # nothing is valid, and before it valid windows carry equal keys
    j_valid = np.asarray(jidx.d_valid)
    valid = idx.d_valid.numpy()
    m = min(len(j_valid), len(valid))
    assert not j_valid[m:].any() and not valid[m:].any()
    np.testing.assert_array_equal(valid[:m], j_valid[:m])
    sel = np.flatnonzero(valid[:m])
    assert len(sel)
    np.testing.assert_array_equal(idx.d_lo.numpy()[sel],
                                  np.asarray(jidx.d_lo)[sel])
    np.testing.assert_array_equal(idx.d_hi.numpy()[sel],
                                  np.asarray(jidx.d_hi)[sel])
    pos = sel[:: max(1, len(sel) // 500)]
    for a, b in zip(idx.locate(pos), jidx.locate(pos)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("native_lib", [True, False])
def test_peg_singletons_match_jax(monkeypatch, native_lib):
    _, olds = _workload()
    og = olds["300.1"]
    want = ref.peg_singleton_kmers(og, 8)
    if not native_lib:       # the tensor group-by the port runs without it
        monkeypatch.setattr(port.native, "available", lambda: False)
        monkeypatch.setattr(port.native, "flat_peg_batch",
                            lambda *a: None)
    got = port.peg_singleton_kmers(og, 8, CPU)
    assert [f.id for f in got[3]] == [f.id for f in want[3]]
    assert got[0].dtype == got[1].dtype == np.uint32
    assert got[2].dtype == np.int32
    assert (sorted(zip(*(a.tolist() for a in got[:3])))
            == sorted(zip(*(np.asarray(a).tolist() for a in want[:3]))))
    assert len(got[0]) > 0


def test_hits_match_expanded_rle_runs():
    """The port's nonzero compaction gives exactly the (pos, peg) arrays
    the reference expands from its run-length encoded hits."""
    new_g, olds = _workload()
    jidx = ref.StreamWindowIndex.build(new_g, 8, interpret=True)
    idx = stream_index_from_jax(jidx, CPU)
    jann = ref.ProjectionAnnotator(k=8, engine="device")
    pann = port.ProjectionAnnotator(k=8, device=CPU)
    checked = 0
    for og in olds.values():
        table, mp, salt, n, _ = jann._close_table(og)
        n_stream = int(jidx.d_lo.shape[0])
        starts, pegs, lens, n_runs, n_hits = (np.asarray(x)[0] for x in
                                              ref._probe_rle_multi(
            (table,), jidx.d_lo, jidx.d_hi, jidx.d_valid, cap=n_stream,
            rcap=n_stream, meta=((mp, salt),)))
        n_runs, n_hits = int(n_runs), int(n_hits)
        starts = starts[:n_runs].astype(np.int64)
        lens = lens[:n_runs].astype(np.int64)
        base = np.repeat(np.cumsum(lens) - lens, lens)
        want_pos = np.repeat(starts, lens) + np.arange(n_hits) - base
        want_peg = np.repeat(pegs[:n_runs], lens).astype(np.int32)
        # the reference's own table, carried across, and the port's
        pt, pmp, psalt = pann._close_table(og)[:3]
        for t, salt_, mp_ in ((wide_table_from_numpy(np.asarray(table),
                                                      CPU), salt, mp),
                              (pt, psalt, pmp)):
            pos, peg = port.probe_hits(t, salt_, mp_, idx)
            np.testing.assert_array_equal(pos, want_pos)
            np.testing.assert_array_equal(peg, want_peg)
        checked += n_hits
    assert checked > 0


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

def _with_missing_close_genome():
    """_workload plus a close genome the loader cannot find, listed
    second so the max-genomes count is exercised around the gap."""
    new_g, olds = _workload()
    new_g.raw["close_genomes"].insert(
        1, {"genome": "999.1", "genome_name": "Missing",
            "closeness_measure": 99.5})
    return Genome(json.loads(json.dumps(new_g.raw))), olds


CASES = {
    "merges": (_workload, {}),
    "multicontig_defaults": (_multi_contig_workload, {}),
    "multicontig_weak_small": (_multi_contig_workload,
                               dict(min_strength=0.9, min_evidence=60)),
    "multicontig_tight_fuzz": (_multi_contig_workload,
                               dict(min_fuzz=1.0, max_fuzz=1.1)),
    "strict": (_workload, dict(algorithm="STRICT")),
    "strict_doubled_contig": (_doubled_contig_genome,
                              dict(algorithm="STRICT")),
    "missing_close_genome": (_with_missing_close_genome,
                             dict(max_genomes=3)),
}


def _features(genome):
    return [(f.id, f.function, f.location.contig_id, f.location.strand,
             f.location.left, f.location.right, f.protein_translation,
             tuple(a[0] for a in f.raw.get("annotations", [])))
            for f in genome.features]


def _run(make, annotator, logger, caplog):
    genome, olds = make()
    with caplog.at_level(logging.INFO, logger=logger):
        caplog.clear()
        stats = annotator.annotate_genome(genome, olds.get)
    lines = [r.getMessage() for r in caplog.records if r.name == logger
             and ("Proposal stored" in r.getMessage()
                  or "matching kmers" in r.getMessage()
                  or "peg/frame" in r.getMessage()
                  or "unique peg kmers" in r.getMessage())]
    return stats, _features(genome), lines


@pytest.mark.parametrize("case", list(CASES))
def test_annotator_matches_jax(case, caplog):
    make, params = CASES[case]
    want = _run(make, ref.ProjectionAnnotator(
        k=8, engine="device", trace_function=TRACE, **params),
        "kmers_anno_tpu.engine.projection", caplog)
    got = _run(make, port.ProjectionAnnotator(
        k=8, device="cpu", trace_function=TRACE, **params),
        "kmers_anno_tpu_torch.engine.projection", caplog)
    assert got[0] == want[0]                    # stats
    assert got[1] == want[1]                    # features
    assert got[2] == want[2]                    # log and --trace lines
    if case in ("merges", "missing_close_genome"):
        assert got[0]["pegs"] > 0 and got[0]["merged"] > 0
        assert any("Proposal stored" in line for line in got[2])


def test_annotator_table_cache_reused_across_genomes():
    annot = port.ProjectionAnnotator(k=8, device="cpu")
    new_g, olds = _workload()
    first = annot.annotate_genome(new_g, olds.get)
    cached = {k: v[0] for k, v in annot._table_cache.items()}
    new_g2, _ = _workload()
    assert annot.annotate_genome(new_g2, olds.get) == first
    assert all(annot._table_cache[k][0] is t for k, t in cached.items())


def test_annotator_rejects_bad_parameters():
    with pytest.raises(ValueError):
        port.ProjectionAnnotator(min_strength=1.0, device="cpu")
    with pytest.raises(ValueError):
        port.ProjectionAnnotator(max_fuzz=1.0, device="cpu")
    with pytest.raises(ValueError):
        port.ProjectionAnnotator(min_fuzz=1.5, device="cpu")


def test_genome_without_contigs_proposes_nothing():
    """The reference's device path fails on a genome without contigs
    (ROADMAP queue 3, F2); the port returns empty stats."""
    new_g, olds = _workload()
    raw = json.loads(json.dumps(new_g.raw))
    raw["contigs"] = []
    stats = port.ProjectionAnnotator(k=8, device="cpu").annotate_genome(
        Genome(raw), olds.get)
    assert stats == dict(made=0, merged=0, rejected=0, weak=0, small=0,
                         kept=0, pegs=0)
