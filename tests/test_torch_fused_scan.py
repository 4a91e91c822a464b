"""The port's fused stream route against the JAX reference on the CPU.

Module by module (the f64-exact weak threshold table, the device ORF
scans and ``orf_state``, the union probe and compaction, the per-genome
window scan's stored rows and stats against the reference's flat buffer)
and as a whole (the annotator against the reference's
``engine="device"``, which takes the fused route on the CPU, and against
the port's own RLE route).  Every comparison is exact.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmers_anno_tpu.engine import projection as ref
from kmers_anno_tpu_torch.device import min_ev_table
from kmers_anno_tpu_torch.engine import projection as port
from kmers_anno_tpu_torch.engine.convert import stream_index_from_jax
from tests.test_fused_scan import _multi_contig_workload, _workload

CPU = torch.device("cpu")
TRACE = "Projected role number 3"
LOGGER = "kmers_anno_tpu_torch.engine.projection"
REF_LOGGER = "kmers_anno_tpu.engine.projection"

CASES = {
    "merges": (_workload, {}),
    "multicontig_defaults": (_multi_contig_workload, {}),
    "multicontig_weak_small": (_multi_contig_workload,
                               dict(min_strength=0.9, min_evidence=60)),
    "multicontig_tight_fuzz": (_multi_contig_workload,
                               dict(min_fuzz=1.0, max_fuzz=1.1)),
}


@pytest.mark.parametrize("strength", [0.5 / 3, 0.9 / 3, 0.1, 1 / 7, 0.33])
def test_min_ev_table_matches_jax(strength):
    got = min_ev_table(strength, 5000)
    np.testing.assert_array_equal(got, ref._min_ev_table(strength, 5000))
    assert got.dtype == np.int32


def test_orf_state_matches_jax():
    """The six scan arrays and the per-contig offsets and lengths of a
    two-contig genome, each built in its own package."""
    genome, _ = _multi_contig_workload()
    jidx = ref.StreamWindowIndex.build(genome, 8, interpret=True)
    idx = port.StreamWindowIndex.build(genome, 8, False, CPU)
    assert len(idx.contig_codes) == 2
    for a, b in zip(idx.contig_codes, jidx.contig_codes):
        np.testing.assert_array_equal(a, b)
    (scans, off, lens), (jscans, joff, jlens) = (idx.orf_state(),
                                                 jidx.orf_state())
    assert len(scans) == len(jscans) == 6
    for a, b in zip(scans, jscans):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    assert idx.orf_state()[0] is scans                  # cached


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_next_prev_true_match_jax(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(3 * 401) < 0.05 * (seed + 1)
    mask[-5:] = False                       # a tail with no later True
    t = torch.from_numpy(mask)
    np.testing.assert_array_equal(port._next_true_dev(t).numpy(),
                                  np.asarray(ref._next_true_dev(
                                      jnp.asarray(mask))))
    np.testing.assert_array_equal(port._prev_true_dev(t).numpy(),
                                  np.asarray(ref._prev_true_dev(
                                      jnp.asarray(mask))))


def _both_close_sets(make, params):
    new_g, olds = make()
    loaded = [olds[cg.genome_id] for cg in new_g.close_genomes]
    jann = ref.ProjectionAnnotator(k=8, engine="device", **params)
    pann = port.ProjectionAnnotator(k=8, device=CPU, **params)
    return new_g, loaded, jann, jann._close_set(loaded), pann, \
        pann._close_set(loaded)


def _ref_union(jcs, jidx, ucap):
    d_segs = (jnp.asarray(jidx.seg_start.astype(np.int32)),
              jnp.asarray(jidx.seg_contig), jnp.asarray(jidx.seg_strand),
              jnp.asarray(jidx.seg_len.astype(np.int32)))
    return ref._union_compact(
        jcs.union_table, jcs.union_salt, jidx.d_lo, jidx.d_hi,
        jidx.d_valid, *d_segs, k=8, ucap=ucap, max_probes=jcs.union_mp)


@pytest.mark.parametrize("case", ["merges", "multicontig_defaults"])
def test_union_compact_matches_jax(case):
    new_g, _, _, jcs, _, cs = _both_close_sets(*CASES[case])
    jidx = ref.StreamWindowIndex.build(new_g, 8, interpret=True)
    idx = stream_index_from_jax(jidx, CPU)
    np.testing.assert_array_equal(
        cs.union_table.numpy().view(np.uint32), np.asarray(jcs.union_table))
    assert (cs.union_salt, cs.union_mp, cs.n_union_keys, cs.max_delta) == (
        int(jcs.union_salt), jcs.union_mp, jcs.n_union_keys, jcs.max_delta)
    lo_c, hi_c, klo, base = port._union_compact(
        cs.union_table, cs.union_salt, cs.union_mp, idx)
    n_stream = int(jidx.d_lo.shape[0])
    want = [np.asarray(x) for x in _ref_union(jcs, jidx, n_stream)]
    n_union = int(want[4])
    assert n_union == lo_c.numel() > 0
    for got, w in zip((lo_c, hi_c, klo, base), want[:4]):
        np.testing.assert_array_equal(got.numpy(),
                                      w[:n_union].astype(np.int64))


@pytest.mark.parametrize("case", list(CASES))
def test_scan_genomes_matches_jax(case):
    """Per close genome, the stored rows and the 10 stats equal the
    reference's flat buffer (caps set so that nothing is cut)."""
    make, params = CASES[case]
    new_g, _, jann, jcs, pann, cs = _both_close_sets(make, params)
    jidx = ref.StreamWindowIndex.build(new_g, 8, interpret=True)
    idx = port.StreamWindowIndex.build(new_g, 8, False, CPU)
    u = port._union_compact(cs.union_table, cs.union_salt, cs.union_mp,
                            idx)
    got = port._scan_genomes(cs.tables, cs.salts, cs.mps, cs.pinfo, u,
                             idx.orf_state(), pann._minev_for(idx),
                             pann.min_evidence, 8)

    cap = u[0].numel()
    scans, orf_off, contig_len = jidx.orf_state()
    flat = np.asarray(ref._scan_genomes(
        jcs.tables, jcs.salts, jcs.pinfo, *_ref_union(jcs, jidx, cap),
        scans, orf_off, contig_len, jann._minev_for(jidx),
        jnp.int32(jann.min_evidence), k=8, ucap=cap, pcap=cap, lcap=cap,
        scap=cap, max_probes=jcs.mp_max))
    g = len(jcs.peg_infos)
    assert len(got) == g >= 2
    rows_all = flat[: g * cap * 8].reshape(g, cap, 8)
    stats_all = flat[g * cap * 8: g * cap * 8 + g * 10].reshape(g, 10)
    assert int(flat[-1]) == cap
    for j, (rows, stats) in enumerate(got):
        assert stats == stats_all[j].tolist()
        assert rows.dtype == np.int64 and rows.shape == (stats[8], 8)
        np.testing.assert_array_equal(rows, rows_all[j, : stats[8]])
    assert sum(s[9] for _, s in got) > 0                # candidates
    if case != "multicontig_tight_fuzz":    # there, all are too short
        assert sum(s[8] for _, s in got) > 0
    if case == "merges":       # later genomes store merges over earlier
        assert sum(s[8] for _, s in got[1:]) > 0


def _annotate(make, annot, logger, caplog):
    genome, olds = make()
    with caplog.at_level(logging.INFO, logger=logger):
        caplog.clear()
        stats = annot.annotate_genome(genome, olds.get)
    lines = [r.getMessage() for r in caplog.records if r.name == logger
             and ("Proposal stored" in r.getMessage()
                  or "matching kmers" in r.getMessage()
                  or "peg/frame" in r.getMessage()
                  or "unique peg kmers" in r.getMessage())]
    feats = [(f.id, f.function, f.location.contig_id, f.location.strand,
              f.location.left, f.location.right, f.protein_translation,
              tuple(a[0] for a in f.raw.get("annotations", [])))
             for f in genome.features]
    return stats, feats, lines


def _spy(monkeypatch, module):
    calls = []
    orig = module._scan_genomes

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(module, "_scan_genomes", spy)
    return calls


@pytest.mark.parametrize("case", list(CASES))
def test_fused_annotator_matches_jax(case, caplog, monkeypatch):
    """Both packages take their fused route; stats, features, log and
    --trace lines are equal."""
    make, params = CASES[case]
    ref_calls = _spy(monkeypatch, ref)
    port_calls = _spy(monkeypatch, port)
    want = _annotate(make, ref.ProjectionAnnotator(
        k=8, engine="device", trace_function=TRACE, **params),
        REF_LOGGER, caplog)
    got = _annotate(make, port.ProjectionAnnotator(
        k=8, device=CPU, trace_function=TRACE, **params), LOGGER, caplog)
    assert ref_calls == port_calls == [1]
    assert got == want
    assert any(line.endswith("matching kmers found.")
               and not line.startswith("0 ") for line in got[2])
    if case == "merges":
        assert got[0]["merged"] > 0
        assert any("Proposal stored" in line for line in got[2])
    if case == "multicontig_weak_small":
        assert got[0]["weak"] > 0 or got[0]["small"] > 0


@pytest.mark.parametrize("case", list(CASES))
def test_fused_route_matches_rle_route(case, caplog):
    make, params = CASES[case]
    fused = _annotate(make, port.ProjectionAnnotator(
        k=8, device=CPU, trace_function=TRACE, **params), LOGGER, caplog)
    rle_annot = port.ProjectionAnnotator(k=8, device=CPU,
                                         trace_function=TRACE, **params)
    rle_annot._close_set = lambda olds_: None
    rle = _annotate(make, rle_annot, LOGGER, caplog)
    assert fused == rle
    assert rle_annot._table_cache and not rle_annot._closeset_cache


def test_fused_route_taken_and_close_set_cached(monkeypatch):
    calls = _spy(monkeypatch, port)
    annot = port.ProjectionAnnotator(k=8, device=CPU)
    rle_calls = []
    monkeypatch.setattr(annot, "_project_all_stream_rle",
                        lambda *a: rle_calls.append(1))
    new_g, olds = _workload()
    first = annot.annotate_genome(new_g, olds.get)
    assert calls == [1] and not rle_calls
    assert len(annot._closeset_cache) == 1
    cs = next(iter(annot._closeset_cache.values()))
    new_g2, _ = _workload()
    assert annot.annotate_genome(new_g2, olds.get) == first
    assert calls == [1, 1] and not rle_calls
    assert len(annot._closeset_cache) == 1
    assert next(iter(annot._closeset_cache.values())) is cs  # not rebuilt
    assert first["pegs"] > 0 and first["merged"] > 0


@pytest.mark.parametrize("field,bits,make", [
    ("_CONTIG_BITS", 0, _multi_contig_workload),    # 2 contigs > 2^0
    ("_LEFT_BITS", 10, _workload),                  # contig > 2^10 bases
])
def test_field_width_overflow_takes_rle_route(monkeypatch, field, bits,
                                              make):
    """The reference's own field-width test picks the route: a genome
    that exceeds a packed-key field goes the RLE way, with the same
    result."""
    calls = _spy(monkeypatch, port)
    new_g, olds = make()
    want = port.ProjectionAnnotator(k=8, device=CPU).annotate_genome(
        new_g, olds.get)
    monkeypatch.setattr(port, field, bits)
    new_g2, _ = make()
    got = port.ProjectionAnnotator(k=8, device=CPU).annotate_genome(
        new_g2, olds.get)
    assert calls == [1] and got == want and got["pegs"] > 0
