"""The port's per-strand contig kmers, its 8-slot table and its RLE
route against the JAX reference on the CPU.

The per-strand contig kmer extraction against both of the reference's
routes (its XLA ``extract_contig_kmers`` and the Pallas scanner's
``extract_contig_kmers_fused`` in interpret mode), the 8-slot table's
build (byte-equal) and probe, and the whole annotator on the RLE route,
both packages forced onto it as the reference's tests force it
(``_close_set`` gives None), with and without STRICT.  Also the close
genome whose singleton set is too large for one wide table: the RLE route
then probes an 8-slot table, as in the reference.  Every comparison is
exact.
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmers_anno_tpu.engine import projection as ref
from kmers_anno_tpu.genome.gto import Genome
from kmers_anno_tpu.ops import contig_kmers as ref_ck
from kmers_anno_tpu.ops import hashtable as ref_ht
from kmers_anno_tpu.ops.pallas_contig import strand_kmers_pallas
from kmers_anno_tpu_torch.engine import projection as port
from kmers_anno_tpu_torch.engine.convert import wide_table_from_numpy
from kmers_anno_tpu_torch.ops import contig_kmers as ck
from kmers_anno_tpu_torch.ops import hashtable as ht
from kmers_anno_tpu_torch.ops.contig_scan import scan_stream
from tests.fixtures import make_projection_pair
from tests.test_fused_scan import _multi_contig_workload, _workload

CPU = torch.device("cpu")
TRACE = "Projected role number 3"
LOGGER = "kmers_anno_tpu_torch.engine.projection"
REF_LOGGER = "kmers_anno_tpu.engine.projection"


# ---------------------------------------------------------------------------
# per-strand contig kmers
# ---------------------------------------------------------------------------

def _contig(seed: int, length: int, alphabet: str = "acgt") -> str:
    """Random bases; with the default alphabet also ambiguous ones."""
    rng = np.random.default_rng(seed)
    seq = np.array(list(alphabet))[rng.integers(0, len(alphabet), length)]
    if alphabet == "acgt":
        seq[rng.random(length) < 0.03] = "n"
        if length > 40:
            seq[17] = "r"
    return "".join(seq)


# edge lengths use g/c only: no codon of either strand is a stop, so the
# kmer count is Q1's alone (3k+3: one per strand, 3k+4: two per strand)
EDGE_LENGTHS = {"3k-1": (-1, 0), "3k": (0, 0), "3k+1": (1, 0),
                "3k+3": (3, 2), "3k+4": (4, 4)}


@pytest.mark.parametrize("k", [8, 12])
@pytest.mark.parametrize("spec", list(EDGE_LENGTHS) + [301, 2000])
def test_extract_contig_kmers_matches_both_reference_routes(k, spec):
    if spec in EDGE_LENGTHS:
        extra, n_kmers = EDGE_LENGTHS[spec]
        seq = _contig(k + extra, 3 * k + extra, "gc")
    else:
        seq = _contig(spec + k, spec)
    got = ck.extract_contig_kmers(seq, k, 11, CPU)
    fused = ref_ck.extract_contig_kmers_fused(seq, k, 11, interpret=True)
    assert set(got) == set(fused) == {"lo", "hi", "left", "strand"}
    for key in fused:                      # same base-major order
        assert got[key].dtype == fused[key].dtype
        np.testing.assert_array_equal(got[key], fused[key])
    xla = ref_ck.extract_contig_kmers(seq, k, 11)     # XLA on the CPU
    rows = sorted(zip(*(got[c].tolist() for c in ("lo", "hi", "left",
                                                   "strand"))))
    assert rows == sorted(zip(*(xla[c].tolist() for c in (
        "lo", "hi", "left", "strand"))))
    if spec in EDGE_LENGTHS:
        assert len(rows) == n_kmers
    else:
        assert {0, 1} == set(got["strand"].tolist())


@pytest.mark.parametrize("k", [8, 12])
@pytest.mark.parametrize("length", [23, 36, 37, 500, 8193])
def test_strand_kmers_match_pallas(k, length):
    from kmers_anno_tpu.ops.encode import encode_dna

    codes = encode_dna(_contig(length, length))
    got = ck.strand_kmers(codes, k, 11, CPU)
    want = strand_kmers_pallas(codes, k, 11, interpret=True)
    assert len(got[0]) == max(length - 3 * k + 1, 0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_strand_kmers_cpu_counts_no_launch():
    before = scan_stream.launches
    ck.extract_contig_kmers(_contig(1, 300), 8, 11, CPU)
    assert scan_stream.launches == before


# ---------------------------------------------------------------------------
# the 8-slot table
# ---------------------------------------------------------------------------

def _keys(rng, n):
    key = np.unique(rng.integers(0, 1 << 59, n * 2 + 2, dtype=np.uint64))
    key = rng.permutation(key)[:n]
    return ((key & np.uint64(0x3FFFFFFF)).astype(np.uint32),
            (key >> np.uint64(30)).astype(np.uint32))


BUILDS = {
    "empty": dict(n=0),
    "small": dict(n=100),
    "large": dict(n=30000),
    "dense": dict(n=2000, load_factor=0.95),
    "device_size": dict(n=5000, n_buckets=ht.device_table_buckets(8192)),
    "walks": dict(n=60, n_buckets=8),              # 60 keys in 64 slots
}


@pytest.mark.parametrize("case", list(BUILDS))
def test_build_table_is_byte_equal_to_reference(case):
    spec = dict(BUILDS[case])
    n = spec.pop("n")
    lo, hi = _keys(np.random.default_rng(n), n)
    vals = np.random.default_rng(n + 1).integers(0, 1 << 31, n).astype(
        np.uint32)
    table, mp = ht.build_table(lo, hi, vals, **spec)
    want, want_mp = ref_ht.build_table(lo, hi, vals, **spec)
    assert table.dtype == np.uint32 and table.shape == want.shape
    np.testing.assert_array_equal(table, want)
    assert mp == want_mp
    assert (ht.table_size_for(n), ht.BUCKET, ht.MAX_DEVICE_PROBES) == (
        ref_ht.table_size_for(n), ref_ht.BUCKET, ref_ht.MAX_DEVICE_PROBES)
    assert ht.device_table_buckets(n) == ref_ht.device_table_buckets(n)
    if case == "walks":
        assert mp > 2


@pytest.mark.parametrize("case", ["small", "large", "dense", "walks"])
def test_probe_table_matches_reference(case):
    """Hits, misses and invalid queries, on tables whose longest walk is
    one bucket or several."""
    spec = dict(BUILDS[case])
    n = spec.pop("n")
    rng = np.random.default_rng(n + 7)
    lo, hi = _keys(rng, 2 * n)
    vals = rng.integers(0, 1 << 31, n).astype(np.uint32)
    table, mp = ht.build_table(lo[:n], hi[:n], vals, **spec)
    q = rng.permutation(2 * n)
    q_lo, q_hi = lo[q], hi[q]
    valid = rng.random(2 * n) >= 0.1
    got = ht.probe_table(wide_table_from_numpy(table, CPU),
                         torch.from_numpy(q_lo.astype(np.int32)),
                         torch.from_numpy(q_hi.astype(np.int32)),
                         torch.from_numpy(valid), mp).numpy()
    want = np.asarray(ref_ht.probe_table(
        jnp.asarray(table), jnp.asarray(q_lo), jnp.asarray(q_hi),
        jnp.asarray(valid), mp))
    np.testing.assert_array_equal(got, want)
    expect = np.where((q < n) & valid, vals[np.minimum(q, n - 1)]
                      .astype(np.int64), -1)
    np.testing.assert_array_equal(got, expect)
    assert (got >= 0).any() and (got < 0).any()


def test_probe_table_rejects_bad_arguments():
    table = wide_table_from_numpy(ht.build_table(
        np.zeros(1, np.uint32), np.zeros(1, np.uint32),
        np.zeros(1, np.uint32))[0], CPU)
    z = torch.zeros(3, dtype=torch.int32)
    v = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError):
        ht.probe_table(table[:, :16], z, z, v, 1)
    with pytest.raises(ValueError):
        ht.probe_table(table, z.long(), z, v, 1)
    with pytest.raises(ValueError):
        ht.probe_table(table, z, z, v, 0)
    with pytest.raises(ValueError):
        ht.probe_table(table[:1].repeat(3, 1), z, z, v, 1)


# ---------------------------------------------------------------------------
# the whole annotator on the RLE route
# ---------------------------------------------------------------------------

def _doubled_contig_genome():
    """Two copies of one contig (so STRICT drops their kmers) plus a
    distinct third contig."""
    new_g, olds = make_projection_pair(seed=5, n_genes=6)
    raw = json.loads(json.dumps(new_g.raw))
    other, _ = make_projection_pair(seed=6, n_genes=4)
    raw["contigs"] += [dict(raw["contigs"][0], id="twin"),
                       dict(other.raw["contigs"][0], id="other")]
    return Genome(raw), olds


def _with_missing_close_genome():
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
    "strict_doubled_contig": (_doubled_contig_genome,
                              dict(algorithm="STRICT")),
    "missing_close_genome": (_with_missing_close_genome,
                             dict(max_genomes=3)),
}


def _run(make, annotator, logger, caplog):
    genome, olds = make()
    with caplog.at_level(logging.INFO, logger=logger):
        caplog.clear()
        stats = annotator.annotate_genome(genome, olds.get)
    lines = [r.getMessage() for r in caplog.records if r.name == logger
             and ("Proposal stored" in r.getMessage()
                  or "kmers found" in r.getMessage()
                  or "peg/frame" in r.getMessage()
                  or "unique peg kmers" in r.getMessage())]
    feats = [(f.id, f.function, f.location.contig_id, f.location.strand,
              f.location.left, f.location.right, f.protein_translation,
              tuple(a[0] for a in f.raw.get("annotations", [])))
             for f in genome.features]
    return stats, feats, lines


def _rle(annotator):
    """The annotator forced onto its RLE route."""
    annotator._close_set = lambda olds_: None
    return annotator


@pytest.mark.parametrize("case", list(CASES))
def test_rle_annotator_matches_jax(case, caplog):
    """Both packages on their RLE route, each close genome's wide table
    probed on its own: stats, features, log and --trace lines equal."""
    make, params = CASES[case]
    want = _run(make, _rle(ref.ProjectionAnnotator(
        k=8, engine="device", trace_function=TRACE, **params)),
        REF_LOGGER, caplog)
    pann = _rle(port.ProjectionAnnotator(
        k=8, device=CPU, trace_function=TRACE, **params))
    before = scan_stream.launches
    got = _run(make, pann, LOGGER, caplog)
    assert scan_stream.launches == before              # CPU: no launch
    assert got == want
    assert pann._table_cache and not pann._closeset_cache
    # STRICT drops every kmer of the twinned contig, the close genomes'
    # only source of hits
    assert any(line.endswith("matching kmers found.")
               and not line.startswith("0 ")
               for line in got[2]) == (case != "strict_doubled_contig")
    if case in ("merges", "missing_close_genome"):
        assert got[0]["pegs"] > 0 and got[0]["merged"] > 0
        assert any("Proposal stored" in line for line in got[2])


# ---------------------------------------------------------------------------
# a close genome too large for one wide table (the 8-slot route)
# ---------------------------------------------------------------------------

def test_huge_singleton_set_takes_8_slot_table(monkeypatch, caplog):
    """With ``wide_rows_for`` refusing every size, both packages take
    the RLE route and give each close genome an 8-slot table; the port
    equals the reference's stats, features and trace lines."""
    monkeypatch.setattr(ref, "wide_rows_for", lambda n: None)
    monkeypatch.setattr(port, "wide_rows_for", lambda n: None)
    jann = ref.ProjectionAnnotator(k=8, engine="device",
                                   trace_function=TRACE)
    want = _run(_workload, jann, REF_LOGGER, caplog)
    pann = port.ProjectionAnnotator(k=8, device=CPU, trace_function=TRACE)
    got = _run(_workload, pann, LOGGER, caplog)
    assert got == want
    assert got[0]["pegs"] > 0 and got[0]["merged"] > 0
    assert not pann._closeset_cache and len(pann._table_cache) == 3
    for key, (table, mp, salt, n, _) in pann._table_cache.items():
        jtable, jmp, jsalt, jn, _ = jann._table_cache[key]
        assert salt is None is jsalt and n == jn
        assert table.shape[1] == 3 * ht.BUCKET
        # the port's host build lays the keys out as the reference's
        # device build does
        np.testing.assert_array_equal(table.numpy().view(np.uint32),
                                      np.asarray(jtable))
        assert mp <= jmp == ht.MAX_DEVICE_PROBES
