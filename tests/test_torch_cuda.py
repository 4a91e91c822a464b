"""The CUDA kernels against their plain-PyTorch versions, on an NVIDIA GPU.

Every test here needs a card and nvcc, carries the ``cuda`` marker and
skips without CUDA.  The file imports no jax, so it also runs where jax is
absent (skipping the repo's jax-forcing conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import json
import logging

import numpy as np
import pytest
import torch

from chip_smoke import make_projection_workload
from kmers_anno_tpu_torch.engine import projection
from kmers_anno_tpu_torch.engine.convert import wide_table_from_numpy
from kmers_anno_tpu_torch.engine.projection import ProjectionAnnotator
from kmers_anno_tpu_torch.host import Genome
from kmers_anno_tpu_torch.ops.contig_kmers import extract_contig_kmers
from kmers_anno_tpu_torch.ops.contig_scan import scan_stream, scan_stream_plain
from kmers_anno_tpu_torch.ops.hashtable import build_table, probe_table
from kmers_anno_tpu_torch.ops.translate import codon_lut
from kmers_anno_tpu_torch.ops.widetable import (build_wide_table, probe_wide,
                                                probe_wide_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("k", [1, 6, 8, 12])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 100_003])
def test_contig_scan_kernel_matches_plain(cuda, k, n):
    rng = np.random.default_rng(n + k)
    codes = rng.integers(0, 5, n).astype(np.uint8)
    stream = torch.from_numpy(codes).to(cuda)
    before = scan_stream.launches
    got = scan_stream(stream, k, codon_lut(11))
    torch.cuda.synchronize()
    assert scan_stream.launches == before + 1
    want = scan_stream_plain(stream, k, codon_lut(11))
    for g, w in zip(got, want):
        assert g.device == stream.device
        assert torch.equal(g, w)


def test_contig_scan_genetic_codes_do_not_leak(cuda):
    """Back-to-back launches with two LUTs each see their own LUT."""
    rng = np.random.default_rng(1)
    stream = torch.from_numpy(rng.integers(0, 4, 5000).astype(np.uint8)
                              ).to(cuda)
    a = scan_stream(stream, 8, codon_lut(11))
    b = scan_stream(stream, 8, codon_lut(4))
    assert torch.equal(a[0], scan_stream_plain(stream, 8, codon_lut(11))[0])
    assert torch.equal(b[0], scan_stream_plain(stream, 8, codon_lut(4))[0])
    assert not torch.equal(a[2], b[2])      # TGA is a stop only in code 11


@pytest.mark.parametrize("n,kw", [(5000, {}), (48, dict(n_rows=2,
                                                        max_salts=1))])
def test_probe_wide_kernel_matches_plain(cuda, n, kw):
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(0, 1 << 60, 4 * n, dtype=np.int64))
    keys = rng.permutation(keys)
    mask30 = (1 << 30) - 1
    table, salt, mp = build_wide_table(
        keys[:n] & mask30, keys[:n] >> 30,
        rng.integers(0, 1 << 31, n).astype(np.uint32), **kw)
    q = rng.permutation(keys[: 2 * n + 1])
    args = (wide_table_from_numpy(table, cuda),
            torch.from_numpy((q & mask30).astype(np.int32)).to(cuda),
            torch.from_numpy((q >> 30).astype(np.int32)).to(cuda),
            torch.from_numpy(rng.random(len(q)) >= 0.08).to(cuda),
            salt, mp)
    before = probe_wide.launches
    got = probe_wide(*args)
    torch.cuda.synchronize()
    assert probe_wide.launches == before + 1
    want = probe_wide_plain(*args)
    assert torch.equal(got, want)
    assert (got >= 0).any() and (got < 0).any()


def test_probe_wide_empty_query_launches_nothing(cuda):
    table, salt, mp = build_wide_table(np.zeros(1, np.uint32),
                                       np.zeros(1, np.uint32),
                                       np.zeros(1, np.uint32))
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = probe_wide.launches
    out = probe_wide(wide_table_from_numpy(table, cuda), empty, empty,
                     empty.bool(), salt, mp)
    assert out.shape == (0,) and probe_wide.launches == before


@pytest.mark.parametrize("n,kw", [(5000, {}), (60, dict(n_buckets=8))])
def test_probe_table_on_cuda_matches_cpu(cuda, n, kw):
    """The 8-slot probe (plain torch on both devices), on hits, misses,
    invalid queries and, in the second case, multi-bucket walks."""
    rng = np.random.default_rng(n + 1)
    keys = rng.permutation(np.unique(rng.integers(0, 1 << 60, 4 * n,
                                                  dtype=np.int64)))
    mask30 = (1 << 30) - 1
    table, mp = build_table(keys[:n] & mask30, keys[:n] >> 30,
                            np.arange(n, dtype=np.uint32), **kw)
    q = rng.permutation(keys[: 2 * n + 1])
    args = [wide_table_from_numpy(table, torch.device("cpu")),
            torch.from_numpy((q & mask30).astype(np.int32)),
            torch.from_numpy((q >> 30).astype(np.int32)),
            torch.from_numpy(rng.random(len(q)) >= 0.08)]
    want = probe_table(*args, mp)
    got = probe_table(*(a.to(cuda) for a in args), mp)
    assert got.device == cuda and torch.equal(got.cpu(), want)
    assert (want >= 0).any() and (want < 0).any()


@pytest.mark.parametrize("k", [8, 12])
@pytest.mark.parametrize("n", [3 * 8 - 1, 3 * 12 + 3, 301, 100_003])
def test_strand_route_on_cuda_matches_cpu(cuda, k, n):
    """extract_contig_kmers: one scanner launch per strand on the card,
    the same host arrays as the CPU's plain version."""
    rng = np.random.default_rng(n * k)
    seq = "".join(np.array(list("acgtn"))[rng.choice(
        5, n, p=[0.245, 0.245, 0.245, 0.245, 0.02])])
    before = scan_stream.launches
    got = extract_contig_kmers(seq, k, 11, cuda)
    assert scan_stream.launches == before + 2 * (n >= 3 * k)
    want = extract_contig_kmers(seq, k, 11, torch.device("cpu"))
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def _bench_case():
    _, olds, new_g = make_projection_workload(np.random.default_rng(3), 12, 2)
    return new_g, olds


def _varied_case():
    """Three contigs cut from a bench genome (the third repeats half of the
    first, so STRICT mode drops its windows), close genomes that differ
    (the first carries truncated proteins, so later genomes win merges;
    the second lacks every third peg) and, listed second, a close genome
    the loader cannot find."""
    _, olds, new_g = make_projection_workload(np.random.default_rng(4), 18, 3)
    raw = json.loads(json.dumps(new_g.raw))
    contig = raw["contigs"][0]
    dna = contig["dna"]
    cut = len(dna) // 2
    raw["contigs"] = [dict(contig, id="nc1", dna=dna[:cut]),
                      dict(contig, id="nc2", dna=dna[cut:]),
                      dict(contig, id="twin", dna=dna[:cut // 2])]
    raw["close_genomes"].insert(1, {"genome": "999.1",
                                    "genome_name": "Missing",
                                    "closeness_measure": 99.5})
    ids = list(olds)
    first = json.loads(json.dumps(olds[ids[0]].raw))
    for f in first["features"]:
        f["protein_translation"] = f["protein_translation"][:-15]
    second = json.loads(json.dumps(olds[ids[1]].raw))
    second["features"] = [f for i, f in enumerate(second["features"])
                          if i % 3]
    return Genome(raw), {ids[0]: Genome(first), ids[1]: Genome(second),
                         ids[2]: olds[ids[2]]}


ANNOTATOR_CASES = {
    "bench": (_bench_case, {}),
    "varied": (_varied_case, dict(max_genomes=3)),
    "varied_strict": (_varied_case, dict(algorithm="STRICT")),
    "varied_weak_small": (_varied_case,
                          dict(min_strength=0.8, min_evidence=100)),
    "varied_tight_fuzz": (_varied_case, dict(min_fuzz=0.9, max_fuzz=1.1)),
}
LOGGER = "kmers_anno_tpu_torch.engine.projection"


ROUTES = ("fused", "rle", "host")


def _annotate(make, params, route, dev, caplog):
    new_g, olds = make()
    annot = ProjectionAnnotator(
        k=8, device=dev, trace_function="Projected role number 3",
        engine="host" if route == "host" else "auto", **params)
    if route == "rle":
        annot._close_set = lambda olds_: None
    with caplog.at_level(logging.INFO, logger=LOGGER):
        caplog.clear()
        stats = annot.annotate_genome(new_g, olds.get)
    lines = [r.getMessage() for r in caplog.records if r.name == LOGGER]
    features = [(f.id, f.function, f.location.contig_id, f.location.strand,
                 f.location.left, f.location.right, f.protein_translation,
                 tuple(a[0] for a in f.raw.get("annotations", [])))
                for f in new_g.features]
    return stats, features, lines


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", list(ANNOTATOR_CASES))
def test_annotator_on_cuda_matches_cpu(cuda, case, route, caplog,
                                       monkeypatch):
    """Stats, features and log and --trace lines on the card equal the
    CPU's (which the CPU tests hold equal to the JAX reference), on each
    of the three projection routes."""
    make, params = ANNOTATOR_CASES[case]
    fused_calls = []
    orig = projection._scan_genomes
    monkeypatch.setattr(projection, "_scan_genomes", lambda *a: (
        fused_calls.append(1), orig(*a))[1])
    before = (scan_stream.launches, probe_wide.launches)
    got = _annotate(make, params, route, cuda, caplog)
    assert scan_stream.launches > before[0]
    if route == "host":
        assert probe_wide.launches == before[1]
    else:
        assert probe_wide.launches > before[1]
    assert bool(fused_calls) == (route == "fused")
    want = _annotate(make, params, route, "cpu", caplog)
    assert got == want
    assert got[0]["pegs"] > 0
    if case == "varied_weak_small":
        assert got[0]["weak"] > 0 and got[0]["small"] > 0
    if case == "varied":
        assert got[0]["merged"] > 0 and got[0]["rejected"] > 0
        assert any("not found" in line for line in got[2])
        assert any("Proposal stored" in line for line in got[2])
