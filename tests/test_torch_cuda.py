"""The CUDA kernels against their plain-PyTorch versions, on an NVIDIA GPU.

Every test here needs a card and nvcc, carries the ``cuda`` marker and
skips without CUDA.  The file imports no jax, so it also runs where jax is
absent (skipping the repo's jax-forcing conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import itertools
import json
import logging

import numpy as np
import pytest
import torch

from chip_smoke import (CHUNK_ORDERS, FLAT_EDGES, KEYS_SHARES,
                        TABLE_BUILD_EDGES, UNION_CASES, WEIGHTED_EDGES,
                        carried_state, union_keys, hash_index_batch,
                        host_hash_index, index_differences, wrapping_batch,
                        collision_rows,
                        collision_table, dna_stream_tensors, dna_streams,
                        dna_wrap_table, edge_keys, flat_case, flat_filter,
                        flat_tensors, int32_tensors, padded_keys,
                        random_keys,
                        keys_cases, live_share_keys, made_up_chunk,
                        made_up_rows,
                        make_dna_signature_genomes, make_projection_workload,
                        make_signature_genomes, reorder_chunk, tally_bits,
                        tile_cells, weighted_edge)
from kmers_anno_tpu_torch.engine import hashanno, projection
from kmers_anno_tpu_torch.engine import protein_kmers
from kmers_anno_tpu_torch.engine import signature as signature_mod
from kmers_anno_tpu_torch.engine.apply_engine import KmerApplyEngine
from kmers_anno_tpu_torch.engine.signature import (StreamingTableBuilder,
                                                   build_signatures)
from kmers_anno_tpu_torch.engine.convert import wide_table_from_numpy
from kmers_anno_tpu_torch.engine.dna_apply import DnaApplyEngine
from kmers_anno_tpu_torch.engine.mesh_apply import (DnaMeshApplyEngine,
                                                    MeshApplyEngine)
from kmers_anno_tpu_torch.engine.projection import ProjectionAnnotator
from kmers_anno_tpu_torch.genome.gto import Genome
from kmers_anno_tpu_torch.ops import apply_flat as apply_flat_mod
from kmers_anno_tpu_torch.ops import vote
from kmers_anno_tpu_torch.ops.apply_flat import (apply_flat, apply_flat_plain,
                                                 apply_weighted_flat,
                                                 apply_weighted_flat_plain)
from kmers_anno_tpu_torch.ops.apply_rows import apply_rows, apply_rows_plain
from kmers_anno_tpu_torch.ops.contig_kmers import extract_contig_kmers
from kmers_anno_tpu_torch.ops.contig_scan import (KERNEL_TILE, scan_stream,
                                                  scan_stream_plain)
from kmers_anno_tpu_torch.ops import dna_probe as dna_probe_mod
from kmers_anno_tpu_torch.ops.dna_probe import probe_dna, probe_dna_plain
from kmers_anno_tpu_torch.ops.hash_chunk import (COMMONS_TABLE_CELLS,
                                                 COMMONS_TILE, hash_best,
                                                 hash_best_plain,
                                                 hash_commons,
                                                 hash_commons_plain)
from kmers_anno_tpu_torch.ops.hashtable import build_table, probe_table
from kmers_anno_tpu_torch.ops.key_filter import build_key_filter, table_keys
from kmers_anno_tpu_torch.ops import probe_keys as probe_keys_mod
from kmers_anno_tpu_torch.ops.probe_keys import (KERNEL_TILE, probe_keys,
                                                 probe_keys_plain)
from kmers_anno_tpu_torch.ops import table_build
from kmers_anno_tpu_torch.ops.hashing import GOLDEN
from kmers_anno_tpu_torch.ops.hashtable import device_table_buckets
from kmers_anno_tpu_torch.ops.translate import codon_lut
from kmers_anno_tpu_torch.ops.widetable import (build_wide_table, probe_wide,
                                                probe_wide_plain,
                                                wide_rows_for)

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


def _assert_scan_matches_plain(stream, k, gc=11):
    before = scan_stream.launches
    got = scan_stream(stream, k, codon_lut(gc))
    torch.cuda.synchronize()
    assert scan_stream.launches == before + 1
    want = scan_stream_plain(stream, k, codon_lut(gc))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k", [1, 6, 8, 12])
@pytest.mark.parametrize("edge", ["tile-1", "tile", "tile+1", "tile+halo"])
def test_contig_scan_kernel_tile_edges(cuda, k, edge):
    """Stream lengths at the kernel's tile (KERNEL_TILE outputs a block)
    and one tile plus the 3k-1 halo the last window reaches into."""
    n = {"tile-1": KERNEL_TILE - 1, "tile": KERNEL_TILE,
         "tile+1": KERNEL_TILE + 1,
         "tile+halo": KERNEL_TILE + 3 * k - 1}[edge]
    rng = np.random.default_rng(n + 31 * k)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < 0.02] = 4
    _assert_scan_matches_plain(torch.from_numpy(codes).to(cuda), k)


@pytest.mark.parametrize("offset", range(1, 16))
def test_contig_scan_kernel_misaligned_slice(cuda, offset):
    """A stream that starts at byte ``offset`` past a 16-byte boundary (a
    slice of a larger tensor), over several tiles, with an odd length."""
    rng = np.random.default_rng(offset)
    n = 2 * KERNEL_TILE + 37
    base = torch.from_numpy(rng.integers(0, 5, n + 32).astype(np.uint8)
                            ).to(cuda)
    stream = base[offset: offset + n]
    assert stream.data_ptr() % 16 == offset
    _assert_scan_matches_plain(stream, 8)


@pytest.mark.parametrize("k", range(1, 13))
def test_contig_scan_kernel_every_k(cuda, k):
    rng = np.random.default_rng(100 + k)
    codes = rng.integers(0, 4, 3 * KERNEL_TILE + 5).astype(np.uint8)
    codes[rng.random(len(codes)) < 0.01] = rng.integers(4, 256)
    _assert_scan_matches_plain(torch.from_numpy(codes).to(cuda), k)


def test_contig_scan_kernel_all_ambiguous(cuda):
    rng = np.random.default_rng(7)
    codes = rng.integers(4, 256, KERNEL_TILE + 101).astype(np.uint8)
    stream = torch.from_numpy(codes).to(cuda)
    _assert_scan_matches_plain(stream, 8)
    assert bool((scan_stream(stream, 8, codon_lut(11))[2] == 1).all())


@pytest.mark.parametrize("gc", [1, 2, 3])
def test_contig_scan_kernel_genetic_codes(cuda, gc):
    rng = np.random.default_rng(gc)
    codes = rng.integers(0, 5, 50_001).astype(np.uint8)
    _assert_scan_matches_plain(torch.from_numpy(codes).to(cuda), 8, gc)


def test_contig_scan_two_streams_at_once(cuda):
    """Two CUDA streams scan the same codes with the LUTs of codes 11 and
    4 at the same time; each result equals its own plain version."""
    rng = np.random.default_rng(2)
    stream = torch.from_numpy(rng.integers(0, 4, 4_000_000).astype(np.uint8)
                              ).to(cuda)
    sides = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    got = {}
    for side in sides:
        side.wait_stream(torch.cuda.current_stream(cuda))
    for _ in range(3):
        for gc, side in zip((11, 4), sides):
            with torch.cuda.stream(side):
                got[gc] = scan_stream(stream, 8, codon_lut(gc))
    torch.cuda.synchronize()
    for gc in (11, 4):
        want = scan_stream_plain(stream, 8, codon_lut(gc))
        assert all(torch.equal(g, w) for g, w in zip(got[gc], want))
    assert not torch.equal(got[11][2], got[4][2])


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


ROUTES = ("fused", "rle")


def _annotate(make, params, route, dev, caplog):
    new_g, olds = make()
    annot = ProjectionAnnotator(
        k=8, device=dev, trace_function="Projected role number 3",
        **params)
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
    of the two projection routes."""
    make, params = ANNOTATOR_CASES[case]
    fused_calls = []
    orig = projection._scan_genomes
    monkeypatch.setattr(projection, "_scan_genomes", lambda *a: (
        fused_calls.append(1), orig(*a))[1])
    before = (scan_stream.launches, probe_wide.launches)
    got = _annotate(make, params, route, cuda, caplog)
    assert scan_stream.launches > before[0]
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


APPLY_EDGES = {
    "k3": dict(k=3, n_rows=37, width=64, n_keys=800),
    "k8_bench_width": dict(k=8, n_rows=1000, width=320, n_keys=50_000),
    "k8_odd_width": dict(k=8, n_rows=77, width=37, n_keys=600),
    "k12_walk": dict(k=12, n_rows=300, width=101, n_keys=6000,
                     table_rows=256),
    "wider_than_16384": dict(k=8, n_rows=8, width=18_432, n_keys=600),
}


@pytest.mark.parametrize("min_hits", [1, 5])
@pytest.mark.parametrize("case", list(APPLY_EDGES))
def test_apply_rows_kernel_matches_plain(cuda, case, min_hits):
    """The fused kernel against its plain version: k from 3 to 12, odd
    widths, rows wider than the last width bucket, lookups that walk
    (max_probes > 1), and every seventh row with no valid window."""
    params = dict(APPLY_EDGES[case])
    rng = np.random.default_rng(len(case) * 7 + min_hits)
    codes, valid, table, salt, mp = made_up_rows(rng, **params)
    valid[::7] = False
    if "table_rows" in params:
        assert mp > 1
    args = (wide_table_from_numpy(table, cuda), salt,
            torch.from_numpy(codes).to(cuda),
            torch.from_numpy(valid).to(cuda), min_hits, params["k"], mp)
    before = apply_rows.launches
    got = apply_rows(*args)
    torch.cuda.synchronize()
    assert apply_rows.launches == before + 1
    want = apply_rows_plain(*args)
    for g, w in zip(got, want):
        assert g.device == args[2].device and torch.equal(g, w)
    role, count = (g.cpu().numpy() for g in got)
    assert (role[::7] == -1).all() and (count[::7] == 0).all()
    assert (role >= 0).any()


def test_apply_rows_kernel_edge_shapes(cuda):
    """Width 1 (no window fits k = 5), an empty batch (no launch), and the
    checks the wrapper makes before a launch."""
    rng = np.random.default_rng(11)
    _, _, table, salt, mp = made_up_rows(rng, 5, 8, 40, 100)
    d_table = wide_table_from_numpy(table, cuda)
    codes = torch.from_numpy(rng.integers(0, 20, (9, 1)).astype(
        np.uint8)).to(cuda)
    valid = torch.zeros((9, 1), dtype=torch.bool, device=cuda)
    role, count = apply_rows(d_table, salt, codes, valid, 1, 5, mp)
    assert (role.cpu() == -1).all() and (count.cpu() == 0).all()
    before = apply_rows.launches
    empty = apply_rows(d_table, salt, codes[:0], valid[:0], 1, 5, mp)
    assert [t.shape for t in empty] == [(0,), (0,)]
    assert apply_rows.launches == before
    wide_codes = torch.zeros((4, 10), dtype=torch.uint8, device=cuda)
    wide_valid = torch.zeros((4, 10), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        apply_rows(d_table, salt, wide_codes[:, ::2], wide_valid[:, ::2],
                   1, 5, mp)
    with pytest.raises(ValueError, match="one device"):
        apply_rows(d_table, salt, wide_codes.cpu(), wide_valid, 1, 5, mp)


@pytest.mark.parametrize("n", [1, 7, 31, 33, 1001, 100_003])
@pytest.mark.parametrize("mode", ["all_valid", "mixed", "all_invalid"])
def test_probe_wide_kernel_collisions_and_wrap(cuda, n, mode):
    """The probe kernel against its plain version on a table with keys of
    one lo word and another hi in one row and a walk that wraps from the
    last row to row 0; query counts off multiples of 32; all, some or none
    of the queries valid."""
    table, salt, mp, _, (qlo, qhi, valid) = collision_table(
        np.random.default_rng(n), n, mode)
    args = (wide_table_from_numpy(table, cuda),
            torch.from_numpy(qlo.view(np.int32)).to(cuda),
            torch.from_numpy(qhi.view(np.int32)).to(cuda),
            torch.from_numpy(valid).to(cuda), salt, mp)
    before = probe_wide.launches
    got = probe_wide(*args)
    torch.cuda.synchronize()
    assert probe_wide.launches == before + 1
    assert torch.equal(got, probe_wide_plain(*args))
    if mode == "all_invalid":
        assert (got.cpu() == -1).all()


@pytest.mark.parametrize("min_hits", [1, 3])
@pytest.mark.parametrize("k,width,n_rows", [(12, 45, 21), (12, 100, 40),
                                            (12, 320, 333), (8, 33, 17),
                                            (8, 1, 5), (8, 257, 64)])
def test_apply_rows_kernel_collisions_and_wrap(cuda, k, width, n_rows,
                                               min_hits):
    """The fused kernel against its plain version on rows whose windows
    share lo words, against a table whose walk wraps to row 0; widths off
    multiples of 32; every fourth row with no valid window."""
    codes, valid, table, salt, mp = collision_rows(
        np.random.default_rng(k * width), k, width, n_rows)
    args = (wide_table_from_numpy(table, cuda), salt,
            torch.from_numpy(codes).to(cuda),
            torch.from_numpy(valid).to(cuda), min_hits, k, mp)
    got = apply_rows(*args)
    torch.cuda.synchronize()
    want = apply_rows_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    role, count = (g.cpu().numpy() for g in got)
    assert (role[::4] == -1).all() and (count[::4] == 0).all()


def _signature_case():
    genomes, role_map = make_signature_genomes(
        np.random.default_rng(5), 2, 60, 40, 3)
    return genomes, role_map, set(role_map.ids())


@pytest.mark.parametrize("weights", ["none", "uniform", "balance"])
def test_apply_engine_on_cuda_matches_cpu(cuda, weights):
    """The whole engine on the card against the CPU (which the CPU tests
    hold equal to the JAX reference): unweighted through the fused kernel,
    weighted through the probe kernel and the torch vote.  ``balance``
    gives non-integer weights: calls and tallies equal bit for bit."""
    genomes, role_map, good = _signature_case()
    table = build_signatures(genomes, role_map, good, k=8, progress=False,
                             weight_mode=weights, device="cpu")
    weighted = weights != "none"
    prots = [f.protein_translation for g in genomes for f in g.pegs]
    prots += [prots[0][:150] + prots[1][150:], "MKV", "A" * 20_000]
    before = (apply_rows.launches, probe_wide.launches)
    got = KmerApplyEngine(table, min_hits=5, weighted=weighted,
                          device=cuda).call_proteins(prots)
    if weighted:
        assert apply_rows.launches == before[0]
        assert probe_wide.launches > before[1]
    else:
        assert apply_rows.launches > before[0]
    want = KmerApplyEngine(table, min_hits=5, weighted=weighted,
                           device="cpu").call_proteins(prots)
    assert got == want
    assert sum(c is not None for c in got) > 60


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("min_hits", [1, 3])
@pytest.mark.parametrize("n_seqs", ["batch", "fewer", "no_valid"])
@pytest.mark.parametrize("case", list(FLAT_EDGES))
def test_apply_flat_kernel_matches_plain(cuda, case, n_seqs, min_hits,
                                         filtered):
    """The unanimity kernel, with the table's key filter and without,
    against its plain version, with buckets
    holding keys of one lo word and walks that wrap to bucket 0 (the
    collide cases), proteins past ``n_seqs`` ("fewer": their tokens count
    nothing) and an all-invalid stream."""
    params = FLAT_EDGES[case]
    rng = np.random.default_rng(len(case) + 10 * min_hits)
    batch, table, mp = flat_case(rng, n_roles=5, **params)
    args = flat_tensors(batch, table, cuda)
    n = params["n_prot"] - 7 if n_seqs == "fewer" else batch.n_seqs
    if n_seqs == "no_valid":
        args = (*args[:3], torch.zeros_like(args[3]))
    kw = dict(k=params["k"], max_probes=mp, n_seqs=n)
    before = apply_flat.launches
    got = apply_flat(*args, min_hits, **kw,
                     key_filter=flat_filter(args[0]) if filtered else None)
    torch.cuda.synchronize()
    assert apply_flat.launches == before + 1
    want = apply_flat_plain(*args, min_hits, **kw)
    for g, w in zip(got, want):
        assert g.device == args[0].device and torch.equal(g, w)
    if n_seqs == "no_valid":
        assert (got[0] == -1).all() and (got[1] == 0).all()
    elif "alphabet" not in params:      # two residues: conflicts everywhere
        assert (got[0] >= 0).any()


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("r_blk", [9, 4, 1])
@pytest.mark.parametrize("weights", ["uniform", "fp16"])
@pytest.mark.parametrize("case", list(FLAT_EDGES))
def test_apply_weighted_flat_kernel_matches_plain(cuda, case, weights, r_blk,
                                                  filtered, monkeypatch):
    """The weighted kernel, one walk a call whatever the role blocks of
    the plain version, with the key filter and without, against the plain
    version's dense vote (9 roles) and its role blocks of 4 and 1, roles
    and tally bits: uniform weights (many ties, the smaller role must win)
    and fractional fp16 weights."""
    params = FLAT_EDGES[case]
    rng = np.random.default_rng(len(case) + r_blk)
    batch, table, mp = flat_case(rng, n_roles=9, weights=weights, **params)
    monkeypatch.setattr(vote, "DENSE_VOTE_LIMIT", batch.n_seqs * r_blk)
    args = flat_tensors(batch, table, cuda)
    kw = dict(k=params["k"], max_probes=mp, n_seqs=batch.n_seqs, n_roles=9)
    before = apply_weighted_flat.launches
    got = tally_bits(apply_weighted_flat(
        *args, 1.5, **kw, key_filter=flat_filter(args[0]) if filtered
        else None))
    torch.cuda.synchronize()
    assert apply_weighted_flat.launches == before + 1
    want = tally_bits(apply_weighted_flat_plain(*args, 1.5, **kw))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (got[0] >= 0).any()


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("direct", ["default", 5])
@pytest.mark.parametrize("case", list(WEIGHTED_EDGES))
def test_apply_weighted_flat_kernel_edges(cuda, case, direct, filtered,
                                          monkeypatch):
    """The weighted kernel at its edges against its plain version, roles
    and tally bits, at min_weight 1.5 and 0: a 40,000-aa protein whose
    hits span more roles than the shared tally holds (its kept hits swept
    in ranges), 30,000 roles, two roles whose int64 sums differ but round
    to one float32 (the smaller role wins, in both orders), hits of zero
    weight, empty proteins, proteins across the owner block's rounds; the
    shared tally at ``DIRECT_ROLES`` and at 5 roles.  One launch a call."""
    rng = np.random.default_rng(len(case))
    batch, table, mp, k, n_roles, expect = weighted_edge(rng, case)
    if direct != "default":
        monkeypatch.setattr(apply_flat_mod, "DIRECT_ROLES", direct)
    args = flat_tensors(batch, table, cuda)
    key_filter = flat_filter(args[0]) if filtered else None
    kw = dict(k=k, max_probes=mp, n_seqs=batch.n_seqs, n_roles=n_roles)
    for min_weight in (1.5, 0.0):
        before = apply_weighted_flat.launches
        got = tally_bits(apply_weighted_flat(*args, min_weight, **kw,
                                             key_filter=key_filter))
        torch.cuda.synchronize()
        assert apply_weighted_flat.launches == before + 1
        want = tally_bits(apply_weighted_flat_plain(*args, min_weight, **kw))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        if expect is not None:
            np.testing.assert_array_equal(got[0].cpu().numpy(), expect)
    assert (got[0] >= 0).any()


@pytest.mark.parametrize("how", ["swap", "padding", "first"])
def test_apply_weighted_flat_rejects_a_stream_out_of_order(cuda, how):
    """seg_ids that decrease somewhere: the kernel flags it and the
    wrapper raises."""
    batch, table, mp, k, n_roles, _ = weighted_edge(
        np.random.default_rng(2), "tile_edges")
    args = list(flat_tensors(batch, table, cuda))
    seg = args[2].clone()
    if how == "swap":
        a = int(np.flatnonzero(batch.seg_ids == 3)[0])
        b = int(np.flatnonzero(batch.seg_ids == 5)[0])
        seg[a], seg[b] = args[2][b], args[2][a]
    elif how == "padding":
        seg[-1] = 0
    else:
        seg[0] = batch.n_seqs
    kw = dict(k=k, max_probes=mp, n_seqs=batch.n_seqs, n_roles=n_roles)
    apply_weighted_flat(*args, 1.5, **kw)
    with pytest.raises(ValueError, match="never decrease"):
        apply_weighted_flat(args[0], args[1], seg, args[3], 1.5, **kw)


def _own_windows(lo, hi, dev):
    """Each key laid out as the 12 codes of a k = 12 window (its lo and
    hi words cut into 5-bit fields), a protein each, only the window
    starts valid."""
    fields = [(w >> np.uint32(5 * j)) & np.uint32(31)
              for w in (lo, hi) for j in range(6)]
    codes = torch.from_numpy(np.stack(fields, 1).astype(np.uint8).reshape(
        -1)).to(dev)
    starts = torch.zeros(codes.numel(), dtype=torch.bool, device=dev)
    starts[::12] = True
    own = torch.arange(codes.numel(), dtype=torch.int32, device=dev) // 12
    return codes, own, starts


@pytest.mark.parametrize("case", ["k8_collide_wrap", "k12_collide_wrap",
                                  "collision_table"])
def test_key_filter_passes_every_key_on_the_card(cuda, case):
    """Every key of a table with walked and wrapped buckets (flat_case's
    squeezed tables; collision_table's keys of six lo words in 32
    buckets), walked through the filtered kernel as its own protein,
    finds its payload."""
    rng = np.random.default_rng(17)
    if case == "collision_table":
        _, _, _, (lo, hi, _), _ = collision_table(rng, 10)
        table, mp = build_table(lo, hi, np.arange(len(lo), dtype=np.uint32),
                                n_buckets=32)
    else:
        _, table, mp = flat_case(rng, n_roles=5, **FLAT_EDGES[case])
    assert mp >= 2
    lo, hi = table_keys(table)
    vals = table[:, 16:24][table[:, :8] != np.uint32(0xFFFFFFFF)]
    d_table = wide_table_from_numpy(table, cuda)
    codes, own, starts = _own_windows(lo, hi, cuda)
    role, hits = apply_flat(d_table, codes, own, starts, 1, k=12,
                            max_probes=mp, n_seqs=len(lo),
                            key_filter=flat_filter(d_table))
    np.testing.assert_array_equal(role.cpu().numpy(), vals.astype(np.int32))
    assert (hits == 1).all()


def test_apply_flat_kernels_on_an_empty_stream(cuda):
    """No tokens: every protein uncalled, one launch; no proteins: no
    launch."""
    batch, table, mp = flat_case(np.random.default_rng(3), n_roles=4,
                                 weights="fp16", **FLAT_EDGES["k8"])
    args = [a[:0] if i else a for i, a in enumerate(
        flat_tensors(batch, table, cuda))]
    kw = dict(k=8, max_probes=mp)
    before = (apply_flat.launches, apply_weighted_flat.launches)
    role, hits = apply_flat(*args, 1, n_seqs=5, **kw)
    w_role, tally = apply_weighted_flat(*args, 1.0, n_seqs=5, n_roles=4,
                                        **kw)
    torch.cuda.synchronize()
    assert (role == -1).all() and (hits == 0).all() and (w_role == -1).all()
    assert (tally == 0).all()
    assert apply_flat.launches == before[0] + 1
    assert apply_weighted_flat.launches == before[1] + 1
    assert apply_flat(*args, 1, n_seqs=0, **kw)[0].numel() == 0
    assert apply_flat.launches == before[0] + 1


@pytest.mark.parametrize("weights", ["none", "balance"])
def test_flat_engine_on_cuda_matches_cpu(cuda, weights, monkeypatch):
    """A table forced onto the flat path: on the card the engine launches
    the flat kernels and calls no plain version, and its calls equal the
    CPU's (tallies bit for bit)."""
    genomes, role_map, good = _signature_case()
    table = build_signatures(genomes, role_map, good, k=8, progress=False,
                             weight_mode=weights, device="cpu")
    monkeypatch.setattr(signature_mod, "fits_wide", lambda n: False)
    weighted = weights != "none"
    prots = [f.protein_translation for g in genomes for f in g.pegs]
    prots += [prots[0][:150] + prots[1][150:], "MKV", "A" * 20_000]
    kw = dict(min_hits=5, weighted=weighted)
    cpu = KmerApplyEngine(table, **kw, device="cpu")
    want = cpu._call_batches(len(prots), cpu._prepare_proteins(prots))

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(apply_flat_mod, "apply_flat_plain", refuse)
    monkeypatch.setattr(apply_flat_mod, "apply_weighted_flat_plain", refuse)
    eng = KmerApplyEngine(table, **kw, device=cuda)
    assert eng.mode == "flat"
    before = (apply_flat.launches, apply_weighted_flat.launches,
              apply_rows.launches, probe_wide.launches)
    got = eng._call_batches(len(prots), eng._prepare_proteins(prots))
    after = (apply_flat.launches, apply_weighted_flat.launches,
             apply_rows.launches, probe_wide.launches)
    assert after[int(not weighted)] == before[int(not weighted)]
    assert after[int(weighted)] > before[int(weighted)]
    assert after[2:] == before[2:]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32),
                                  want[1].view(np.int32))
    assert (got[0] >= 0).sum() > 60


def test_device_groupby_on_cuda_matches_native(cuda):
    """The torch group-bys on the card (several flushes, kill pass)
    against the C++ merge builder, then a whole build on both."""
    rng = np.random.default_rng(8)
    chunks = [(rng.integers(0, 1 << 30, 4000).astype(np.uint32),
               rng.integers(0, 1 << 10, 4000).astype(np.uint32),
               rng.integers(0, 30, 4000).astype(np.int32))
              for _ in range(4)]
    lo0, hi0, r0 = chunks[0]
    chunks.append((lo0[:600], hi0[:600], (r0[:600] + 1) % 30))
    kills = (lo0[700:900], hi0[700:900])
    outs = []
    for b in (StreamingTableBuilder(backend="native", device="cpu"),
              StreamingTableBuilder(chunk_entries=2048, backend="device",
                                    device=cuda)):
        for chunk in chunks:
            b.add_candidates(*chunk)
        b.add_kills(*kills)
        outs.append(b.finish())
    for w, g in zip(outs[0][:3], outs[1][:3]):
        np.testing.assert_array_equal(g, w)
    assert outs[1][3] == outs[0][3] and outs[1][3]["killed"] > 0
    genomes, role_map, good = _signature_case()
    want = build_signatures(genomes, role_map, good, k=8, progress=False,
                            device="cpu")
    got = build_signatures(genomes, role_map, good, k=8, progress=False,
                           backend="device", device=cuda)
    for name in ("key_lo", "key_hi", "role_idx"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert got.stats == want.stats
    assert got.stats["pruned"] > 0 and got.stats["killed"] > 0


HASH_EDGES = {
    "k8_odd": dict(k=8, n_prot=301, n_rows=37),
    "k12_walk": dict(k=12, n_prot=400, n_rows=61, squeeze=True),
    "k8_owners_at_cap": dict(k=8, n_prot=200, n_rows=19, family=40),
    "k5_exact_cols": dict(k=5, n_prot=77, n_rows=5, exact_cols=True),
    "k8_one_row": dict(k=8, n_prot=9, n_rows=1),
    "k8_wide": dict(k=8, n_prot=3001, n_rows=1000),
    # 5,000-aa prototypes: one prototype's kmers span several tiles
    "k8_long_proto": dict(k=8, n_prot=60, n_rows=5, plen=5000),
    # owners at the cap: key-major tiles overflow the shared cell table
    "k8_spill": dict(k=8, n_prot=1000, n_rows=257, family=40),
    "k8_exact_cols_wide": dict(k=8, n_prot=1500, n_rows=300,
                               exact_cols=True),
}


def _chunk_on(c, dev, mode=None):
    """made_up_chunk's tensors on ``dev``; ``mode`` "empty" keeps no chunk
    kmer, "misses" turns every kmer into a miss."""
    c = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
         for k, v in c.items()}
    if mode == "empty":
        for key in ("lo", "hi", "proto", "valid"):
            c[key] = c[key][:0]
    elif mode == "misses":
        c["lo"] = c["lo"] | (1 << 30)        # no packed kmer has bit 30
    return c


@pytest.mark.parametrize("order", CHUNK_ORDERS)
@pytest.mark.parametrize("mode", [None, "empty", "misses"])
@pytest.mark.parametrize("case", list(HASH_EDGES))
def test_hash_chunk_kernels_match_plain(cuda, case, mode, order):
    """Both chunk kernels against their plain versions: counts and ranks
    equal, the carried state (c, u, index, improvements) bit-equal, the
    counts cleared; a table whose lookups walk, owner rows at the cap,
    row and column counts off powers of two, prototypes whose kmers span
    several tiles, an empty chunk, all misses; the chunk's kmers in the
    engine's order, shuffled and key-major (whose tiles overflow the
    kernel's shared table where owners are at the cap)."""
    params = HASH_EDGES[case]
    rng = np.random.default_rng(len(case) * 11 + len(mode or ""))
    c, _ = reorder_chunk(_chunk_on(made_up_chunk(rng, **params), cuda, mode),
                         order, rng)
    if params.get("squeeze"):
        assert c["max_probes"] > 1
    if case == "k8_long_proto" and mode is None:
        assert c["lo"].numel() > 2 * COMMONS_TILE
    args = (c["table"], c["max_probes"], c["owner_mat"], c["lo"], c["hi"],
            c["proto"], c["valid"], c["n_rows"], c["n_pad"])
    before = (hash_commons.launches, hash_best.launches)
    got, ranks = hash_commons(*args, with_ranks=True)
    torch.cuda.synchronize()
    assert hash_commons.launches == before[0] + (mode != "empty")
    want, want_ranks = hash_commons_plain(*args, with_ranks=True)
    assert torch.equal(got, want) and torch.equal(ranks, want_ranks)
    assert (int(got.sum()) > 0) == (mode is None)
    if case == "k8_spill" and mode is None:
        spilled = (tile_cells(c, ranks) > COMMONS_TABLE_CELLS).any()
        assert bool(spilled) == (order != "engine")
    state = carried_state(rng, c["n_pad"], cuda)
    got_state = tuple(t.clone() for t in state)
    want_state = tuple(t.clone() for t in state)
    plain_common = want.clone()
    hash_best(got, c["n_rows"], c["n1"], c["n2"], c["minc"], got_state, 77)
    torch.cuda.synchronize()
    assert hash_best.launches == before[1] + 1
    hash_best_plain(plain_common, c["n_rows"], c["n1"], c["n2"], c["minc"],
                    want_state, 77)
    for g, w in zip(got_state, want_state):
        assert torch.equal(g, w)
    assert not got.any()
    if mode is None and case == "k8_wide":
        assert int(got_state[3][0]) > 17


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("width", [1, 3, 4, 8, 12, 20, 32])
def test_hash_commons_owner_row_widths(cuda, width, aligned):
    """Owner rows of every width the kernel reads in 16-byte pieces (a
    multiple of 4, an odd number of pieces too) or word by word, and an
    owner matrix that starts off a 16-byte boundary (word by word): the
    kernel equals the plain version, in the engine's order and key-major."""
    rng = np.random.default_rng(width)
    c = _chunk_on(made_up_chunk(rng, 8, 600, 120, family=40), cuda)
    own = c["owner_mat"][:, :width]
    base = torch.empty(own.numel() + 4, dtype=torch.int32, device=cuda)
    start = 0 if aligned else 1
    base[start: start + own.numel()] = own.reshape(-1)
    c["owner_mat"] = base[start: start + own.numel()].view(own.shape)
    assert (c["owner_mat"].data_ptr() % 16 == 0) == aligned
    for order in ("engine", "key-major"):
        oc, _ = reorder_chunk(c, order)
        args = (oc["table"], oc["max_probes"], oc["owner_mat"], oc["lo"],
                oc["hi"], oc["proto"], oc["valid"], oc["n_rows"],
                oc["n_pad"])
        got = hash_commons(*args)
        want = hash_commons_plain(*args)
        assert torch.equal(got, want) and int(want.sum()) > 0


def test_hash_commons_adds_into_a_buffer(cuda):
    """The engine's reused count buffer: counts are added into its first
    rows, the rest stay zero, and hash_best leaves it all zero."""
    c = _chunk_on(made_up_chunk(np.random.default_rng(3), 8, 500, 50), cuda)
    out = torch.zeros((64, c["n_pad"]), dtype=torch.int32, device=cuda)
    args = (c["table"], c["max_probes"], c["owner_mat"], c["lo"], c["hi"],
            c["proto"], c["valid"], c["n_rows"], c["n_pad"])
    got = hash_commons(*args, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, hash_commons_plain(*args))
    assert not out[50:].any()
    state = carried_state(np.random.default_rng(4), c["n_pad"], cuda)
    hash_best(out, c["n_rows"], c["n1"], c["n2"], c["minc"], state, 0)
    assert not out.any()


def _hash_case():
    """Four genomes' worth of proteins (families of variants shared across
    genomes), prototypes from them and noise; min score 0.0125."""
    rng = np.random.default_rng(9)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    pool = [rng.integers(0, 20, int(rng.integers(60, 300)))
            for _ in range(300)]
    genomes = []
    for g in range(4):
        prots = []
        for p in pool:
            v = p.copy()
            v[rng.integers(0, len(v), 3)] = rng.integers(0, 20, 3)
            prots.append("".join(aa[v]))
        genomes.append(prots)
    protos = []
    for i in range(700):
        src = pool[int(rng.integers(0, len(pool)))].copy()
        n_sub = int(rng.integers(0, 8))
        src[rng.integers(0, len(src), n_sub)] = rng.integers(0, 20, n_sub)
        protos.append(hashanno.Prototype("".join(aa[src]), f"Role {i}"))
    return genomes, protos


@pytest.mark.parametrize("route", ["fast", "host"])
def test_hash_engine_on_cuda_matches_cpu(cuda, route, monkeypatch):
    """GenomeProteinKmers on the card against the CPU (which the CPU tests
    hold equal to the JAX reference), on both routes: best similarity,
    annotation and improvement count equal, with 300-prototype chunks;
    the fast route launches each kernel once a chunk, the host route only
    the counts."""
    if route == "host":
        monkeypatch.setattr(hashanno, "OWNER_CAP", 2)
    genomes, protos = _hash_case()
    pset = hashanno.PrototypeSet(protos, 8)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        gk = hashanno.GenomeProteinKmers(8, 0.0125, device=dev)
        for gi, prots in enumerate(genomes):
            for i, p in enumerate(prots):
                gk.add_protein(f"fig|{gi}.peg.{i}", p, f"old {gi}.{i}")
        before = (hash_commons.launches, hash_best.launches)
        matches = gk.process_proposals(pset, chunk=300)
        outs[dev.type] = (matches, list(gk.best_sim), gk.best_anno,
                          (hash_commons.launches - before[0],
                           hash_best.launches - before[1]))
    n_chunks = -(-len(protos) // 300)
    assert outs["cuda"][3] == ((n_chunks, n_chunks) if route == "fast"
                               else (n_chunks, 0))
    assert outs["cpu"][3] == (0, 0)
    assert outs["cuda"][:3] == outs["cpu"][:3]
    assert sum(s > 0 for s in outs["cpu"][1]) > 100


@pytest.mark.parametrize("drop_last", [False, True])
def test_hash_index_on_cuda_is_the_host_build(cuda, drop_last):
    """The batch index built on the card from a generated species batch
    (11,740 distinct proteins at the hashAnno cell's lengths, a kmer of 4
    owners) equals the host build byte for byte: table, ``max_probes``,
    owner matrix, kmer counts, heavy CSR; one table launch, counted in
    ``device_index``."""
    proteins = hash_index_batch(np.random.default_rng(23))
    protein_kmers.set_drop_last(drop_last)
    try:
        gk = hashanno.GenomeProteinKmers(8, 0.0125, device=cuda)
        for i, p in enumerate(proteins):
            gk.add_protein(f"fig|5.5.peg.{i}", p, "hypothetical protein")
        counts = (hashanno.GenomeProteinKmers.device_index,
                  table_build.build_bucketed.launches)
        gk._build()
        torch.cuda.synchronize()
        want = host_hash_index(proteins, cuda)
    finally:
        protein_kmers.set_drop_last(False)
    assert gk.table.device.type == gk.owner_mat.device.type == "cuda"
    assert index_differences(gk, want) == []
    assert gk.owner_mat.shape[1] == 4 and gk.kmer_count > 3_000_000
    assert (hashanno.GenomeProteinKmers.device_index,
            table_build.build_bucketed.launches) == (counts[0] + 1,
                                                     counts[1] + 1)


def test_hash_index_wrap_on_cuda(cuda):
    """An index whose keys wrap past the last bucket: the card places
    them from bucket 0 as the host ``build_table`` does, the same index
    byte for byte, with their walk in ``max_probes``."""
    proteins = wrapping_batch(np.random.default_rng(29))
    gk = hashanno.GenomeProteinKmers(8, 0.0125, device=cuda)
    for i, p in enumerate(proteins):
        gk.add_protein(f"fig|6.6.peg.{i}", p, "hypothetical protein")
    gk._build()
    assert gk.table.device.type == "cuda"
    assert index_differences(gk, host_hash_index(proteins, cuda)) == []
    assert gk.max_probes == 2 and int((gk.table[0, :8] != -1).sum()) == 8


# the 8-slot build's walk cases: the bucketed forced placements (walks of
# 1, 2 and 37 buckets, every key in one bucket, a wrap), hashAnno's
# shape (3.85M keys into 2^20 buckets), a table 99% full whose keys past
# the last bucket find their free slots across many blocks of 256 rows of
# the wrap pass, and more keys than slots
WALK_EDGES = [c for c, v in TABLE_BUILD_EDGES.items() if v[0] == "bucketed"]
WALK_SHAPES = {"hashanno_shape": (3_850_000, 1 << 20),
               "crowded_wrap": (16_220, 2_048), "over_full": (20, 2)}


@pytest.mark.parametrize("layout", ["bucketed", "open_walk"])
@pytest.mark.parametrize("case", WALK_EDGES + list(WALK_SHAPES))
def test_table_build_walk_matches_plain(cuda, layout, case):
    """kan_table_build's 8-slot layouts with the longest walk reported
    (and for ``OPEN_WALK`` the keys past the last bucket placed), against
    the plain version: table, ``bad`` and walk equal, one launch counted;
    repeated over junk, the same table and walk."""
    lay = (table_build.BUCKETED if layout == "bucketed"
           else table_build.OPEN_WALK)
    if case in WALK_SHAPES:
        n, n_rows = WALK_SHAPES[case]
        rng = np.random.default_rng(41)
        keys = int32_tensors(random_keys(rng, n), cuda)
        keys[2] = torch.arange(n, dtype=torch.int32, device=cuda)
    else:
        _, _, arrays, n_rows, _, _ = edge_keys(case)
        keys = int32_tensors(arrays, cuda)
    before = table_build.build_bucketed.launches
    table, bad, walk = table_build.build_bucketed(*keys, n_rows, lay)
    torch.cuda.synchronize()
    assert table_build.build_bucketed.launches == before + 1
    want = table_build.build_table_plain(*keys, n_rows, lay, GOLDEN)
    assert torch.equal(table, want[0])
    assert (bool(bad), int(walk)) == (bool(want[1]), int(want[2]))
    for _ in range(3):
        junk = torch.full((64 << 20,), 0x5A5A5A5A, dtype=torch.int32,
                          device=cuda)
        del junk                    # the next build may take its memory
        again = table_build.build_bucketed(*keys, n_rows, lay)
        assert torch.equal(again[0], table)
        assert (bool(again[1]), int(again[2])) == (bool(bad), int(walk))
    if case == "hashanno_shape":
        assert 1 <= int(walk) < 8
        assert bool(bad) == (layout == "bucketed"
                             and int(walk) >= table_build.BUCKETED.max_walk)


# ---------------------------------------------------------------------------
# DNA mode: the window probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k", [4, 8, 11, 15])
def test_dna_probe_kernel_matches_plain(cuda, k, weighted):
    """kan_dna_probe against its plain version on made-up streams (entries
    shorter than k and of exactly k bases, ambiguous bases, entries that
    join on table keys, lengths off powers of two, all invalid, valid to
    the stream's end; one kernel tile less one, exactly one and one more
    window, two tiles + k - 2; windows alternating valid and invalid;
    slices at byte offsets 1, 7 and 15 of odd length) over a table whose
    walks wrap, each with the table's key filter and without; one launch a
    call."""
    rng = np.random.default_rng(100 * k + weighted)
    table, mp, seq = dna_wrap_table(rng, k, weighted)
    assert mp >= 3
    t = wide_table_from_numpy(table, cuda)
    key_filter = flat_filter(t)
    for name, codes_np, valid_np, offsets in dna_streams(rng, k, seq):
        codes, valid = dna_stream_tensors(codes_np, valid_np, offsets, cuda)
        assert (codes.data_ptr() % 16, valid.data_ptr() % 16) == offsets
        want = probe_dna_plain(t, codes, valid, k=k, max_probes=mp)
        assert (want[~valid] == -1).all(), name
        for f in (None, key_filter):
            before = probe_dna.launches
            got = probe_dna(t, codes, valid, k=k, max_probes=mp,
                            key_filter=f)
            torch.cuda.synchronize()
            assert probe_dna.launches == before + 1
            assert torch.equal(got, want), (name, f is not None)


def test_dna_probe_on_an_empty_stream(cuda):
    table, mp, _ = dna_wrap_table(np.random.default_rng(1), 8, False)
    t = wide_table_from_numpy(table, cuda)
    before = probe_dna.launches
    out = probe_dna(t, torch.zeros(0, dtype=torch.uint8, device=cuda),
                    torch.zeros(0, dtype=torch.bool, device=cuda), k=8,
                    max_probes=mp)
    assert out.numel() == 0 and probe_dna.launches == before


@pytest.mark.parametrize("weighted", [False, True])
def test_dna_engine_on_cuda_matches_cpu(cuda, weighted, monkeypatch):
    """build --dna on small synthetic genomes, then the DNA engine on the
    card (the kernel, no plain version) against the CPU engine on a fifth
    genome: the same regions, roles and scores."""
    genomes, role_map = make_dna_signature_genomes(
        np.random.default_rng(5), 3, 40, 40, 4)
    table = build_signatures(genomes[:2], role_map, set(role_map.ids()),
                             k=15, progress=False, alphabet="dna",
                             weight_mode="balance" if weighted else "none",
                             device="cpu")
    kw = dict(min_hits=5, max_gap=300, weighted=weighted)
    want = DnaApplyEngine(table, **kw, device="cpu").call_genome(genomes[2])

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(dna_probe_mod, "probe_dna_plain", refuse)
    engine = DnaApplyEngine(table, **kw, device=cuda)
    assert engine.key_filter.device == engine.table.device
    before = probe_dna.launches
    got = engine.call_genome(genomes[2])
    assert probe_dna.launches == before + 1

    def key(calls):
        return [(f.id, f.location.strand, f.location.left, f.location.right,
                 role, score) for f, role, score in calls]

    assert key(got) == key(want)
    assert len(got) >= 20


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("flags", ["given", "from_keys"])
@pytest.mark.parametrize("case", ["collision_table", "k8_collide_wrap",
                                  "k12_collide_wrap"])
def test_probe_keys_kernel_matches_plain(cuda, case, flags, filtered):
    """``kan_probe_keys`` against ``probe_table`` bit for bit on tables
    with equal-lo buckets and walks that wrap (``keys_cases``), one key in
    ten an empty slot, validity given or taken from the keys, with the
    table's key filter and without; one launch."""
    rng = np.random.default_rng(23)
    name, table, mp, qlo, qhi = [c for c in keys_cases(rng)
                                 if c[0] == case][0]
    qlo = qlo.copy()
    qlo[rng.random(len(qlo)) < 0.1] = 0xFFFFFFFF
    d_table = wide_table_from_numpy(table, cuda)
    lo, hi = (torch.from_numpy(a.view(np.int32)).to(cuda)
              for a in (qlo, qhi))
    valid = (torch.from_numpy(rng.random(len(qlo)) < 0.7).to(cuda)
             if flags == "given" else None)
    key_filter = (build_key_filter(*table_keys(table), cuda) if filtered
                  else None)
    before = probe_keys.launches
    got = probe_keys(d_table, lo, hi, valid, max_probes=mp,
                     key_filter=key_filter)
    torch.cuda.synchronize()
    assert probe_keys.launches == before + 1
    want = probe_keys_plain(d_table.cpu(), lo.cpu(), hi.cpu(),
                            None if valid is None else valid.cpu(),
                            max_probes=mp)
    assert torch.equal(got.cpu(), want)
    assert (want >= 0).sum() > 10 and (want == -1).sum() > 10


def _keys_table(cuda):
    """``keys_cases``' k = 8 table (equal-lo buckets, walks that wrap), on
    the card, with its key filter."""
    _, table, mp, _, _ = [c for c in keys_cases(np.random.default_rng(23))
                             if c[0] == "k8_collide_wrap"][0]
    return (table, wide_table_from_numpy(table, cuda), mp,
            build_key_filter(*table_keys(table), cuda))


def _check_keys(cuda, d_table, mp, key_filter, klo, khi, live, flags,
                offset=0):
    """``probe_keys`` on (klo, khi) with ``live`` as its flags, or with
    the dead slots EMPTY, against its plain version on the CPU: one
    launch.  ``offset`` > 0 passes slices that start ``offset`` words
    (keys) and ``5 * offset`` bytes (flags) past a 16-byte boundary."""
    lo_np = klo if flags else np.where(live, klo, 0xFFFFFFFF)
    n = len(klo)

    def on_card(a, at):
        t = torch.from_numpy(a).to(cuda)
        whole = torch.zeros(n + at, dtype=t.dtype, device=cuda)
        whole[at:] = t
        return whole[at:]

    lo, hi = (on_card(a.view(np.int32), offset) for a in (lo_np, khi))
    valid = on_card(live, 5 * offset) if flags else None
    assert lo.data_ptr() % 16 == 4 * offset % 16
    before = probe_keys.launches
    got = probe_keys(d_table, lo, hi, valid, max_probes=mp,
                     key_filter=key_filter)
    torch.cuda.synchronize()
    assert probe_keys.launches == before + 1
    want = probe_keys_plain(d_table.cpu(), lo.cpu(), hi.cpu(),
                            None if valid is None else valid.cpu(),
                            max_probes=mp)
    assert torch.equal(got.cpu(), want)
    return want


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("flags", [False, True])
@pytest.mark.parametrize("share", KEYS_SHARES)
def test_probe_keys_kernel_live_shares(cuda, share, flags, filtered):
    """Inputs 0%, 3%, 28.6% and 100% live, of 3 tiles + 7 slots (no
    multiple of the tile or of 4), dead slots EMPTY or flagged."""
    table, d_table, mp, key_filter = _keys_table(cuda)
    klo, khi, live = live_share_keys(np.random.default_rng(31), table,
                                     3 * KERNEL_TILE + 7, share)
    want = _check_keys(cuda, d_table, mp, key_filter if filtered else None,
                       klo, khi, live, flags)
    assert int((want >= 0).sum()) <= int(live.sum())
    if share == 1.0:
        assert (want >= 0).sum() > KERNEL_TILE


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("flags", [False, True])
def test_probe_keys_kernel_tile_edges(cuda, flags, offset):
    """Tiles all dead, all live, live only at the first slot, only at the
    last, a run of dead slots across a tile edge, and 5 slots past the
    last whole tile; on slices off a 16-byte boundary."""
    table, d_table, mp, key_filter = _keys_table(cuda)
    t = KERNEL_TILE
    klo, khi, _ = live_share_keys(np.random.default_rng(32), table,
                                  6 * t + 5, 1.0)
    live = np.ones(6 * t + 5, bool)
    live[:t] = False                       # tile 0: all dead
    live[2 * t + 1: 3 * t] = False         # tile 2: only its first slot
    live[3 * t: 4 * t - 1] = False         # tile 3: only its last slot
    live[5 * t - 37: 5 * t + 41] = False   # a dead run across an edge
    want = _check_keys(cuda, d_table, mp, key_filter, klo, khi, live, flags,
                       offset)
    assert (want[:t] == -1).all() and (want[t: 2 * t] >= 0).sum() > t // 3
    assert (want[2 * t + 1: 4 * t - 1] == -1).all()


@pytest.mark.parametrize("n", [1, 3, 4, 5, KERNEL_TILE - 1, KERNEL_TILE,
                               KERNEL_TILE + 1])
def test_probe_keys_kernel_odd_sizes(cuda, n):
    table, d_table, mp, key_filter = _keys_table(cuda)
    klo, khi, live = live_share_keys(np.random.default_rng(n), table, n,
                                     0.5)
    for flags in (False, True):
        _check_keys(cuda, d_table, mp, key_filter, klo, khi, live, flags,
                    offset=n % 4)


def test_probe_keys_on_an_empty_query(cuda):
    _, table, mp, _, _ = next(keys_cases(np.random.default_rng(2)))
    empty = torch.empty(0, dtype=torch.int32, device=cuda)
    before = probe_keys.launches
    out = probe_keys(wide_table_from_numpy(table, cuda), empty, empty, None,
                     max_probes=mp)
    assert out.numel() == 0 and probe_keys.launches == before


@pytest.mark.parametrize("weights", ["none", "balance"])
@pytest.mark.parametrize("shape", [(2, 1, "replicated"), (2, 2, "pmax"),
                                   (2, 2, "routed"), (1, 4, "routed")])
def test_mesh_engine_on_cuda_matches_cpu(cuda, shape, weights, monkeypatch):
    """The mesh with every member on the card against the same mesh on
    CPU members (which the CPU tests hold equal to the reference): the
    same calls, tallies to their printed places; the sharded modes launch
    the key-lookup kernel and call no plain version, the replicated one
    the flat kernels."""
    n_data, n_table, mode = shape
    genomes, role_map, good = _signature_case()
    genomes = genomes + make_signature_genomes(np.random.default_rng(6), 1,
                                               60, 40, 3)[0]
    table = build_signatures(genomes, role_map, good, k=8, progress=False,
                             weight_mode=weights, device="cpu")
    kw = dict(min_hits=5, mode=mode, weighted=weights != "none")

    def calls(devices):
        engine = MeshApplyEngine(table, n_data, n_table, devices=devices,
                                 **kw)
        return [[(f.id, role, hits) for f, role, hits in c]
                for _, c in engine.call_genomes(genomes)]

    want = calls([torch.device("cpu")] * (n_data * n_table))

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(probe_keys_mod, "probe_keys_plain", refuse)
    monkeypatch.setattr(apply_flat_mod, "apply_flat_plain", refuse)
    monkeypatch.setattr(apply_flat_mod, "apply_weighted_flat_plain", refuse)
    before = (probe_keys.launches, apply_flat.launches,
              apply_weighted_flat.launches)
    got = calls([cuda] * (n_data * n_table))
    after = (probe_keys.launches, apply_flat.launches,
             apply_weighted_flat.launches)
    assert got == want and sum(map(len, got)) > 60
    rows = -(-len(genomes) // n_data) * n_data
    if mode == "replicated":
        which = 2 if weights != "none" else 1
        assert after[which] - before[which] == rows
    elif mode == "pmax":
        assert after[0] - before[0] == rows * n_table
    else:   # a padding row's owners receive no key and launch nothing
        assert after[0] - before[0] == len(genomes) * n_table


@pytest.mark.parametrize("n_data,n_table", [(2, 1), (1, 2)])
def test_dna_mesh_engine_on_cuda_matches_cpu(cuda, n_data, n_table):
    genomes, role_map = make_dna_signature_genomes(
        np.random.default_rng(5), 3, 40, 40, 4)
    table = build_signatures(genomes[:2], role_map, set(role_map.ids()),
                             k=15, progress=False, alphabet="dna",
                             device="cpu")
    want = DnaApplyEngine(table, min_hits=5, max_gap=300,
                          device="cpu").call_genome(genomes[2])
    engine = DnaMeshApplyEngine(table, n_data, n_table, min_hits=5,
                                max_gap=300,
                                devices=[cuda] * (n_data * n_table))
    before = probe_dna.launches
    (_, got), = engine.call_genomes(genomes[2:])
    assert probe_dna.launches - before == n_data * n_table

    def key(calls):
        return [(f.id, f.location.strand, f.location.left, f.location.right,
                 role, score) for f, role, score in calls]

    assert key(got) == key(want) and len(got) >= 20


def _table_build_on_card(cuda, layout, keys, n_rows, salt):
    """The kernel's build against the plain version's on the card: table
    and bad equal; one launch counted (an empty input too: the kernel
    writes its empty table)."""
    wrapper, lay = ((table_build.build_wide, table_build.WIDE)
                    if layout == "wide"
                    else (table_build.build_bucketed, table_build.BUCKETED))
    extra = (salt,) if layout == "wide" else (lay,)
    before = wrapper.launches
    table, bad = wrapper(*keys, n_rows, *extra)[:2]
    torch.cuda.synchronize()
    assert wrapper.launches - before == 1
    want, want_bad, _ = table_build.build_table_plain(*keys, n_rows, lay,
                                                      salt)
    assert table.device.type == "cuda" and torch.equal(table, want)
    assert bool(bad) == bool(want_bad)
    return table, bool(bad)


# (real keys, padded length): edges at 1,024 and 4,096 keys, no pads, and
# tables of 2^18 wide rows and 2^21 buckets (64 and 512 scan tiles of
# 4,096 rows, each waiting on the tiles before it)
TABLE_SIZES = [(0, 64), (1, 8), (1_023, 1_023), (1_024, 1_024),
               (1_025, 2_048), (4_095, 4_095), (4_096, 4_096),
               (4_097, 8_192), (5_000, 8_192), (1_500_000, 2_097_152)]


@pytest.mark.parametrize("layout", ["wide", "bucketed"])
@pytest.mark.parametrize("n,n_pad", TABLE_SIZES)
def test_table_build_kernel_matches_plain(cuda, layout, n, n_pad):
    rng = np.random.default_rng(n + 1)
    keys = int32_tensors(padded_keys([random_keys(rng, n)], n_pad, rng),
                         cuda)
    if layout == "wide":
        for salt in (0, 12_345):
            _table_build_on_card(cuda, layout, keys, wide_rows_for(n_pad),
                                 salt)
    else:
        _table_build_on_card(cuda, layout, keys,
                             device_table_buckets(n_pad), GOLDEN)


@pytest.mark.parametrize("case", list(TABLE_BUILD_EDGES))
def test_table_build_kernel_on_forced_cases(cuda, case):
    layout, _, arrays, n_rows, salt, want_bad = edge_keys(case)
    _, bad = _table_build_on_card(cuda, layout, int32_tensors(arrays, cuda),
                                  n_rows, salt)
    assert bad == want_bad


@pytest.mark.parametrize("layout", ["wide", "bucketed"])
def test_table_build_repeats_bit_for_bit(cuda, layout):
    """Atomics arrive in any order: ten builds of the same keys, on
    memory left full of junk, write one table and one bad flag."""
    rng = np.random.default_rng(11)
    keys = int32_tensors(padded_keys([random_keys(rng, 200_000)], 262_144,
                                     rng), cuda)
    wrapper, extra = ((table_build.build_wide, ()) if layout == "wide"
                      else (table_build.build_bucketed,
                            (table_build.BUCKETED,)))
    n_rows = (wide_rows_for(262_144) if layout == "wide"
              else device_table_buckets(262_144))
    first, first_bad = wrapper(*keys, n_rows, *extra)[:2]
    for _ in range(10):
        junk = torch.full((4 << 20,), 0x5A5A5A5A, dtype=torch.int32,
                          device=cuda)
        del junk                    # the next build may take its memory
        table, bad = wrapper(*keys, n_rows, *extra)[:2]
        assert torch.equal(table, first) and bool(bad) == bool(first_bad)


def test_table_build_on_an_empty_input(cuda):
    empty = torch.empty(0, dtype=torch.int32, device=cuda)
    for layout in ("wide", "bucketed"):
        table, bad = _table_build_on_card(cuda, layout, [empty] * 3, 128,
                                          0 if layout == "wide" else GOLDEN)
        assert not bad and int((table[:, :8] != -1).sum()) == 0


@pytest.mark.parametrize("layout", ["wide", "bucketed"])
def test_close_tables_on_cuda_match_cpu(cuda, layout, monkeypatch):
    """The annotator's close-genome tables built on the card equal the
    CPU annotator's (the plain builds, which the CPU tests hold equal to
    the reference's), with no host build and one launch a table."""
    if layout == "bucketed":
        monkeypatch.setattr(projection, "wide_rows_for", lambda n: None)
    _, olds, _ = make_projection_workload(np.random.default_rng(3), 300, 3)
    olds = list(olds.values())
    counter = (table_build.build_wide if layout == "wide"
               else table_build.build_bucketed)
    fallbacks, launches = projection.host_fallback.count, counter.launches
    cpu = ProjectionAnnotator(device="cpu")
    card = ProjectionAnnotator(device=cuda)
    for og in olds:
        want, got = cpu._close_table(og), card._close_table(og)
        assert torch.equal(got[0].cpu(), want[0]) and got[1:4] == want[1:4]
    if layout == "wide":
        want, got = cpu._close_set(olds), card._close_set(olds)
        assert all(torch.equal(g.cpu(), w)
                   for g, w in zip(got.tables, want.tables))
        assert (got.salts, got.mps) == (want.salts, want.mps)
        assert torch.equal(got.union_table.cpu(), want.union_table)
        assert (got.union_salt, got.union_mp, got.n_union_keys) == (
            want.union_salt, want.union_mp, want.n_union_keys)
    assert projection.host_fallback.count == fallbacks
    assert counter.launches - launches == len(olds) * (
        2 if layout == "wide" else 1)


def _union_on_card(cuda, case):
    """The union kernels against their plain version on one
    ``UNION_CASES`` case: n_keys and bad of the dedupe, then the table
    and bad of the build; one launch of each.  Returns (rows, table)."""
    lo, hi = union_keys(case)
    keys = [torch.from_numpy(a.view(np.int32).copy()) for a in (lo, hi)]
    before = (table_build.union_dedupe.launches,
              table_build.union_build.launches)
    rows = table_build.union_dedupe(*(k.to(cuda) for k in keys))
    want_rows = table_build.union_dedupe(*keys)
    n_rows, where = UNION_CASES[case]
    assert rows.bad == want_rows.bad == (where == "dedupe")
    if rows.bad:
        return rows, None
    assert rows.n_keys == want_rows.n_keys
    assert wide_rows_for(rows.n_keys) == n_rows
    table, bad = table_build.union_build(rows, n_rows)
    want, want_bad = table_build.union_build(want_rows, n_rows)
    torch.cuda.synchronize()
    assert (table_build.union_dedupe.launches - before[0],
            table_build.union_build.launches - before[1]) == (1, 1)
    assert table.device.type == "cuda" and torch.equal(table.cpu(), want)
    assert bool(bad) == bool(want_bad) == (where == "build")
    return rows, table


@pytest.mark.parametrize("case", list(UNION_CASES))
def test_union_kernels_match_plain(cuda, case):
    _union_on_card(cuda, case)


def test_union_build_repeats_bit_for_bit(cuda):
    """Atomics arrive in any order: five builds of the realistic union,
    on memory left full of junk, give one count and one table."""
    lo, hi = (torch.from_numpy(a.view(np.int32).copy()).to(cuda)
              for a in union_keys("realistic"))
    first_rows, first = _union_on_card(cuda, "realistic")
    for _ in range(5):
        junk = torch.full((64 << 20,), 0x5A5A5A5A, dtype=torch.int32,
                          device=cuda)
        del junk                    # the next build may take its memory
        rows = table_build.union_dedupe(lo, hi)
        table, bad = table_build.union_build(rows, first.shape[0])
        assert (rows.n_keys, rows.bad) == (first_rows.n_keys, False)
        assert torch.equal(table, first) and not bool(bad)


def test_close_set_on_card_evicts_before_building(cuda, monkeypatch):
    """A full cache drops its oldest set before the next set's union keys
    go up: the device then holds three sets' bytes, never five, and the
    cache never more than 4 sets."""
    _, olds, _ = make_projection_workload(np.random.default_rng(5), 300, 3)
    olds = list(olds.values())
    orders = [list(o) for o in itertools.permutations(olds)][:5]
    annot = ProjectionAnnotator(device=cuda)
    seen = []
    dedupe = projection.union_dedupe

    def spy(*args):
        torch.cuda.synchronize()
        seen.append((list(annot._closeset_cache),
                     torch.cuda.memory_allocated(cuda)))
        return dedupe(*args)

    monkeypatch.setattr(projection, "union_dedupe", spy)
    allocated = []
    for o in orders:
        annot._close_set(o)
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated(cuda))
        assert len(annot._closeset_cache) <= 4
    keys = [(tuple(og.id for og in o), annot.k) for o in orders]
    assert [len(c) for c, _ in seen] == [0, 1, 2, 3, 3]
    assert seen[4][0] == keys[1:4]
    assert list(annot._closeset_cache) == keys[1:]
    # one set's bytes: what the fourth set added; the fifth build started
    # with three sets held, and ended with four (within a quarter set:
    # the sets' sizes and the allocator's rounding move a little)
    one_set = allocated[3] - allocated[2]
    assert one_set > 0
    assert seen[4][1] <= allocated[3] - one_set + one_set // 4
    assert abs(allocated[4] - allocated[3]) <= one_set // 4
