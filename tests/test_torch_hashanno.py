"""The port's hashAnno against the JAX reference on the CPU.

The chunk step's plain versions (``hash_commons_plain``,
``hash_best_plain``, the plain versions of ``csrc/hash_chunk.cu``) against
the reference's ``_chunk_commons`` and ``_chunk_best`` at odd sizes; the
engine's index build array for array, its tensor code on CPU tensors
(the table's plain version underneath) against the reference and the
host build, on walks of several buckets, a wrap past the last bucket,
owners past the cap, no kmers and both drop-last settings;
``GenomeProteinKmers`` on the cases
of ``tests/test_hashanno.py`` (best similarity float64 ``==``, the same
annotation, the same improvement count) on both routes; and the
``hashAnno`` CLI's files byte for byte.  Exact throughout.
"""

import copy
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (carried_state, host_distinct_pairs, host_hash_index,
                        index_differences, made_up_chunk, reorder_chunk,
                        tile_cells)
from kmers_anno_tpu.commands.app import main as ref_main
from kmers_anno_tpu.engine import hashanno as ref_ha
from kmers_anno_tpu.engine import protein_kmers as ref_pk
from kmers_anno_tpu.engine.projection import _min_ev_table as ref_minev
from kmers_anno_tpu.genome.gto import protein_md5
from kmers_anno_tpu.ops.hashtable import probe_table as ref_probe
from kmers_anno_tpu_torch.commands.app import main as port_main
from kmers_anno_tpu_torch.engine import hashanno as port_ha
from kmers_anno_tpu_torch.engine import protein_kmers as port_pk
from kmers_anno_tpu_torch.ops import hash_chunk
from kmers_anno_tpu_torch.ops.encode import encode_protein
from kmers_anno_tpu_torch.ops.hashing import mix_kmer_np
from kmers_anno_tpu_torch.ops.hashtable import table_size_for
from kmers_anno_tpu_torch.ops.kmers import pack_kmers_np
from kmers_anno_tpu_torch.utils import spans
from tests.fixtures import make_genome, random_protein

K = 8
MIN_SCORE = 0.0125
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module's tests run (the suite runs
    in several worker processes; see test_torch_mesh.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return np.asarray(t)


def _ref_ranks(c):
    return ref_probe(jnp.asarray(c["table"].numpy().view(np.uint32)),
                     jnp.asarray(c["lo"].numpy().view(np.uint32)),
                     jnp.asarray(c["hi"].numpy().view(np.uint32)),
                     jnp.asarray(c["valid"].numpy()), c["max_probes"])


def _ref_rows(n_rows):
    return 1 << max(n_rows - 1, 0).bit_length()


def _ref_owner_mat(c):
    """The owner matrix as the reference takes it: padded with n_pad
    (``made_up_chunk`` pads with the engine's bucket, which may be
    larger; the port's versions skip any owner >= n_pad)."""
    own = c["owner_mat"].numpy()
    return jnp.asarray(np.minimum(own, c["n_pad"]))


# ---------------------------------------------------------------------------
# the chunk step's plain versions against the reference
# ---------------------------------------------------------------------------

CHUNK_CASES = {
    "k8_odd": dict(k=8, n_prot=301, n_rows=37),
    "k12_walk": dict(k=12, n_prot=150, n_rows=61, squeeze=True),
    "k8_owners_at_cap": dict(k=8, n_prot=120, n_rows=19, family=40),
    "k5_exact_cols": dict(k=5, n_prot=77, n_rows=5, exact_cols=True),
    "k8_one_row": dict(k=8, n_prot=9, n_rows=1),
}


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_hash_commons_plain_matches_reference(case):
    params = CHUNK_CASES[case]
    c = made_up_chunk(np.random.default_rng(len(case)), **params)
    if params.get("squeeze"):
        assert c["max_probes"] > 1
    if params.get("family", 1) > hash_chunk.OWNER_CAP:
        assert c["owner_mat"].shape[1] == hash_chunk.OWNER_CAP
    ranks = _ref_ranks(c)
    rows = _ref_rows(c["n_rows"])
    want = ref_ha._chunk_commons(
        _ref_owner_mat(c), ranks,
        jnp.asarray(np.minimum(c["proto"].numpy(), rows)),
        n_prot=c["n_pad"], n_proto=rows)
    args = (c["table"], c["max_probes"], c["owner_mat"], c["lo"], c["hi"],
            c["proto"], c["valid"], c["n_rows"], c["n_pad"])
    got, got_ranks = hash_chunk.hash_commons_plain(*args, with_ranks=True)
    np.testing.assert_array_equal(got_ranks.numpy(), _np(ranks))
    np.testing.assert_array_equal(got.numpy(),
                                  _np(want)[: c["n_rows"]])
    assert got.dtype == torch.int32 and int(got.sum()) > 0
    # the wrapper on CPU tensors is the plain version (no launch), and an
    # ``out`` buffer is added into
    before = hash_chunk.hash_commons.launches
    out = torch.zeros((c["n_rows"] + 3, c["n_pad"]), dtype=torch.int32)
    again = hash_chunk.hash_commons(*args, out=out)
    assert hash_chunk.hash_commons.launches == before
    assert torch.equal(again, got) and again.data_ptr() == out.data_ptr()
    assert not out[c["n_rows"]:].any()


@pytest.mark.parametrize("case", list(CHUNK_CASES))
@pytest.mark.parametrize("min_score", [0.0125, 0.0, 0.3])
def test_hash_best_plain_matches_reference(case, min_score):
    params = CHUNK_CASES[case]
    rng = np.random.default_rng(len(case) + int(100 * min_score))
    c = made_up_chunk(rng, min_score=min_score, **params)
    state = carried_state(rng, c["n_pad"])
    base = 1234
    ranks = _ref_ranks(c)
    rows = _ref_rows(c["n_rows"])
    n2 = np.zeros(rows, np.int32)
    n2[: c["n_rows"]] = c["n2"].numpy()[: c["n_rows"]]
    want = ref_ha._chunk_best(
        _ref_owner_mat(c), ranks,
        jnp.asarray(np.minimum(c["proto"].numpy(), rows)),
        jnp.asarray(c["n1"].numpy()), jnp.asarray(n2),
        jnp.asarray(ref_minev(min_score, c["minc"].shape[0] - 1)),
        *(jnp.asarray(s.numpy()) for s in state[:3]),
        jnp.int32(int(state[3][0])), jnp.int32(base),
        n_prot=c["n_pad"], n_proto=rows)
    common = hash_chunk.hash_commons_plain(
        c["table"], c["max_probes"], c["owner_mat"], c["lo"], c["hi"],
        c["proto"], c["valid"], c["n_rows"], c["n_pad"])
    got = tuple(s.clone() for s in state)
    before = hash_chunk.hash_best.launches
    hash_chunk.hash_best(common, c["n_rows"], c["n1"], c["n2"], c["minc"],
                         got, base)
    assert hash_chunk.hash_best.launches == before
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    assert int(got[3][0]) == int(want[3])
    assert not common.any()                 # the counts were consumed
    if min_score == 0.0125 and case == "k8_odd":
        assert int(want[3]) > 17            # some protein improved


@pytest.mark.parametrize("order", ["shuffled", "key-major"])
@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_hash_commons_plain_is_order_free(case, order):
    """The same chunk in another order of its kmers gives the same counts,
    and each position the rank of the kmer it now holds.  In the engine's
    order no kernel tile holds more distinct cells than in the other."""
    c = made_up_chunk(np.random.default_rng(len(case) + 7),
                      **CHUNK_CASES[case])
    moved, perm = reorder_chunk(c, order, np.random.default_rng(len(order)))
    assert sorted(perm.tolist()) == list(range(c["lo"].numel()))
    keys = ("table", "max_probes", "owner_mat", "lo", "hi", "proto",
            "valid", "n_rows", "n_pad")
    want, want_ranks = hash_chunk.hash_commons_plain(
        *(c[k] for k in keys), with_ranks=True)
    got, ranks = hash_chunk.hash_commons_plain(*(moved[k] for k in keys),
                                               with_ranks=True)
    assert torch.equal(got, want) and int(got.sum()) > 0
    assert torch.equal(ranks, want_ranks[perm])
    engine_cells = tile_cells(c, want_ranks)
    cells = tile_cells(moved, ranks)
    assert int(engine_cells.sum()) <= int(cells.sum())
    assert int(engine_cells.sum()) >= int((want != 0).sum())
    if len(cells) == 1:
        assert int(cells[0]) == int((want != 0).sum())


@pytest.fixture
def drop_last_both(request):
    """Both packages' drop-last flag at ``request.param``; both restored
    to off whatever happens."""
    ref_pk.set_drop_last(request.param)
    port_pk.set_drop_last(request.param)
    try:
        yield request.param
    finally:
        ref_pk.set_drop_last(False)
        port_pk.set_drop_last(False)


def _short_prototypes(genome):
    """Oracle prototypes with prototypes shorter than K among them, and a
    chunk of 5 whose every prototype is shorter."""
    protos = _oracle_case(genome)[1][:7]
    short = ["MKV", "ACDEFGH", "W", "", "KLMNPQR"]
    return (protos[:5] + [(p, f"short anno {i}") for i, p in
                          enumerate(short)] + [("ACDEFGHI", "just K")]
            + protos[5:])


# case: (chunk size, prototypes, the drop-last flag)
PROTO_CASES = {
    "4096": (4096, "oracle", False),
    "7": (7, "oracle", False),
    "4096-drop_last": (4096, "oracle", True),
    "7-drop_last": (7, "oracle", True),
    "short": (5, "short", False),
    "short-drop_last": (5, "short", True),
}


@pytest.mark.parametrize("drop_last_both,case",
                         [(v[2], c) for c, v in PROTO_CASES.items()],
                         ids=list(PROTO_CASES), indirect=["drop_last_both"])
def test_prototype_chunks_hold_the_reference_pairs(genome, drop_last_both,
                                                   case):
    """PrototypeSet.chunks packs each chunk prototype by prototype, each
    prototype's kmers in key order, the prototypes ordered by their
    smallest kmer (then by row): the reference's distinct (kmer,
    prototype) pairs as a multiset, with the same n2, row count and
    padding, and byte for byte the host's key-major pairs
    (``host_distinct_pairs``) in that order; the whole prototype list in
    one chunk, and split in chunks of 7, with the drop-last fence off and
    on; and prototypes shorter than K in chunks of 5."""
    chunk, which, _ = PROTO_CASES[case]
    prototypes = (_oracle_case(genome)[1] if which == "oracle"
                  else _short_prototypes(genome))
    ref = ref_ha.PrototypeSet([ref_ha.Prototype(*p) for p in prototypes], K)
    port = port_ha.PrototypeSet([port_ha.Prototype(*p) for p in prototypes],
                                K)
    want, got = ref.chunks(chunk), port.chunks(chunk, CPU)
    assert len(got) == len(want) == -(-len(prototypes) // chunk)
    for w, g in zip(want, got):
        lo, hi, proto, valid, n2, sub, n_proto, d_n2 = g
        assert [(x.protein, x.annotation) for x in sub] == [
            (x.protein, x.annotation) for x in w[5]]
        assert n_proto == w[6]
        np.testing.assert_array_equal(n2, w[4])
        np.testing.assert_array_equal(d_n2.numpy(), w[4])
        np.testing.assert_array_equal(valid.numpy(), _np(w[3]))
        cols = [lo.numpy().view(np.uint32), hi.numpy().view(np.uint32),
                proto.numpy()]
        pairs = np.stack(cols).astype(np.int64)
        want_pairs = np.stack([_np(w[0]), _np(w[1]),
                               _np(w[2])]).astype(np.int64)
        assert (sorted(map(tuple, pairs.T))
                == sorted(map(tuple, want_pairs.T)))
        h_lo, h_hi, h_own, h_n2 = host_distinct_pairs(
            [x.protein for x in sub])
        order = port_ha._similar_prototypes_adjacent(h_own, len(sub))
        v = valid.numpy()
        for got_col, host_col in zip(cols, (h_lo, h_hi, h_own)):
            np.testing.assert_array_equal(got_col[v], host_col[order])
        np.testing.assert_array_equal(n2[: len(sub)], h_n2)
        p = proto.numpy()
        assert (p[~v] == n_proto).all() and not v[v.sum():].any()
        p = p[v]
        key = ((cols[1][v].astype(np.uint64) << np.uint64(32))
               | cols[0][v])
        starts = np.flatnonzero(np.r_[True, p[1:] != p[:-1]][: len(p)])
        assert len(starts) == len(set(p.tolist()))
        if which == "oracle":
            assert len(starts) > (1 if chunk == 7 else 10)
        same = p[1:] == p[:-1]
        assert (key[1:][same] > key[:-1][same]).all()
        first = list(zip(key[starts].tolist(), p[starts].tolist()))
        assert first == sorted(first)
    if which == "short":
        # the second chunk's prototypes are all shorter than K
        assert not got[1][3].any() and not got[1][4].any()
        assert got[0][3].any() and got[2][3].any()


def test_hash_commons_rejects_too_many_cells():
    """The count kernel indexes a chunk's cells in 32 bits: both versions
    refuse n_rows x n_pad past MAX_CELLS before allocating anything."""
    c = made_up_chunk(np.random.default_rng(1), 8, 20, 4)
    args = [c["table"], c["max_probes"], c["owner_mat"], c["lo"], c["hi"],
            c["proto"], c["valid"]]
    n_rows = hash_chunk.MAX_CELLS // c["n_pad"] + 1
    for fn in (hash_chunk.hash_commons, hash_chunk.hash_commons_plain):
        with pytest.raises(ValueError, match="MAX_CELLS|cells"):
            fn(*args, n_rows, c["n_pad"])


def test_kernel_constants_are_the_sources():
    """The smoke's tile model reads the kernel's tile and table sizes."""
    src = os.path.join(os.path.dirname(hash_chunk.__file__), os.pardir,
                       "csrc", "hash_chunk.cu")
    with open(src, encoding="utf-8") as fh:
        text = fh.read()
    assert f"constexpr int kTileKmers = {hash_chunk.COMMONS_TILE};" in text
    assert (f"constexpr int kTableCells = "
            f"{hash_chunk.COMMONS_TABLE_CELLS};") in text


def test_hash_chunk_rejects_bad_arguments():
    c = made_up_chunk(np.random.default_rng(1), 8, 20, 4)
    args = [c["table"], c["max_probes"], c["owner_mat"], c["lo"], c["hi"],
            c["proto"], c["valid"], 4, c["n_pad"]]
    for i, bad in ((2, c["owner_mat"].long()), (5, c["proto"].long()),
                   (3, c["lo"][:-1]), (0, c["table"][:, :20])):
        with pytest.raises(ValueError):
            hash_chunk.hash_commons(*args[:i], bad, *args[i + 1:])
    state = carried_state(np.random.default_rng(2), c["n_pad"])
    common = torch.zeros((4, c["n_pad"]), dtype=torch.int32)
    with pytest.raises(ValueError):
        hash_chunk.hash_best(common, 5, c["n1"], c["n2"], c["minc"], state, 0)
    with pytest.raises(ValueError):
        hash_chunk.hash_best(common, 4, c["n1"][:-1], c["n2"], c["minc"],
                             state, 0)
    with pytest.raises(ValueError):
        hash_chunk.hash_best(common, 4, c["n1"], c["n2"], c["minc"],
                             state[:3], 0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _both(proteins, prototypes=None, min_score=MIN_SCORE, chunk=4096):
    """Both packages' GenomeProteinKmers over (fid, protein, old)
    triples, scored with ``prototypes`` when given: (ref, port, returns)."""
    gks = [ref_ha.GenomeProteinKmers(K, min_score),
           port_ha.GenomeProteinKmers(K, min_score, device=CPU)]
    for gk in gks:
        for fid, prot, old in proteins:
            gk.add_protein(fid, prot, old)
    got = None
    if prototypes is not None:
        got = [gk.process_proposals([m.Prototype(p, a) for p, a in
                                     prototypes], chunk=chunk)
               for gk, m in zip(gks, (ref_ha, port_ha))]
    return gks[0], gks[1], got


def _assert_same_proposals(ref, port, proteins):
    for _, prot, _ in proteins:
        md5 = protein_md5(prot)
        want, got = ref.get_proposal(md5), port.get_proposal(md5)
        assert type(got[0]) is float
        assert got == want, (got, want)
    assert port.get_proposal("no such md5") is None


@pytest.fixture(scope="module")
def genome():
    return make_genome("500.1", seed=77, n_per_role=4)


def _oracle_case(genome):
    """The prototypes of test_hashanno.test_engine_matches_oracle: exact
    copies, fragments, three-substitution mutants and noise."""
    rng = random.Random(5)
    pegs = [f for f in genome.pegs if f.protein_translation
            and "*" not in f.protein_translation]
    prototypes = []
    for i, f in enumerate(pegs[:8]):
        p = f.protein_translation
        prototypes.append((p, f"exact anno {i}"))
        prototypes.append((p[5: 5 + max(K + 4, len(p) // 2)],
                           f"fragment anno {i}"))
        mutated = list(p)
        for _ in range(3):
            mutated[rng.randrange(len(mutated))] = rng.choice("ACDEFGHIK")
        prototypes.append(("".join(mutated), f"mutant anno {i}"))
    prototypes.append((random_protein(rng, 80), "noise anno"))
    return [(f.id, f.protein_translation, f.peg_function)
            for f in pegs], prototypes


def test_build_matches_reference(genome):
    """The index both packages build from the same proteins: owner
    matrix, 8-slot table and walk bound, kmer counts, heavy CSR."""
    proteins, _ = _oracle_case(genome)
    ref, port, _ = _both(proteins)
    ref._build()
    port._build()
    np.testing.assert_array_equal(port.owner_mat.numpy(),
                                  _np(ref.owner_mat))
    np.testing.assert_array_equal(port.table.numpy().view(np.uint32),
                                  _np(ref.table))
    assert port.max_probes == ref.max_probes
    assert (port.n_pad, port.kmer_count, port.n_kmers) == (
        ref.n_pad, ref.kmer_count, ref.n_kmers)
    np.testing.assert_array_equal(port.protein_kmer_counts,
                                  ref.protein_kmer_counts)
    for name in ("heavy_ranks", "heavy_off", "heavy_owners"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    assert port.best_anno == ref.best_anno
    assert port._md5_of == ref._md5_of


def _homed_proteins(seed: int, homes: dict) -> list[str]:
    """Distinct proteins of K residues, one kmer each, ``homes[b]`` of
    them homed in bucket ``b`` of the index's table (``table_size_for``
    of their count)."""
    rng = random.Random(seed)
    n_buckets = table_size_for(sum(homes.values()))
    left, out = dict(homes), []
    while any(left.values()):
        p = random_protein(rng, K)
        lo, hi = pack_kmers_np(encode_protein(p), K)
        b = int(mix_kmer_np(lo, hi)[0]) & (n_buckets - 1)
        if left.get(b) and p not in out:
            left[b] -= 1
            out.append(p)
    return out


def _index_proteins(case, genome, monkeypatch) -> list:
    """A build case's (fid, protein, old) triples."""
    if case == "fixture":
        return _oracle_case(genome)[0]
    if case == "owners_past_cap":
        monkeypatch.setattr(ref_ha, "OWNER_CAP", 2)
        monkeypatch.setattr(port_ha, "OWNER_CAP", 2)
        return _family_case()[0]
    prots = {
        # 26 keys from bucket 2 walk 3 buckets, 18 from bucket 9 walk 2
        "walks_2_and_3": lambda: _homed_proteins(
            31, {2: 26, 9: 18, 0: 4, 1: 4, 7: 4, 13: 4, 14: 4}),
        # 12 keys in the last of 16 buckets: 4 wrap to bucket 0
        "wrap": lambda: _homed_proteins(
            32, {15: 12, **{b: 4 for b in range(13)}}),
        "shorter_than_k": lambda: ["MKV", "ACDEFGH", "W"],
        "no_protein": lambda: [],
    }[case]()
    return [(f"fig|9.9.peg.{i}", p, f"old {i}") for i, p in enumerate(prots)]


INDEX_CASES = ["fixture", "walks_2_and_3", "wrap", "owners_past_cap",
               "shorter_than_k", "no_protein"]


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("case", INDEX_CASES)
def test_device_index_is_the_host_build(case, drop_last, genome,
                                        monkeypatch):
    """The index's tensor code on CPU tensors (``build_table_plain``
    under the table) against the reference's host build and the port's
    host build (``host_hash_index``), byte for byte: table,
    ``max_probes``, owner matrix, kmer counts, heavy CSR, a key that wraps
    past the last bucket included; counted in ``device_index``."""
    proteins = _index_proteins(case, genome, monkeypatch)
    ref_pk.set_drop_last(drop_last)
    port_pk.set_drop_last(drop_last)
    try:
        ref, port, _ = _both(proteins)
        built = port_ha.GenomeProteinKmers.device_index
        ref._build()
        spans.enable()
        port._build()
        (rec,) = [r for r in spans.records() if r.name == "hash.index"]
        want = host_hash_index(port._proteins, CPU) if port.kmer_count \
            else None
    finally:
        spans.disable()
        spans.clear()
        ref_pk.set_drop_last(False)
        port_pk.set_drop_last(False)
    assert port.kmer_count == ref.kmer_count
    np.testing.assert_array_equal(port.protein_kmer_counts,
                                  ref.protein_kmer_counts)
    assert port.protein_kmer_counts.dtype == np.int64
    assert set(rec.attrs) == {"kmers", "buckets", "heavy"}
    if not port.kmer_count:
        assert port.table is None and ref.table is None
        assert port_ha.GenomeProteinKmers.device_index == built
        return
    assert index_differences(port, want) == []
    np.testing.assert_array_equal(port.owner_mat.numpy(),
                                  _np(ref.owner_mat))
    np.testing.assert_array_equal(port.table.numpy().view(np.uint32),
                                  _np(ref.table))
    assert (port.max_probes, port.n_pad) == (ref.max_probes, ref.n_pad)
    for name in ("heavy_ranks", "heavy_off", "heavy_owners"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    assert port_ha.GenomeProteinKmers.device_index == built + 1
    if case == "walks_2_and_3" and not drop_last:
        assert port.max_probes == 4
    if case == "wrap" and not drop_last:
        # bucket 15's last 4 keys in bucket 0: a walk of 1
        assert port.max_probes == 2
        assert int((port.table[0, :8] != -1).sum()) == 8
    if case == "owners_past_cap":
        assert len(port.heavy_owners) > 0


@pytest.mark.parametrize("chunk", [5, 7, 4096])
def test_engine_matches_reference_and_oracle(genome, chunk):
    """The oracle case of test_hashanno (chunk=5 there), and chunk sizes
    that are not powers of two: the improvement count is per chunk, so it
    depends on the chunk size, equally in both packages."""
    from tests.test_hashanno import oracle_hashanno

    proteins, prototypes = _oracle_case(genome)
    ref, port, got = _both(proteins, prototypes, chunk=chunk)
    assert got[1] == got[0] > 0
    _assert_same_proposals(ref, port, proteins)
    seen, uniq = set(), []
    for _, prot, _ in proteins:
        if protein_md5(prot) not in seen:
            seen.add(protein_md5(prot))
            uniq.append(prot)
    want = oracle_hashanno(uniq, prototypes)
    for prot, (wsim, wanno) in zip(uniq, want):
        sim, anno = port.get_proposal(protein_md5(prot))
        assert sim == pytest.approx(wsim, rel=1e-12)
        if wanno is not None:
            assert anno == wanno


def test_annotate_rows_classification_matches_reference(genome):
    pegs = [f for f in genome.pegs if f.protein_translation]
    protos = [(pegs[0].protein_translation, pegs[0].peg_function),
              (pegs[1].protein_translation, "Completely new function")]
    want = ref_ha.annotate_genome_rows(
        genome, [ref_ha.Prototype(*p) for p in protos], K, MIN_SCORE)
    got = port_ha.annotate_genome_rows(
        genome, [port_ha.Prototype(*p) for p in protos], K, MIN_SCORE,
        device=CPU)
    assert got == want
    rows, changes, stats = got
    assert stats["defaulted"] > 0 and stats["confirmed"] >= 1
    assert stats["changed"] >= 1 and changes


def _family_case():
    rng = random.Random(9)
    shared = random_protein(rng, 30)
    proteins = [(f"fig|1.1.peg.{i}",
                 random_protein(rng, 10) + shared + random_protein(rng, 10),
                 f"old {i}") for i in range(12)]
    prototypes = [(shared, "family anno"), (proteins[3][1], "exact anno"),
                  (random_protein(rng, 40), "noise anno")]
    return proteins, prototypes


@pytest.mark.parametrize("cap", [2, 32])
def test_owner_cap_overflow_matches_reference(monkeypatch, cap):
    """Kmers with more owners than OWNER_CAP keep their overflow owners in
    the host CSR (the host-float64 route), in both packages."""
    monkeypatch.setattr(ref_ha, "OWNER_CAP", cap)
    monkeypatch.setattr(port_ha, "OWNER_CAP", cap)
    proteins, prototypes = _family_case()
    took = []
    orig = port_ha.GenomeProteinKmers._process_chunk
    monkeypatch.setattr(port_ha.GenomeProteinKmers, "_process_chunk",
                        lambda self, p: (took.append(1), orig(self, p))[1])
    ref, port, got = _both(proteins, prototypes)
    assert got[1] == got[0]
    _assert_same_proposals(ref, port, proteins)
    assert bool(took) == (cap == 2)
    assert (len(port.heavy_owners) > 0) == (cap == 2)
    assert all(port.get_proposal(protein_md5(p))[0] > 0
               for _, p, _ in proteins)


def test_long_protein_takes_the_host_route(monkeypatch):
    """A protein over 16,384 aa leaves the int32 device compare: the
    host-float64 route, equal to the reference's."""
    rng = random.Random(21)
    long_prot = random_protein(rng, 16_390)
    proteins = [("fig|2.1.peg.1", long_prot, "long old"),
                ("fig|2.1.peg.2", long_prot[100:400], "part old"),
                ("fig|2.1.peg.3", random_protein(rng, 200), "other old")]
    prototypes = [(long_prot[50:2000], "long anno"),
                  (long_prot[150:350], "part anno"),
                  (random_protein(rng, 60), "noise anno")]
    took = []
    orig = port_ha.GenomeProteinKmers._process_chunk
    monkeypatch.setattr(port_ha.GenomeProteinKmers, "_process_chunk",
                        lambda self, p: (took.append(1), orig(self, p))[1])
    ref, port, got = _both(proteins, prototypes, chunk=2)
    assert took and got[1] == got[0] > 0
    _assert_same_proposals(ref, port, proteins)


def test_genome_without_usable_proteins():
    """Blank proteins and proteins with '*' are skipped; a genome with no
    usable protein scores nothing and emits its features unchanged."""
    g = make_genome("600.1", seed=3, n_per_role=1)
    for i, f in enumerate(g.features):
        f.raw["protein_translation"] = "" if i % 2 else "MKV*LL"
    protos = [("ACDEFGHIKLMNPQRSTVWY", "anno")]
    want = ref_ha.annotate_genome_rows(
        g, [ref_ha.Prototype(*p) for p in protos], K, MIN_SCORE)
    got = port_ha.annotate_genome_rows(
        g, [port_ha.Prototype(*p) for p in protos], K, MIN_SCORE,
        device=CPU)
    assert got == want
    assert got[2]["proteins"] == 0 and got[2]["matches"] == 0
    assert len(got[0]) == len(g.features)
    gk = port_ha.GenomeProteinKmers(K, MIN_SCORE, device=CPU)
    assert gk.process_proposals([port_ha.Prototype("MKVLLA", "x")]) == 0
    assert gk.n_kmers == 0 and gk.table is None


def _batch_genomes():
    rng = random.Random(11)
    gs = [make_genome("700.1", seed=91, n_per_role=3),
          make_genome("700.2", seed=92, n_per_role=3),
          make_genome("700.3", seed=93, n_per_role=2)]
    shared = random_protein(rng, 120)
    for i, g in enumerate(gs):
        feat = copy.deepcopy(g.features[0])
        feat.raw["id"] = f"fig|{g.id}.peg.9999"
        feat.function = f"distinct old annotation {i}"
        feat.raw["protein_translation"] = shared
        g.features.append(feat)
    protos = [(f.protein_translation, f"proto {i}")
              for i, f in enumerate(gs[0].pegs[:5])]
    protos.append((random_protein(rng, 90), "noise proto"))
    protos.append((shared, "shared proto"))
    return gs, protos


def test_batched_matches_per_genome_and_reference():
    """annotate_genomes_batched equals the reference's, and per-genome
    annotate_genome_rows, shared sequences with different old annotations
    included (the per-genome default map)."""
    gs, protos = _batch_genomes()
    ref_set = ref_ha.PrototypeSet([ref_ha.Prototype(*p) for p in protos], K)
    port_set = port_ha.PrototypeSet([port_ha.Prototype(*p) for p in protos],
                                    K)
    want = ref_ha.annotate_genomes_batched(gs, ref_set, K, MIN_SCORE)
    got = port_ha.annotate_genomes_batched(gs, port_set, K, MIN_SCORE,
                                           device=CPU)
    assert got == want
    single = [port_ha.annotate_genome_rows(g, port_set, K, MIN_SCORE,
                                           device=CPU) for g in gs]
    for (grows, gchanges, gstats), (srows, schanges, sstats) in zip(got,
                                                                    single):
        assert grows == srows and gchanges == schanges
        for key in ("features", "skipped", "proteins", "defaulted",
                    "confirmed", "changed"):
            assert gstats[key] == sstats[key]
    assert len(port_set._cache) == 1        # packed once, reused


def test_rate_logger(caplog):
    rl = port_ha.RateLogger("lines", interval=0.0)
    with caplog.at_level("INFO", logger="kmers_anno_tpu_torch.engine."
                                        "hashanno"):
        rl.add(100)
        rl.add(50)
    assert any("lines/second" in r.getMessage() for r in caplog.records)
    assert rl.n == 150


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli_setup(tmp_path):
    gto_dir = tmp_path / "gtos"
    gto_dir.mkdir()
    genomes = [make_genome(f"80{i}.1", seed=60 + i, n_per_role=2)
               for i in range(4)]
    for g in genomes:
        g.save(str(gto_dir / f"{g.id}.gto"))
    pegs = [f for f in genomes[0].pegs if f.protein_translation]
    anno_file = str(tmp_path / "annos.tbl")
    rng = random.Random(4)
    with open(anno_file, "w") as fh:
        fh.write("protein\tannotation\n")
        fh.write(f"{pegs[0].protein_translation}\t{pegs[0].peg_function}\n")
        fh.write(f"{pegs[1].protein_translation}\tShiny new function\n")
        fh.write(f"{pegs[2].protein_translation[3:]}\tA fragment\n")
        fh.write(f"{random_protein(rng, 8)}\tToo short\n")
        fh.write(f"{random_protein(rng, 60)}\t \n")
    return str(gto_dir), anno_file


def _outputs(out_dir):
    return {name: open(os.path.join(out_dir, name), "rb").read()
            for name in sorted(os.listdir(out_dir))}


@pytest.mark.parametrize("case", ["batch1", "batch3", "missing"])
def test_hash_anno_cli_matches_reference(tmp_path, case):
    gto_dir, anno_file = _cli_setup(tmp_path)
    opts = ["-K", str(K), "--minLen", "10"]
    opts += {"batch1": ["--batch", "1"], "batch3": ["--batch", "3"],
             "missing": []}[case]
    outs = {}
    for name, main, extra in (("ref", ref_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        out_dir = str(tmp_path / name)
        if case == "missing":
            # two genomes already done: only the other two are annotated
            os.makedirs(out_dir)
            for gid in ("800.1", "802.1"):
                with open(os.path.join(out_dir, f"{gid}.anno.tbl"),
                          "w") as fh:
                    fh.write("done before\n")
            opts_ = opts + ["--missing"]
        else:
            opts_ = opts
        assert main(["hashAnno", *opts_, *extra, "-D", out_dir, anno_file,
                     gto_dir]) == 0
        outs[name] = _outputs(out_dir)
    assert outs["port"] == outs["ref"]
    assert len(outs["ref"]) == 5
    changes = outs["ref"]["changes.tbl"].decode()
    if case == "missing":
        assert outs["ref"]["800.1.anno.tbl"] == b"done before\n"
        assert len(changes.splitlines()) == 1
    else:
        assert "Shiny new function" in changes


def test_hash_anno_data_parallel_is_not_yet_ported(tmp_path):
    """``hashAnno --data-parallel 2`` now runs two CPU lanes and writes
    the sequential run's files byte for byte."""
    gto_dir, anno_file = _cli_setup(tmp_path)
    outs = {}
    for dp in ("1", "2"):
        outs[dp] = str(tmp_path / f"out{dp}")
        assert port_main(["hashAnno", "--device", "cpu", "--batch", "1",
                          "--data-parallel", dp, "-D", outs[dp], anno_file,
                          gto_dir]) == 0
    want = _outputs(outs["1"])
    assert len(want) == 5 and _outputs(outs["2"]) == want


def test_hash_anno_default_cuda_without_cuda(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gto_dir, anno_file = _cli_setup(tmp_path)
    out = tmp_path / "out"
    assert port_main(["hashAnno", "-D", str(out), anno_file, gto_dir]) != 0
    assert "CUDA is not available" in capsys.readouterr().err
    assert not out.exists()
