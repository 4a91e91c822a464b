"""The port's DNA mode against the JAX reference on the CPU.

Same seeded inputs through both packages, tolerance 0 everywhere: the
2-bit window packing, validity masks and reverse complement for every k;
``build_signatures(alphabet="dna")`` on both builder backends; text and
``.kdb`` DNA tables written by one package and read by the other;
``DnaContigBatch``; the plain window probe against the reference's jitted
``probe_dna_flat`` on a table whose walks wrap; the clustering (weighted
scores are float64 rounded to 4 places, as in the reference);
``DnaApplyEngine`` on both strands; and ``build --dna`` + ``apply``
through both CLIs, report bytes equal.  The fixtures are those of
``tests/test_dna_mode.py``.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmers_anno_tpu.commands.app import main as ref_main
from kmers_anno_tpu.engine import dna_apply as ref_dna
from kmers_anno_tpu.engine import signature as ref_sig
from kmers_anno_tpu.genome.gto import Genome as RefGenome
from kmers_anno_tpu.ops import dna_kmers as ref_kmers
from kmers_anno_tpu.ops import encode as ref_enc
from kmers_anno_tpu_torch.commands.app import main as port_main
from kmers_anno_tpu_torch.engine import dna_apply as port_dna
from kmers_anno_tpu_torch.engine import signature as port_sig
from kmers_anno_tpu_torch.engine.convert import wide_table_from_numpy
from kmers_anno_tpu_torch.genome.gto import Genome as PortGenome
from kmers_anno_tpu_torch.ops import dna_kmers as port_kmers
from kmers_anno_tpu_torch.ops import encode as port_enc
from kmers_anno_tpu_torch.ops.dna_probe import probe_dna, probe_dna_plain
from kmers_anno_tpu_torch.ops.hashing import mix_kmer_np
from kmers_anno_tpu_torch.ops.hashtable import build_table
from tests.fixtures import ROLE_DEFS, make_role_map, write_role_files

K = 15
CPU = torch.device("cpu")
GOOD = {rid for rid, _ in ROLE_DEFS[:4]}
COMP = str.maketrans("acgt", "tgca")
ALL_K = list(range(port_kmers.DNA_MIN_K, port_kmers.DNA_MAX_K + 1))


def rc(s: str) -> str:
    return s.translate(COMP)[::-1]


def random_dna(rng: random.Random, n: int) -> str:
    return "".join(rng.choice("acgt") for _ in range(n))


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# fixture genomes with real CDS coordinates on one contig (test_dna_mode.py)
# ---------------------------------------------------------------------------

def make_dna_genome(genome_id: str, seed: int,
                    cds_specs: list[tuple[str, int, str]],
                    extra_pegs: list[tuple[str, str]] = ()) -> dict:
    """The raw GTO of a genome whose contig embeds CDS regions with known
    strands: (function, cds_length, strand) specs of random CDS DNA, then
    (function, dna) pairs on '+', each after a 60-bp spacer."""
    rng = random.Random(seed)
    parts, features = [], []
    pos = 1
    n = 0

    def place(function: str, cds: str, strand: str):
        nonlocal pos, n
        spacer = random_dna(rng, 60)
        parts.append(spacer)
        pos += len(spacer)
        left = pos
        right = pos + len(cds) - 1
        parts.append(cds if strand == "+" else rc(cds))
        pos = right + 1
        n += 1
        begin = left if strand == "+" else right
        features.append({
            "id": f"fig|{genome_id}.peg.{n}",
            "type": "CDS",
            "function": function,
            "location": [["con1", str(begin), strand, len(cds)]],
            "protein_translation": "M" * 10,
            "annotations": [], "aliases": [],
        })

    for function, length, strand in cds_specs:
        place(function, random_dna(rng, length), strand)
    for function, dna in extra_pegs:
        place(function, dna, "+")
    parts.append(random_dna(rng, 60))
    return {
        "id": genome_id, "scientific_name": f"Dna testus {genome_id}",
        "genetic_code": 11, "domain": "Bacteria",
        "features": features,
        "contigs": [{"id": "con1", "dna": "".join(parts),
                     "genetic_code": 11}],
        "close_genomes": [], "subsystems": [],
    }


def train_specs(i: int) -> list[tuple[str, int, str]]:
    return [(name, 300 + 30 * j, "+" if (i + j) % 2 else "-")
            for j, (rid, name) in enumerate(ROLE_DEFS[:4])]


@pytest.fixture(scope="module")
def train_raw():
    rng = random.Random(4242)
    shared = random_dna(rng, 40)   # embedded under two roles: pruned
    killed = random_dna(rng, 40)   # embedded in an uninteresting peg too
    out = []
    for i in range(2):
        extra = []
        if i == 0:
            extra = [
                (ROLE_DEFS[0][1], random_dna(rng, 60) + shared),
                (ROLE_DEFS[1][1], shared + random_dna(rng, 60)),
                (ROLE_DEFS[2][1], killed + random_dna(rng, 60)),
                (ROLE_DEFS[4][1], random_dna(rng, 30) + killed),  # kill peg
            ]
        out.append(make_dna_genome(f"77{i}.1", seed=100 + i,
                                   cds_specs=train_specs(i),
                                   extra_pegs=extra))
    return out


def target_raw() -> dict:
    """A genome whose contig holds two training CDS, one on each strand,
    among fresh spacers, a run of ambiguous bases and a short second
    contig (test_dna_mode.py's strand-aware target)."""
    rng = random.Random(31337)
    tg = make_dna_genome(
        "880.1", seed=555,
        cds_specs=[(ROLE_DEFS[0][1], 330, "+"), (ROLE_DEFS[1][1], 300, "-")])
    train = RefGenome(make_dna_genome("771.1", seed=101,
                                      cds_specs=train_specs(1)))
    cds0 = train.get_dna(train.pegs[0].location)
    cds1 = train.get_dna(train.pegs[1].location)
    cds2 = train.get_dna(train.pegs[2].location)
    seq = (random_dna(rng, 80) + cds0 + random_dna(rng, 80)
           + rc(cds1) + random_dna(rng, 80) + cds2[:150] + "nnrn"
           + cds2[150:] + random_dna(rng, 30))
    tg["contigs"][0]["dna"] = seq
    tg["contigs"].append({"id": "con2", "dna": cds0[:9], "genetic_code": 11})
    return tg


def _build(package, raws, weight_mode="none", backend=None):
    if package == "ref":
        return ref_sig.build_signatures(
            [RefGenome(r) for r in raws], make_role_map(), GOOD, k=K,
            progress=False, alphabet="dna", weight_mode=weight_mode)
    return port_sig.build_signatures(
        [PortGenome(r) for r in raws], make_role_map(), GOOD, k=K,
        progress=False, alphabet="dna", weight_mode=weight_mode,
        backend=backend or "auto", device=CPU)


@pytest.fixture(scope="module")
def ref_built(train_raw):
    return _build("ref", train_raw)


@pytest.fixture(scope="module")
def ref_built_balance(train_raw):
    return _build("ref", train_raw, "balance")


# ---------------------------------------------------------------------------
# packing, validity, reverse complement
# ---------------------------------------------------------------------------

def _codes(seed: int, n: int, ambiguous: float = 0.05) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < ambiguous] = ref_enc.DNA_AMBIG
    codes[-3:] = port_enc.DNA_PAD
    return codes


@pytest.mark.parametrize("k", ALL_K)
def test_pack_and_unpack_match_reference(k):
    codes = _codes(k, 301)
    got = port_kmers.pack_dna_np(codes, k)
    want = ref_kmers.pack_dna_np(codes, k)
    for g, w in zip(got, want):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(port_kmers.unpack_dna_np(*got, k),
                                  ref_kmers.unpack_dna_np(*want, k))
    assert (got[0] >> 31 == 0).all() and (got[1] == 0).all()
    batch = np.stack([codes, codes[::-1].copy()])
    dlo, dhi = port_kmers.pack_dna_windows(torch.from_numpy(batch), k)
    wlo, whi = ref_kmers.pack_dna_windows(jnp.asarray(batch), k)
    assert dlo.dtype == torch.int32 and (dlo >= 0).all()
    np.testing.assert_array_equal(u32(dlo), np.asarray(wlo))
    np.testing.assert_array_equal(u32(dhi), np.asarray(whi))
    assert len(port_kmers.pack_dna_np(codes[: k - 1], k)[0]) == 0


@pytest.mark.parametrize("k", ALL_K)
def test_valid_masks_and_reverse_complement_match_reference(k):
    codes = _codes(100 + k, 257)
    np.testing.assert_array_equal(port_kmers.dna_valid_np(codes, k),
                                  ref_kmers.dna_valid_np(codes, k))
    batch = np.stack([codes, _codes(200 + k, 257, 0.0), codes[::-1].copy()])
    lengths = np.array([257, 200, k - 1], np.int32)
    got = port_kmers.dna_valid_mask(torch.from_numpy(batch),
                                    torch.from_numpy(lengths), k)
    want = ref_kmers.dna_valid_mask(jnp.asarray(batch), jnp.asarray(lengths),
                                    k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[2].any()
    # no drop-last: the last full window of an unambiguous row counts
    assert got[1, 200 - k]
    np.testing.assert_array_equal(
        port_kmers.reverse_complement_device(torch.from_numpy(batch)).numpy(),
        np.asarray(ref_kmers.reverse_complement_device(jnp.asarray(batch))))


@pytest.mark.parametrize("k", [3, 16])
def test_k_out_of_range_raises(k):
    with pytest.raises(ValueError, match="outside supported range"):
        port_kmers.pack_dna_np(_codes(0, 40), k)
    with pytest.raises(ValueError, match="outside supported range"):
        port_kmers.pack_dna_windows(torch.from_numpy(_codes(0, 40)), k)


def test_codecs_match_reference():
    codes = np.random.default_rng(3).integers(0, 6, 500).astype(np.uint8)
    assert port_enc.decode_dna(codes) == ref_enc.decode_dna(codes)
    assert port_enc.DNA_PAD == ref_enc.DNA_PAD


# ---------------------------------------------------------------------------
# build --dna and the table files
# ---------------------------------------------------------------------------

def _assert_tables_equal(got, want):
    for name in ("key_lo", "key_hi", "role_idx"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert got.role_ids == list(want.role_ids)
    assert got.k == want.k and got.alphabet == want.alphabet == "dna"
    if want.weights is None:
        assert got.weights is None
    else:
        np.testing.assert_array_equal(got.weights, want.weights)


@pytest.mark.parametrize("backend", ["auto", "device"])
def test_build_matches_reference(backend, train_raw, ref_built):
    got = _build("port", train_raw, backend=backend)
    _assert_tables_equal(got, ref_built)
    assert got.stats == ref_built.stats
    assert got.stats["pruned"] > 0 and got.stats["killed"] > 0
    assert got.kmer_texts() == ref_built.kmer_texts()
    assert len(got) > 500


def test_build_with_weights_matches_reference(train_raw, ref_built_balance):
    got = _build("port", train_raw, "balance")
    _assert_tables_equal(got, ref_built_balance)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("suffix", [".tbl", ".kdb"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_table_files_cross_read(writer, suffix, weighted, ref_built,
                                ref_built_balance, tmp_path):
    want = ref_built_balance if weighted else ref_built
    table = (want if writer == "ref"
             else port_sig.SignatureTable(
                 k=want.k, key_lo=want.key_lo, key_hi=want.key_hi,
                 role_idx=want.role_idx, role_ids=list(want.role_ids),
                 alphabet="dna", weights=want.weights))
    path = str(tmp_path / f"dna{suffix}")
    table.save(path)
    got = port_sig.SignatureTable.load(path)
    _assert_tables_equal(got, ref_sig.SignatureTable.load(path))
    assert got.kmer_texts() == want.kmer_texts()
    assert ([got.role_ids[r] for r in got.role_idx]
            == [want.role_ids[r] for r in want.role_idx])
    if suffix == ".kdb":
        _assert_tables_equal(got, want)
    again = str(tmp_path / f"again{suffix}")
    got.save(again)
    assert open(again, "rb").read() == open(path, "rb").read()


def test_text_tables_written_byte_for_byte(ref_built, tmp_path):
    port_table = port_sig.SignatureTable.load(
        _saved(ref_built, tmp_path / "ref.tbl"))
    got = tmp_path / "port.tbl"
    port_table.save(str(got))
    assert got.read_bytes() == (tmp_path / "ref.tbl").read_bytes()
    assert got.read_text().split("\t")[0].islower()


def _saved(table, path) -> str:
    table.save(str(path))
    return str(path)


def test_upper_case_dna_is_detected(ref_built, tmp_path):
    lines = [f"{t.upper()}\t{ref_built.role_ids[r]}"
             for t, r in zip(ref_built.kmer_texts()[:300],
                             ref_built.role_idx[:300])]
    path = tmp_path / "upper.tbl"
    path.write_text("\n".join(lines) + "\n")
    got = port_sig.SignatureTable.load(str(path))
    want = ref_sig.SignatureTable.load(str(path))
    assert got.alphabet == want.alphabet == "dna"
    _assert_tables_equal(got, want)
    assert got.kmer_texts() == ref_built.kmer_texts()[:300]


def test_ambiguous_base_in_a_dna_kmer_raises(tmp_path):
    path = tmp_path / "bad.tbl"
    path.write_text("acgtacgtacgtacg\tRoleA\nacgtacgtacgtacg\tRoleB\n")
    assert port_sig.SignatureTable.load(str(path)).alphabet == "dna"
    path.write_text("acgtacgtacgtacg\tRoleA\nacgtacgnacgtacg\tRoleB\n")
    # the n makes auto-detection call the table protein, too long a kmer
    for mod in (ref_sig, port_sig):
        with pytest.raises(ValueError, match="ambiguous base.*acgtacgn"):
            mod.SignatureTable.load(str(path), alphabet="dna")
        with pytest.raises(ValueError, match="k <= 12"):
            mod.SignatureTable.load(str(path))


# ---------------------------------------------------------------------------
# the contig stream and the window probe
# ---------------------------------------------------------------------------

CONTIGS = [("c1", "acgtnacgta" * 7 + "ggtacc"), ("short", "acgtac"),
           ("c3", "ttgacca" * 5), ("empty", "")]


@pytest.mark.parametrize("k", [4, 9, 15])
def test_contig_batch_matches_reference(k):
    contigs = CONTIGS + [("rnd", random_dna(random.Random(k), 333))]
    got = port_dna.DnaContigBatch(contigs, k, min_tokens=64)
    want = ref_dna.DnaContigBatch(contigs, k, min_tokens=64)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.valid, want.valid)
    assert got.entries == want.entries
    assert len(got.codes) == 1024 and (got.codes[-1] == port_enc.DNA_PAD)
    # a window that runs from one entry into the next is invalid
    for _, _, off, n in got.entries:
        assert not got.valid[max(off + n - k + 1, off): off + n].any()


def wrap_table(k: int, seed: int, weighted: bool):
    """An 8-slot table of 100 of a random sequence's k-mers, at least 32 of
    them homed in the last two of 16 buckets, so walks wrap to bucket 0;
    payloads are roles, or fp16 weights over roles.  Returns (the uint32
    table, max_probes, the sequence)."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, 4000).astype(np.uint8)
    key = np.unique(port_kmers.pack_dna_np(seq, k)[0])
    last = (mix_kmer_np(key, np.zeros_like(key)) & 15) >= 14
    key = np.concatenate([key[last][:40], key[~last][:60]])
    vals = (np.arange(len(key)) % 37).astype(np.uint32)
    if weighted:
        w = rng.uniform(0.05, 3.0, len(key)).astype(np.float16)
        vals |= w.view(np.uint16).astype(np.uint32) << np.uint32(16)
    table, mp = build_table(key, np.zeros_like(key), vals, n_buckets=16)
    assert mp >= 3
    return table, mp, seq


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k", [4, 8, 11, 15])
def test_probe_plain_matches_reference(k, weighted):
    table, mp, seq = wrap_table(k, k, weighted)
    text = port_enc.decode_dna(seq)
    contigs = [("a", text[:1500]), ("b", text[1500:1500 + k - 1]),
               ("c", text[1600:2600].replace("c", "n", 3)),
               ("d", text[2600:2600 + k])]
    batch = port_dna.DnaContigBatch(contigs, k, min_tokens=1 << 12)
    want = np.asarray(ref_dna.probe_dna_flat(
        jnp.asarray(table), jnp.asarray(batch.codes),
        jnp.asarray(batch.valid), k=k, max_probes=mp))
    t = wide_table_from_numpy(table, CPU)
    codes, valid = torch.from_numpy(batch.codes), torch.from_numpy(
        batch.valid)
    got = probe_dna_plain(t, codes, valid, k=k, max_probes=mp)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version on the CPU, uncounted
    before = probe_dna.launches
    assert torch.equal(probe_dna(t, codes, valid, k=k, max_probes=mp), got)
    assert probe_dna.launches == before
    assert (got[~valid] == -1).all()
    hits = int((got >= 0).sum())
    assert hits > 50
    assert port_dna.probe_dna_flat is probe_dna


def test_probe_rejects_bad_arguments():
    table, mp, _ = wrap_table(8, 1, False)
    t = wide_table_from_numpy(table, CPU)
    codes = torch.zeros(64, dtype=torch.uint8)
    valid = torch.ones(64, dtype=torch.bool)
    with pytest.raises(ValueError, match="valid"):
        probe_dna(t, codes, valid[:10], k=8, max_probes=mp)
    with pytest.raises(ValueError, match="uint8"):
        probe_dna(t, codes.to(torch.int32), valid, k=8, max_probes=mp)
    with pytest.raises(ValueError, match="outside supported range"):
        probe_dna(t, codes, valid, k=16, max_probes=mp)
    with pytest.raises(ValueError, match="power of two"):
        probe_dna(t[:12], codes, valid, k=8, max_probes=mp)


# ---------------------------------------------------------------------------
# clustering
# ---------------------------------------------------------------------------

def test_cluster_hits_gap_and_role_splits():
    roles = np.full(100, -1, np.int32)
    roles[[3, 5, 9]] = 2
    roles[[11, 12]] = 7
    roles[[40, 44]] = 7
    got = port_dna.cluster_hits(roles, k=15, max_gap=20, min_hits=2)
    assert got == ref_dna.cluster_hits(roles, k=15, max_gap=20, min_hits=2)
    assert got == [(3, 9, 2, 3), (11, 12, 7, 2), (40, 44, 7, 2)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_hits_matches_reference(seed):
    rng = np.random.default_rng(seed)
    roles = np.where(rng.random(5000) < 0.05, rng.integers(0, 3, 5000), -1)
    roles = roles.astype(np.int32)
    w = rng.uniform(0.0, 2.5, 5000).astype(np.float16).astype(np.float32)
    for gap, hits, min_w in ((30, 2, 0.5), (200, 5, 3.3), (1, 1, 0.0)):
        assert (port_dna.cluster_hits(roles, 15, gap, hits)
                == ref_dna.cluster_hits(roles, 15, gap, hits))
        got = port_dna.cluster_hits(roles, 15, gap, hits, weights=w,
                                    min_weight=min_w)
        assert got == ref_dna.cluster_hits(roles, 15, gap, hits, weights=w,
                                           min_weight=min_w)
        assert got and all(isinstance(c[3], float) for c in got)
    assert port_dna.cluster_hits(np.full(9, -1, np.int32), 15, 5, 1) == []


def test_split_payload_matches_reference():
    rng = np.random.default_rng(4)
    w = rng.uniform(0, 100, 1000).astype(np.float16)
    vals = ((w.view(np.uint16).astype(np.int64) << 16)
            | rng.integers(0, 60000, 1000)).astype(np.int32)
    vals[::7] = -1
    for g, x in zip(port_dna.split_payload_np(vals),
                    ref_dna.split_payload_np(vals)):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)


def _calls(calls):
    return [(f.id, f.type, f.location.contig_id, f.location.strand,
             f.location.left, f.location.right, role, score)
            for f, role, score in calls]


@pytest.mark.parametrize("weighted", [False, True])
def test_cluster_calls_matches_reference(weighted, ref_built):
    rng = np.random.default_rng(9)
    seq = rng.integers(0, 4, 4000).astype(np.uint8)
    lo = port_kmers.pack_dna_np(seq, 15)[0]
    # runs of windows share a role: hits cluster, and role changes split
    key, first = np.unique(lo[::3], return_index=True)
    vals = ((3 * first // 150) % 37).astype(np.uint32)
    if weighted:
        w = rng.uniform(0.05, 3.0, len(key)).astype(np.float16)
        vals |= w.view(np.uint16).astype(np.uint32) << np.uint32(16)
    table, mp = build_table(key, np.zeros_like(key), vals)
    text = port_enc.decode_dna(seq)
    raw = target_raw()
    raw["contigs"][0]["dna"] = text[:2000] + rc(text[2000:])
    batch = ref_dna.DnaContigBatch(
        [(c["id"], c["dna"]) for c in raw["contigs"]], 15)
    vals = np.asarray(ref_dna.probe_dna_flat(
        jnp.asarray(table), jnp.asarray(batch.codes),
        jnp.asarray(batch.valid), k=15, max_probes=mp))
    role_ids = [f"R{i}" for i in range(37)]
    args = (vals, 15, 40, 3, role_ids)
    got = port_dna.cluster_calls(PortGenome(raw), batch, *args,
                                 weighted=weighted, min_weight=2.0)
    want = ref_dna.cluster_calls(RefGenome(raw), batch, *args,
                                 weighted=weighted, min_weight=2.0)
    assert _calls(got) == _calls(want)
    assert {c[3] for c in _calls(got)} == {"+", "-"}


# ---------------------------------------------------------------------------
# the engine and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_engine_matches_reference(weighted, ref_built, ref_built_balance):
    table = ref_built_balance if weighted else ref_built
    raw = target_raw()
    got = port_dna.DnaApplyEngine(
        _port_copy(table), min_hits=5, max_gap=200, weighted=weighted,
        min_weight=1.5, device=CPU).call_genome(PortGenome(raw))
    want = ref_dna.DnaApplyEngine(
        table, min_hits=5, max_gap=200, weighted=weighted,
        min_weight=1.5).call_genome(RefGenome(raw))
    assert _calls(got) == _calls(want)
    strands = {(c[6], c[3]) for c in _calls(got)}
    assert (ROLE_DEFS[0][0], "+") in strands
    assert (ROLE_DEFS[1][0], "-") in strands


def _port_copy(table):
    return port_sig.SignatureTable(
        k=table.k, key_lo=table.key_lo, key_hi=table.key_hi,
        role_idx=table.role_idx, role_ids=list(table.role_ids),
        alphabet=table.alphabet, weights=table.weights)


def test_engine_requires_a_dna_table():
    prot = port_sig.SignatureTable(
        k=8, key_lo=np.zeros(1, np.uint32), key_hi=np.zeros(1, np.uint32),
        role_idx=np.zeros(1, np.int32), role_ids=["R"])
    with pytest.raises(ValueError, match="DNA signature table"):
        port_dna.DnaApplyEngine(prot, device=CPU)


@pytest.fixture(scope="module")
def cli_files(train_raw, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dna_cli")
    train = tmp / "train"
    train.mkdir()
    for raw in train_raw:
        RefGenome(raw).save(str(train / f"{raw['id']}.gto"))
    target = tmp / "target"
    target.mkdir()
    RefGenome(target_raw()).save(str(target / "880.1.gto"))
    for raw in train_raw[:1]:
        RefGenome(raw).save(str(target / f"{raw['id']}.gto"))
    role_file, use_file = write_role_files(tmp)
    return tmp, str(train), str(target), role_file, use_file


@pytest.mark.parametrize("weights", ["none", "balance"])
def test_cli_build_dna_matches_reference(weights, cli_files):
    tmp, train, _, role_file, use_file = cli_files
    out = {}
    for name, main, extra in (("ref", ref_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        out[name] = str(tmp / f"{name}.{weights}.tbl")
        assert main(["build", "--dna", "--weights", weights, *extra,
                     "-o", out[name], role_file, use_file, train]) == 0
    got = open(out["port"], "rb").read()
    assert got == open(out["ref"], "rb").read()
    assert got.split(b"\t")[0].islower() and len(got.split(b"\t")[0]) == K


@pytest.mark.parametrize("fmt,weighted", [("VERIFY", False),
                                          ("APPLY", False),
                                          ("VERIFY", True)])
def test_cli_apply_dna_report_bytes_match_reference(fmt, weighted,
                                                    cli_files):
    tmp, train, target, role_file, use_file = cli_files
    weights = "balance" if weighted else "none"
    db = str(tmp / f"db.{weights}.tbl")
    assert ref_main(["build", "--dna", "--weights", weights, "-o", db,
                     role_file, use_file, train]) == 0
    extra = ["--weighted", "--min-weight", "2.5"] if weighted else []
    out = {}
    for name, main, dev in (("ref", ref_main, []),
                            ("port", port_main, ["--device", "cpu"])):
        out[name] = str(tmp / f"{name}.{fmt}.{weights}.out")
        assert main(["apply", "--format", fmt, "-m", "5", "--max-gap",
                     "200", *extra, *dev, "-o", out[name], db, use_file,
                     target]) == 0
    got = open(out["port"], "rb").read()
    assert got == open(out["ref"], "rb").read()
    if fmt == "VERIFY":
        assert got.count(b".region.") >= 4


def test_cli_build_dna_kmer_range(cli_files, capsys):
    tmp, train, _, role_file, use_file = cli_files
    for k in ("3", "16"):
        assert port_main(["build", "--dna", "-K", k, "--device", "cpu",
                          role_file, use_file, train]) != 0
        assert "dna range 4..15" in capsys.readouterr().err
    out = str(tmp / "k12.tbl")
    assert port_main(["build", "--dna", "-K", "12", "--device", "cpu",
                      "-o", out, role_file, use_file, train]) == 0
    assert len(open(out).readline().split("\t")[0]) == 12


def _tiny_db(tmp) -> str:
    db = tmp / "tiny.tbl"
    db.write_text("acgtacgtacgtacg\tPhenTrnaSyntAlph\n")
    return str(db)


@pytest.mark.parametrize("command", ["build", "apply"])
def test_dna_cli_defaults_to_cuda(monkeypatch, cli_files, capsys, command):
    tmp, train, target, role_file, use_file = cli_files
    db = _tiny_db(tmp)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp / f"cuda.{command}"
    args = (["build", "--dna", "-o", str(out), role_file, use_file, train]
            if command == "build"
            else ["apply", "-o", str(out), db, use_file, target])
    assert port_main(args) != 0
    assert "CUDA is not available" in capsys.readouterr().err
    assert not out.exists()


def test_apply_mesh_on_a_dna_table_still_raises(cli_files):
    """``apply --mesh`` on a DNA table now runs the DNA mesh (replicated
    and table-sharded, virtual CPU members) and writes the single-device
    report byte for byte."""
    tmp, train, target, role_file, use_file = cli_files
    db = str(tmp / "db.mesh.tbl")
    assert port_main(["build", "--dna", "--device", "cpu", "-o", db,
                      role_file, use_file, train]) == 0
    out = {}
    for mesh in ([], ["--mesh", "2x1"], ["--mesh", "1x2"]):
        out[tuple(mesh)] = str(tmp / f"mesh{len(out)}.out")
        assert port_main(["apply", "--format", "VERIFY", "-m", "5",
                          "--device", "cpu", *mesh, "-o", out[tuple(mesh)],
                          db, use_file, target]) == 0
    want = open(out[()], "rb").read()
    assert want.count(b".region.") >= 4
    assert all(open(p, "rb").read() == want for p in out.values())
