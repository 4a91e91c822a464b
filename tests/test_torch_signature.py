"""The port's signature build against the JAX reference on the CPU.

Kmer packing and validity masks, ``fits_wide``, the three torch group-bys
against the reference's jitted ones, ``build_signatures`` on both builder
backends against the reference's and ``oracle.oracle_build``, the TSV and
binary files byte for byte, and the fp16 payload clamp.  Every comparison
is exact.
"""

import io
import random
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmers_anno_tpu.engine import signature as ref
from kmers_anno_tpu.ops import kmers as ref_kmers
from kmers_anno_tpu.ops import widetable as ref_wt
from kmers_anno_tpu.ops.encode import PROT_PAD, encode_protein
from kmers_anno_tpu.ops.hashtable import build_table as ref_build_table
from kmers_anno_tpu_torch.engine import signature as port
from kmers_anno_tpu_torch.engine.convert import (
    signature_table_from_reference, wide_table_from_numpy)
from kmers_anno_tpu_torch.ops import kmers as port_kmers
from kmers_anno_tpu_torch.ops import widetable as port_wt
from tests.fixtures import (ROLE_DEFS, make_genome, make_role_map,
                            random_protein)
from tests.oracle import oracle_build, protein_kmers
from test_torch_host import reference_native

GOOD = {rid for rid, _ in ROLE_DEFS[:4]}
K = 8
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def genomes():
    shared = random_protein(random.Random(999), 70)
    return [make_genome(f"100{i}.1", seed=i,
                        shared_protein=shared if i == 0 else None)
            for i in range(3)]


@pytest.fixture(scope="module")
def ref_table(genomes):
    return ref.build_signatures(genomes, make_role_map(), GOOD, k=K,
                                progress=False)


# ---------------------------------------------------------------------------
# kmer ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 8, 12])
def test_pack_unpack_round_trip(k):
    prot = "MKVLAWYCDEFGHINPQRSTX*"
    codes = encode_protein(prot)
    lo, hi = port_kmers.pack_kmers_np(codes, k)
    rlo, rhi = ref.pack_kmers_np(codes, k)
    np.testing.assert_array_equal(lo, rlo)
    np.testing.assert_array_equal(hi, rhi)
    back = port_kmers.unpack_kmer_np(lo, hi, k)
    np.testing.assert_array_equal(back, ref.unpack_kmer_np(rlo, rhi, k))
    from kmers_anno_tpu_torch.ops.encode import decode_protein
    assert [decode_protein(r) for r in back] == protein_kmers(prot, k)


@pytest.mark.parametrize("reject_stop", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_kmer_valid_mask_matches_reference(reject_stop, drop_last):
    """X, '*' and PROT_PAD padding at several places of a batch."""
    prots = ["MKVLAWXYCDEFGHIKL", "MKV*LAWYCDEFGH", "ACDEFGHIK",
             "MK", "ACDEFGHIKLMNPQRSTVWY"]
    width = 24
    codes = np.full((len(prots), width), PROT_PAD, np.uint8)
    for i, p in enumerate(prots):
        codes[i, :len(p)] = encode_protein(p)
    lengths = np.array([len(p) for p in prots], np.int32)
    want = ref_kmers.kmer_valid_mask(jnp.asarray(codes),
                                     jnp.asarray(lengths), K, reject_stop,
                                     drop_last)
    got = port_kmers.kmer_valid_mask(torch.from_numpy(codes),
                                     torch.from_numpy(lengths), K,
                                     reject_stop, drop_last)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


@pytest.mark.parametrize("n", [0, 1, 1000, 2_097_152, 3_145_728,
                               3_145_729, 10_000_000])
def test_fits_wide_matches_reference(n):
    assert port_wt.fits_wide(n) == ref_wt.fits_wide(n)


# ---------------------------------------------------------------------------
# the group-bys
# ---------------------------------------------------------------------------

def _occurrences(seed, n=3000, n_keys=700, n_roles=9):
    """Keys drawn with repeats (so keys conflict or agree), roles with a
    few CONFLICT tombstones, as a merge round feeds them."""
    rng = np.random.default_rng(seed)
    pool_lo = rng.integers(0, 1 << 30, n_keys).astype(np.uint32)
    pool_hi = rng.integers(0, 1 << 30, n_keys).astype(np.uint32)
    pool_hi[: n_keys // 4] = pool_hi[0]         # many keys share a hi word
    pick = rng.integers(0, n_keys, n)
    role = rng.integers(0, n_roles, n).astype(np.int32)
    role[pick % 3 == 0] = pick[pick % 3 == 0] % n_roles   # some unanimous
    role[rng.random(n) < 0.02] = ref.CONFLICT
    return pool_lo[pick], pool_hi[pick], role


def _i64(a):
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_resolve_groupby_matches_reference(seed):
    lo, hi, role = _occurrences(seed)
    wlo, whi, wrole, wkeep = (np.asarray(a) for a in ref._resolve_groupby(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(role)))
    glo, ghi, grole, gkeep = port._resolve_groupby(
        _i64(lo), _i64(hi), torch.from_numpy(role))
    np.testing.assert_array_equal(gkeep.numpy(), wkeep)
    np.testing.assert_array_equal(glo.numpy(), wlo.astype(np.int64))
    np.testing.assert_array_equal(ghi.numpy(), whi.astype(np.int64))
    np.testing.assert_array_equal(grole.numpy(), wrole)
    assert (wrole[wkeep] == ref.CONFLICT).any()
    assert (wrole[wkeep] != ref.CONFLICT).any()


def test_dedup_groupby_matches_reference():
    lo, hi, _ = _occurrences(2)
    wlo, whi, wkeep = (np.asarray(a) for a in ref._dedup_groupby(
        jnp.asarray(lo), jnp.asarray(hi)))
    glo, ghi, gkeep = port._dedup_groupby(_i64(lo), _i64(hi))
    np.testing.assert_array_equal(gkeep.numpy(), wkeep)
    np.testing.assert_array_equal(glo.numpy(), wlo.astype(np.int64))
    np.testing.assert_array_equal(ghi.numpy(), whi.astype(np.int64))


@pytest.mark.parametrize("n_buckets", [None, 64])
def test_mark_killed_matches_reference(n_buckets):
    """Kill keys half in the candidate set, half not; the second case
    overfills buckets so probes walk."""
    rng = np.random.default_rng(3)
    key = rng.permutation(np.unique(rng.integers(0, 1 << 60, 900,
                                                 dtype=np.int64)))
    lo = (key & ((1 << 30) - 1)).astype(np.uint32)
    hi = (key >> 30).astype(np.uint32)
    n_cand = 400
    table, mp = ref_build_table(lo[:n_cand], hi[:n_cand],
                                np.arange(n_cand, dtype=np.uint32),
                                n_buckets=n_buckets)
    kill = rng.permutation(np.arange(150, 650))
    want = np.asarray(ref._mark_killed(
        jnp.asarray(table), jnp.asarray(lo[kill]), jnp.asarray(hi[kill]),
        n_cand, mp))
    got = port._mark_killed(
        wide_table_from_numpy(table, CPU),
        torch.from_numpy(lo[kill].view(np.int32)),
        torch.from_numpy(hi[kill].view(np.int32)), n_cand, mp)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() == 250
    if n_buckets:
        assert mp > 1


def _stream(seed):
    rng = np.random.default_rng(seed)
    chunks = []
    for _ in range(4):
        n = 3000
        chunks.append((rng.integers(0, 1 << 30, n).astype(np.uint32),
                       rng.integers(0, 1 << 12, n).astype(np.uint32),
                       rng.integers(0, 40, n).astype(np.int32)))
    lo0, hi0, r0 = chunks[0]
    chunks.append((lo0[:500], hi0[:500], (r0[:500] + 1) % 40))   # conflicts
    chunks.append((lo0[500:900], hi0[500:900], r0[500:900]))     # agree
    kills = [(lo0[900:1100], hi0[900:1100]),
             (chunks[1][0][:60], chunks[1][1][:60])]
    return chunks, kills


@pytest.mark.parametrize("backend", ["auto", "device"])
def test_streaming_builder_matches_reference(backend):
    """Several flushes (chunk 2048) against the reference's native
    builder: keys, roles and stats."""
    chunks, kills = _stream(7)
    reference_native()      # the reference's library, past a build race
    outs = []
    for b in (ref.StreamingTableBuilder(backend="native"),
              port.StreamingTableBuilder(chunk_entries=2048,
                                         backend=backend, device=CPU)):
        for lo, hi, role in chunks:
            b.add_candidates(lo, hi, role)
        for lo, hi in kills:
            b.add_kills(lo, hi)
        outs.append(b.finish())
    (wlo, whi, wrole, wstats), (glo, ghi, grole, gstats) = outs
    np.testing.assert_array_equal(glo, wlo)
    np.testing.assert_array_equal(ghi, whi)
    np.testing.assert_array_equal(grole, wrole)
    assert gstats == wstats
    assert gstats["pruned"] > 0 and gstats["killed"] > 0


def test_builder_rejects_wide_keys():
    b = port.StreamingTableBuilder(backend="device", device=CPU)
    with pytest.raises(ValueError):
        b.add_candidates(np.zeros(1, np.uint32),
                         np.full(1, 1 << 31, np.uint32),
                         np.zeros(1, np.int32))


# ---------------------------------------------------------------------------
# build_signatures and the table files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["auto", "device"])
def test_build_matches_reference_and_oracle(genomes, ref_table, backend):
    got = port.build_signatures(genomes, make_role_map(), GOOD, k=K,
                                progress=False, backend=backend, device=CPU)
    np.testing.assert_array_equal(got.key_lo, ref_table.key_lo)
    np.testing.assert_array_equal(got.key_hi, ref_table.key_hi)
    np.testing.assert_array_equal(got.role_idx, ref_table.role_idx)
    assert got.role_ids == ref_table.role_ids
    assert got.stats == ref_table.stats
    assert got.stats["pruned"] > 0 and got.stats["killed"] > 0
    texts = got.kmer_texts()
    assert texts == ref_table.kmer_texts()
    assert dict(zip(texts, (got.role_ids[r] for r in got.role_idx))) == \
        oracle_build(genomes, make_role_map(), GOOD, k=K)
    # sorted by the packed key (hi, then lo)
    key = got.key_hi.astype(np.int64) << 32 | got.key_lo.astype(np.int64)
    assert (np.diff(key) > 0).all()
    assert got.role_counts().counts() == ref_table.role_counts().counts()


@pytest.mark.parametrize("mode", ["none", "uniform", "balance"])
def test_compute_weights_matches_reference(mode):
    ridx = np.array([0, 0, 0, 1, 3, 3], np.int32)
    want = ref.compute_weights(ridx, mode)
    got = port.compute_weights(ridx, mode)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["none", "balance"])
def test_tsv_save_load_byte_identical(genomes, tmp_path, mode):
    want = ref.build_signatures(genomes, make_role_map(), GOOD, k=K,
                                progress=False, weight_mode=mode)
    got = port.build_signatures(genomes, make_role_map(), GOOD, k=K,
                                progress=False, weight_mode=mode,
                                device=CPU)
    ref_path, port_path = tmp_path / "ref.tbl", tmp_path / "port.tbl"
    want.save(str(ref_path))
    got.save(str(port_path))
    assert port_path.read_bytes() == ref_path.read_bytes()
    buf = io.StringIO()
    got.save(buf)
    assert buf.getvalue().encode() == ref_path.read_bytes()
    back = port.SignatureTable.load(str(ref_path))
    ref_back = ref.SignatureTable.load(str(ref_path))
    for name in ("key_lo", "key_hi", "role_idx"):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(ref_back, name))
    assert back.role_ids == ref_back.role_ids and back.k == K
    if mode == "none":
        assert back.weights is None
    else:
        np.testing.assert_array_equal(back.weights, ref_back.weights)


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


@pytest.mark.parametrize("mode,suffix", [("none", ".kdb"),
                                         ("balance", ".npz")])
def test_binary_save_load_identical(ref_table, genomes, tmp_path, mode,
                                    suffix):
    """The npz members are byte-equal (the zip headers carry the time of
    writing, so the files themselves are compared member by member)."""
    want = ref.build_signatures(genomes, make_role_map(), GOOD, k=K,
                                progress=False, weight_mode=mode)
    got = signature_table_from_reference(want)
    ref_path = str(tmp_path / f"ref{suffix}")
    port_path = str(tmp_path / f"port{suffix}")
    want.save(ref_path)
    got.save(port_path)
    assert _members(port_path) == _members(ref_path)
    back = port.SignatureTable.load(ref_path)
    for name in ("key_lo", "key_hi", "role_idx", "weights"):
        a, b = getattr(back, name), getattr(want, name)
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    assert back.role_ids == want.role_ids and back.k == want.k


def test_payloads_with_fp16_clamp(ref_table):
    w = np.linspace(0.0, 2.0, len(ref_table)).astype(np.float32)
    w[:3] = [70000.0, 1e9, 65504.0]             # past the fp16 maximum
    want = ref.SignatureTable(k=K, key_lo=ref_table.key_lo,
                              key_hi=ref_table.key_hi,
                              role_idx=ref_table.role_idx,
                              role_ids=ref_table.role_ids, weights=w)
    got = signature_table_from_reference(want)
    for packed in (False, True):
        np.testing.assert_array_equal(got._payloads(packed),
                                      want._payloads(packed))
    bits = got._payloads(True) >> np.uint32(16)
    assert (bits[:3] == np.float16(65504.0).view(np.uint16)).all()
    unweighted = signature_table_from_reference(ref_table)
    np.testing.assert_array_equal(unweighted._payloads(True),
                                  ref_table._payloads(True))


def test_device_wide_table_matches_reference(ref_table):
    want, want_salt, want_mp = ref_table.device_wide_table()
    got, salt, mp = signature_table_from_reference(
        ref_table).device_wide_table(device=CPU)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(want).view(np.int32))
    assert salt == int(want_salt) and mp == want_mp
    assert got.dtype == torch.int32 and got.device == CPU


def test_load_rejects_a_short_kmer(tmp_path):
    """Kmers are packed in one pass over their first k residues, k the
    first kmer's length; a shorter kmer is a malformed table."""
    path = tmp_path / "bad.tbl"
    path.write_text("ACDEFGHI\tRoleA\nACDEFGH\tRoleB\n")
    with pytest.raises(ValueError, match="shorter"):
        port.SignatureTable.load(str(path))
    path.write_text("ACDEFGHI\tRoleA\nKLMNPQRSTV\tRoleB\n")
    got = port.SignatureTable.load(str(path))
    want = ref.SignatureTable.load(str(path))
    np.testing.assert_array_equal(got.key_lo, want.key_lo)
    np.testing.assert_array_equal(got.key_hi, want.key_hi)
    assert got.kmer_texts() == ["ACDEFGHI", "KLMNPQRS"]
