"""The port's ``apply`` path against the JAX reference on the CPU.

The votes, the row-layout apply step (``apply_rows_plain``, the plain
version of the ``csrc/apply_rows.cu`` kernel) array for array, the row
batches, and the whole ``KmerApplyEngine`` against the reference engine
and ``oracle.oracle_apply_protein``.  Exact, except the weighted vote with
non-integer weights: the port sums a row's weights exactly and rounds
once, the reference in float32 in the order of XLA's sort and cumsum, so
its tallies are held to rtol 1e-5 (float32 sums of a few fp16 weights
differ in the last bits at most) while its roles must be equal.  The
port's own tallies are order-free: equal under any permutation of a
row's windows, and equal to the exact rational sum rounded once.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import collision_rows
from kmers_anno_tpu.engine import apply_engine as ref_engine
from kmers_anno_tpu.engine import protein_kmers as ref_pk
from kmers_anno_tpu.engine import signature as ref_sig
from kmers_anno_tpu.ops import vote as ref_vote
from kmers_anno_tpu.ops import widetable as ref_widetable
from kmers_anno_tpu.ops.encode import PROT_PAD
from kmers_anno_tpu.ops.widetable import build_wide_table
from kmers_anno_tpu_torch.engine import apply_engine as port_engine
from kmers_anno_tpu_torch.engine import protein_kmers as port_pk
from kmers_anno_tpu_torch.engine import signature as port_sig
from kmers_anno_tpu_torch.engine.convert import (
    signature_table_from_reference, wide_table_from_numpy)
from kmers_anno_tpu_torch.ops import apply_rows as port_ar
from kmers_anno_tpu_torch.ops import vote as port_vote
from tests.fixtures import (ROLE_DEFS, make_genome, make_role_map,
                            random_protein)
from tests.oracle import oracle_apply_protein, oracle_build

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
    return ref_sig.build_signatures(genomes, make_role_map(), GOOD, k=K,
                                    progress=False)


@pytest.fixture(scope="module")
def oracle_db(genomes):
    return oracle_build(genomes, make_role_map(), GOOD, k=K)


@pytest.fixture
def drop_last_both():
    """The drop-last flag exists once in each package: set both, and
    restore both whatever happens."""
    ref_pk.set_drop_last(True)
    port_pk.set_drop_last(True)
    try:
        yield
    finally:
        ref_pk.set_drop_last(False)
        port_pk.set_drop_last(False)


def _np(t):
    return np.asarray(t)


# ---------------------------------------------------------------------------
# the votes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_hits", [1, 3, 5])
def test_unanimous_vote_matches_reference(min_hits):
    rng = np.random.default_rng(min_hits)
    rows, width = 64, 41
    roles = rng.integers(-1, 3, (rows, width)).astype(np.int32)
    roles[::2] = np.where(roles[::2] >= 0, 1, -1)     # unanimous rows
    roles[1::4] = -1                                  # rows without hits
    valid = rng.random((rows, width)) < 0.7
    want = ref_vote.unanimous_vote(jnp.asarray(roles), jnp.asarray(valid),
                                   jnp.int32(min_hits))
    got = port_vote.unanimous_vote(torch.from_numpy(roles),
                                   torch.from_numpy(valid), min_hits)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_unanimous_count_stays_below_min_hits():
    """A unanimous row below min_hits gets role -1 but keeps its count;
    a conflicting row gets count 0."""
    roles = torch.tensor([[4, 4, -1, -1], [4, 5, 4, 4], [-1] * 4,
                          [2, 2, 2, 2]], dtype=torch.int32)
    valid = torch.ones_like(roles, dtype=torch.bool)
    role, count = port_vote.unanimous_vote(roles, valid, 3)
    assert role.tolist() == [-1, -1, -1, 2]
    assert count.tolist() == [2, 0, 0, 4]


def test_split_packed_payload_matches_reference(ref_table):
    rng = np.random.default_rng(5)
    w = (rng.random(len(ref_table)) * 40).astype(np.float32)
    table = ref_sig.SignatureTable(
        k=K, key_lo=ref_table.key_lo, key_hi=ref_table.key_hi,
        role_idx=ref_table.role_idx, role_ids=ref_table.role_ids, weights=w)
    val = table._payloads(True).view(np.int32).copy()
    val[rng.random(len(val)) < 0.3] = -1                # misses
    got = port_vote.split_packed_payload(torch.from_numpy(val))
    want = ref_vote.split_packed_payload(jnp.asarray(val))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w_))
    assert got[1].dtype == torch.float32


@pytest.mark.parametrize("weights", ["uniform", "random"])
def test_weighted_vote_rows_matches_reference(weights):
    rng = np.random.default_rng(9)
    rows, width = 96, 57
    roles = rng.integers(-1, 6, (rows, width)).astype(np.int32)
    roles[:8, :] = -1                                   # no hits at all
    valid = rng.random((rows, width)) < 0.8
    if weights == "uniform":
        w = np.ones((rows, width), np.float32)
    else:   # fp16-representable weights, as packed payloads carry them
        w = (rng.random((rows, width)) * 3).astype(np.float16).astype(
            np.float32)
    # uniform weights make ties: the smaller role index must win them
    want = ref_vote.weighted_vote_rows(jnp.asarray(roles), jnp.asarray(w),
                                       jnp.asarray(valid), jnp.float32(2.0))
    got = port_vote.weighted_vote_rows(torch.from_numpy(roles),
                                       torch.from_numpy(w),
                                       torch.from_numpy(valid), 2.0)
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
    if weights == "uniform":
        np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    else:
        np.testing.assert_allclose(got[1].numpy(), _np(want[1]), rtol=1e-5)
    assert (got[0] >= 0).any() and (got[0] < 0).any()


def _fp16_weights(rng, shape, mix):
    """fp16-representable weights: random in [0, 3), or (``mix``) a mix of
    the largest fp16 (65,504), subnormals (2^-24 to 2^-14) and random
    magnitudes over fp16's range."""
    if not mix:
        return (rng.random(shape) * 3).astype(np.float16).astype(np.float32)
    kind = rng.integers(0, 3, shape)
    sub = rng.integers(1, 1 << 10, shape) * 2.0 ** -24
    wide = 2.0 ** rng.uniform(-14, 15, shape)
    w = np.where(kind == 0, 65504.0, np.where(kind == 1, sub, wide))
    return w.astype(np.float16).astype(np.float32)


def _round_fixed_to_f32(n: int) -> np.float32:
    """The float32 nearest to n * 2^-24 (ties to even), in integers."""
    shift = max(n.bit_length() - 24, 0)
    if shift:
        q, r = divmod(n, 1 << shift)
        half = 1 << (shift - 1)
        if r > half or (r == half and q & 1):
            q += 1
        n = q << shift
    return np.float32(float(n) * 2.0 ** -24)


@pytest.mark.parametrize("width", [37, 2000])
def test_weighted_tally_is_order_free(width):
    """Permuting a row's windows (roles, weights and validity together)
    changes no role and no tally bit."""
    rng = np.random.default_rng(width)
    rows = 16
    roles = rng.integers(-1, 5, (rows, width)).astype(np.int32)
    w = _fp16_weights(rng, (rows, width), mix=width > 100)
    valid = rng.random((rows, width)) < 0.9
    want = port_vote.weighted_vote_rows(torch.from_numpy(roles),
                                        torch.from_numpy(w),
                                        torch.from_numpy(valid), 1.0)
    for _ in range(3):
        perm = rng.permutation(width)
        got = port_vote.weighted_vote_rows(
            torch.from_numpy(roles[:, perm].copy()),
            torch.from_numpy(w[:, perm].copy()),
            torch.from_numpy(valid[:, perm].copy()), 1.0)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32))
    assert (want[0] >= 0).any()


def test_weighted_tally_is_the_exact_sum_rounded_once():
    """Rows 16,384 windows wide mixing 65,504 and subnormal weights: each
    role's tally is its exact rational sum rounded once to float32; the
    best rounded tally wins, the smaller role on a tie."""
    rng = np.random.default_rng(12)
    rows, width, n_roles = 6, 16_384, 4
    roles = rng.integers(0, n_roles, (rows, width)).astype(np.int32)
    roles[0] = 2                                    # one role only
    w = _fp16_weights(rng, (rows, width), mix=True)
    w[1] = np.float32(2.0 ** -24)                   # all the smallest step
    valid = rng.random((rows, width)) < 0.97
    min_weight = 1000.0
    got_role, got_tally = port_vote.weighted_vote_rows(
        torch.from_numpy(roles), torch.from_numpy(w),
        torch.from_numpy(valid), min_weight)
    fixed = (w.astype(np.float64) * 2.0 ** 24).astype(np.int64)
    for r in range(rows):
        sums = np.zeros(n_roles, np.int64)
        np.add.at(sums, roles[r][valid[r]], fixed[r][valid[r]])
        tallies = [_round_fixed_to_f32(int(x)) for x in sums]
        best = max(range(n_roles), key=lambda i: (tallies[i], -i))
        called = tallies[best] >= min_weight and tallies[best] > 0
        assert int(got_role[r]) == (best if called else -1)
        assert got_tally[r].item() == (tallies[best] if called else 0.0)
    assert int(got_role[1]) == -1 and 0 < float(np.float32(
        int(valid[1].sum()) * 2.0 ** -24)) < min_weight
    assert (got_role >= 0).sum() >= rows - 1


# ---------------------------------------------------------------------------
# the row-layout apply step: apply_rows_plain against the reference
# ---------------------------------------------------------------------------

def _row_case(k, width, n_rows, seed, small_table=False):
    """Protein rows built from table kmers (hits, some conflicting),
    random residues (misses), X and PROT_PAD padding; a wide table of
    those kmers.  ``small_table`` squeezes 90 keys into 4 rows with one
    salt, so lookups walk (max_probes > 1)."""
    rng = np.random.default_rng(seed)
    roles_n = 5
    lengths = rng.integers(0, width + 1, n_rows)
    lengths[0] = width
    codes = np.full((n_rows, width), PROT_PAD, np.uint8)
    for i, ln in enumerate(lengths):
        codes[i, :ln] = rng.integers(0, 20, ln)
    codes[rng.random(codes.shape) < 0.01] = 23            # X
    valid = np.zeros((n_rows, width), bool)
    for i, ln in enumerate(lengths):
        valid[i, : max(ln - k + 1, 0)] = True
    valid &= rng.random(valid.shape) < 0.95
    lo, hi = ref_sig.pack_kmers_np(codes.reshape(-1), k)
    ok = np.flatnonzero(valid.reshape(-1)[: len(lo)])
    n_keys = 90 if small_table else 150
    take = rng.choice(ok, min(len(ok) // 3, n_keys), replace=False)
    key, first = np.unique((hi[take].astype(np.int64) << 32) | lo[take],
                           return_index=True)
    key_lo = (key & 0xFFFFFFFF).astype(np.uint32)
    key_hi = (key >> 32).astype(np.uint32)
    # a key's role is its row's, so most rows are unanimous; one key in
    # ten gets another role, so some rows conflict
    vals = (take[first] // width % roles_n).astype(np.uint32)
    flip = rng.random(len(key)) < 0.1
    vals[flip] = (vals[flip] + 1) % roles_n
    kw = dict(n_rows=4, max_salts=1) if small_table else {}
    table, salt, mp = build_wide_table(key_lo, key_hi, vals, **kw)
    return codes, valid, table, salt, mp


ROW_CASES = {
    "k8_w320": dict(k=8, width=320, n_rows=48, seed=1),
    "k8_odd_width": dict(k=8, width=37, n_rows=13, seed=2),
    "k12_walk": dict(k=12, width=101, n_rows=40, seed=3, small_table=True),
    "k3": dict(k=3, width=64, n_rows=16, seed=4),
    "k5_one_column": dict(k=5, width=1, n_rows=9, seed=5),
}


@pytest.mark.parametrize("case", list(ROW_CASES))
@pytest.mark.parametrize("min_hits", [1, 3])
def test_apply_rows_plain_matches_reference(case, min_hits):
    params = ROW_CASES[case]
    codes, valid, table, salt, mp = _row_case(**params)
    k = params["k"]
    if params.get("small_table"):
        assert mp > 1
    want = ref_engine.apply_rows(
        jnp.asarray(table), jnp.uint32(salt), jnp.asarray(codes),
        jnp.asarray(valid), jnp.int32(min_hits), k=k, max_probes=mp)
    args = (wide_table_from_numpy(table, CPU), salt,
            torch.from_numpy(codes), torch.from_numpy(valid), min_hits, k,
            mp)
    got = port_ar.apply_rows_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (codes.shape[0],)
        np.testing.assert_array_equal(g.numpy(), _np(w))
    before = port_ar.apply_rows.launches
    again = port_ar.apply_rows(*args)               # CPU: the plain version
    assert port_ar.apply_rows.launches == before
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    if case == "k8_w320" and min_hits == 3:
        role, count = (g.numpy() for g in got)
        assert (role >= 0).any()
        assert ((role < 0) & (count > 0)).any()     # unanimous, too few


def test_apply_rows_rejects_bad_arguments():
    codes, valid, table, salt, mp = _row_case(8, 40, 4, 0)
    t = wide_table_from_numpy(table, CPU)
    c, v = torch.from_numpy(codes), torch.from_numpy(valid)
    bad = [
        (t, c.to(torch.int32), v, 8),
        (t, c, v.to(torch.uint8), 8),
        (t, c, v[:, :-1], 8),
        (t, c[0], v[0], 8),
        (t, c, v, 13),
        (t, c, v, 0),
        (t[:, :24], c, v, 8),
        (t.to(torch.int64), c, v, 8),
    ]
    for table_, codes_, valid_, k in bad:
        with pytest.raises(ValueError):
            port_ar.apply_rows(table_, salt, codes_, valid_, 1, k, mp)
    with pytest.raises(ValueError):
        port_ar.apply_rows(t, salt, c, v, 1, 8, 0)


# ---------------------------------------------------------------------------
# row batches
# ---------------------------------------------------------------------------

def _proteins(seed, lengths):
    rng = random.Random(seed)
    return [random_protein(rng, n) for n in lengths]


BATCH_CASES = {
    # lengths around the 30% padding cut, with more than 64 rows
    "padding_cuts": [rng_len for rng_len in
                     random.Random(1).choices(range(5, 700), k=300)],
    # one protein wider than the last bucket (16,384): width 2048-rounded
    "very_long": [40, 16_385, 9, 20_000, 300],
    "short_only": [3, 7, 8, 9],
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_make_row_batches_matches_reference(case):
    prots = _proteins(7, BATCH_CASES[case])
    want = ref_engine.make_row_batches(prots, K)
    got = port_engine.make_row_batches(prots, K)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.idx, w.idx)
        assert g.n == w.n
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.valid, w.valid)
    if case == "padding_cuts":
        assert len(got) > 1
    if case == "very_long":
        assert got[-1].codes.shape[1] == 20_480


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_python_loaders_match_native(case, monkeypatch):
    """Without the C++ host library, the row batches and the build's flat
    kmer keys are encoded in Python: the same arrays as the C++ loaders."""
    prots = _proteins(7, BATCH_CASES[case])
    want_batches = port_engine.make_row_batches(prots, K)
    want_keys = port_sig._flat_protein_keys(prots, K)
    monkeypatch.setattr(port_engine.native, "row_batch", lambda *a: None)
    monkeypatch.setattr(port_sig.native, "flat_batch", lambda *a: None)
    got_batches = port_engine.make_row_batches(prots, K)
    assert len(got_batches) == len(want_batches)
    for g, w in zip(got_batches, want_batches):
        np.testing.assert_array_equal(g.idx, w.idx)
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.valid, w.valid)
    for g, w in zip(port_sig._flat_protein_keys(prots, K), want_keys):
        np.testing.assert_array_equal(g, w)
    assert len(want_keys[0]) > 0


def test_row_batches_drop_last(drop_last_both):
    prots = ["MKLVANQRST", "ACDEFGHIKLMN"]
    got = port_engine.RowBatch(prots, 8, np.arange(2))
    want = ref_engine.RowBatch(prots, 8, np.arange(2))
    np.testing.assert_array_equal(got.valid, want.valid)
    assert int(got.valid.sum()) == 2 + 4


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_hits", [1, 5])
def test_engine_matches_reference_and_oracle(ref_table, oracle_db, genomes,
                                             min_hits):
    ref_eng = ref_engine.KmerApplyEngine(ref_table, min_hits=min_hits)
    eng = port_engine.KmerApplyEngine(
        signature_table_from_reference(ref_table), min_hits=min_hits,
        device=CPU)
    called = 0
    for genome in genomes:
        pegs = [f for f in genome.pegs if f.protein_translation]
        prots = [f.protein_translation for f in pegs]
        got = eng.call_proteins(prots)
        assert got == ref_eng.call_proteins(prots)
        assert got == [oracle_apply_protein(oracle_db, p, K, min_hits)
                       for p in prots]
        called += sum(c is not None for c in got)
        calls = eng.call_genome(genome)
        want = ref_eng.call_genome(genome)
        assert [(f.id, r, h) for f, r, h in calls] == \
            [(f.id, r, h) for f, r, h in want]
    assert called > 0


def test_engine_chimera_empty_and_short(ref_table, oracle_db):
    by_role = {}
    for km, rid in oracle_db.items():
        by_role.setdefault(rid, []).append(km)
    rids = sorted(by_role)[:2]
    chimera = by_role[rids[0]][0] + by_role[rids[1]][0]
    eng = port_engine.KmerApplyEngine(
        signature_table_from_reference(ref_table), min_hits=1, device=CPU)
    assert oracle_apply_protein(oracle_db, chimera, K, 1) is None
    assert eng.call_proteins([chimera]) == [None]
    assert eng.call_proteins(["MKV"]) == [None]
    assert eng.call_proteins([]) == []
    assert eng.call_proteins([by_role[rids[0]][0]]) == [(rids[0], 1)]


def test_engine_drop_last(genomes, drop_last_both):
    """Under --dropLast both packages build and apply with one window
    fewer per protein, and still agree."""
    want_t = ref_sig.build_signatures(genomes, make_role_map(), GOOD, k=K,
                                      progress=False)
    got_t = port_sig.build_signatures(genomes, make_role_map(), GOOD, k=K,
                                      progress=False, device=CPU)
    np.testing.assert_array_equal(got_t.key_lo, want_t.key_lo)
    np.testing.assert_array_equal(got_t.key_hi, want_t.key_hi)
    prots = [f.protein_translation for g in genomes for f in g.pegs
             if f.protein_translation]
    want = ref_engine.KmerApplyEngine(want_t, min_hits=3).call_proteins(
        prots)
    got = port_engine.KmerApplyEngine(got_t, min_hits=3,
                                      device=CPU).call_proteins(prots)
    assert got == want
    assert any(c is not None for c in got)


@pytest.mark.parametrize("mode", ["uniform", "balance"])
def test_weighted_engine_matches_reference(genomes, mode):
    table = ref_sig.build_signatures(genomes, make_role_map(), GOOD, k=K,
                                     progress=False, weight_mode=mode)
    rng = random.Random(77)
    texts = table.kmer_texts()
    prots = [f.protein_translation for g in genomes for f in g.pegs]
    for _ in range(40):      # spliced from table kmers of several roles
        parts = [random_protein(rng, rng.randint(5, 20))]
        for _ in range(rng.randint(0, 6)):
            parts.append(rng.choice(texts))
            parts.append(random_protein(rng, rng.randint(0, 10)))
        prots.append("".join(parts))
    want = ref_engine.KmerApplyEngine(
        table, min_hits=2, weighted=True, min_weight=1.5).call_proteins(
            prots)
    got = port_engine.KmerApplyEngine(
        signature_table_from_reference(table), min_hits=2, weighted=True,
        min_weight=1.5, device=CPU).call_proteins(prots)
    assert [g and g[0] for g in got] == [w and w[0] for w in want]
    for g, w in zip(got, want):
        if w is not None:
            if mode == "uniform":
                assert g[1] == w[1]
            else:
                assert g[1] == pytest.approx(w[1], rel=1e-5)
    assert sum(g is not None for g in got) > 10


@pytest.mark.parametrize("min_hits", [1, 5])
def test_engine_big_table_matches_reference(ref_table, oracle_db, genomes,
                                            min_hits, monkeypatch):
    """A table past one wide table takes the flat-stream path in both
    packages (``fits_wide`` False in both): the same calls as the
    reference's flat path and the oracle."""
    monkeypatch.setattr(ref_widetable, "fits_wide", lambda n: False)
    monkeypatch.setattr(port_sig, "fits_wide", lambda n: False)
    ref_eng = ref_engine.KmerApplyEngine(ref_table, min_hits=min_hits)
    eng = port_engine.KmerApplyEngine(
        signature_table_from_reference(ref_table), min_hits=min_hits,
        device=CPU)
    assert eng.mode == ref_eng.mode == "flat"
    for genome in genomes:
        prots = [f.protein_translation for f in genome.pegs
                 if f.protein_translation]
        got = eng.call_proteins(prots)
        assert got == ref_eng.call_proteins(prots)
        assert got == [oracle_apply_protein(oracle_db, p, K, min_hits)
                       for p in prots]
        assert [(f.id, r, h) for f, r, h in eng.call_genome(genome)] == \
            [(f.id, r, h) for f, r, h in ref_eng.call_genome(genome)]


@pytest.mark.parametrize("k,width,n_rows", [(12, 45, 21), (12, 100, 40),
                                            (8, 33, 17), (8, 1, 5)])
@pytest.mark.parametrize("min_hits", [1, 3])
def test_apply_rows_collisions_and_wrap_match_reference(k, width, n_rows,
                                                        min_hits):
    """apply_rows_plain on equal-lo keys and a wrapping walk, widths off
    multiples of 32, rows with no valid window."""
    codes, valid, table, salt, mp = collision_rows(
        np.random.default_rng(k * width), k, width, n_rows)
    want = ref_engine.apply_rows(
        jnp.asarray(table), jnp.uint32(salt), jnp.asarray(codes),
        jnp.asarray(valid), jnp.int32(min_hits), k=k, max_probes=mp)
    got = port_ar.apply_rows_plain(
        wide_table_from_numpy(table, CPU), salt, torch.from_numpy(codes),
        torch.from_numpy(valid), min_hits, k, mp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    role, count = (g.numpy() for g in got)
    assert (role[::4] == -1).all() and (count[::4] == 0).all()
    if width > 1:
        assert (count > 0).any()
