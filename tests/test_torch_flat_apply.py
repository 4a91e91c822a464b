"""The port's flat-stream, big-table ``apply`` path against the JAX
reference on the CPU.

``FlatBatch``, the probe-window table and the sliced probe (both modes,
the overflow fallback), the flat weighted votes, the plain versions of the
``csrc/apply_flat.cu`` kernels array for array, the 8-slot device table
and the whole ``KmerApplyEngine`` forced onto the flat path.  The port
walks the plain 8-slot table at every size; it is held to the reference on
the plain and on the probe-window layout.  Roles, hits
and probe values are exact.  Weighted tallies: the port sums each (protein,
role) exactly and rounds once, so its flat, dense and chunked votes agree
bit for bit with each other and under any permutation of the tokens; the
reference sums in float32 in XLA's order, so against it tallies are held to
rtol 1e-5 (exact with uniform weights) and roles must be equal.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmers_anno_tpu.engine import apply_engine as ref_engine
from kmers_anno_tpu.engine import protein_kmers as ref_pk
from kmers_anno_tpu.engine import signature as ref_sig
from kmers_anno_tpu.ops import sliced_probe as ref_sp
from kmers_anno_tpu.ops import vote as ref_vote
from kmers_anno_tpu.ops import widetable as ref_wt
from kmers_anno_tpu.ops.hashtable import build_table
from kmers_anno_tpu_torch.engine import apply_engine as port_engine
from kmers_anno_tpu_torch.engine import protein_kmers as port_pk
from kmers_anno_tpu_torch.engine import signature as port_sig
from kmers_anno_tpu_torch.engine.convert import (
    signature_table_from_reference, wide_table_from_numpy)
from kmers_anno_tpu_torch.ops import apply_flat as port_af
from kmers_anno_tpu_torch.ops import sliced_probe as port_sp
from kmers_anno_tpu_torch.ops import vote as port_vote
from tests.fixtures import (ROLE_DEFS, make_genome, make_role_map,
                            random_protein)

GOOD = {rid for rid, _ in ROLE_DEFS[:4]}
K = 8
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _i32(a):
    return _t(np.asarray(a, np.uint32).view(np.int32))


@pytest.fixture
def drop_last_both():
    ref_pk.set_drop_last(True)
    port_pk.set_drop_last(True)
    try:
        yield
    finally:
        ref_pk.set_drop_last(False)
        port_pk.set_drop_last(False)


@pytest.fixture
def flat_only(monkeypatch):
    """Both packages see every table as too big for one wide table."""
    monkeypatch.setattr(ref_wt, "fits_wide", lambda n: False)
    monkeypatch.setattr(port_sig, "fits_wide", lambda n: False)


@pytest.fixture
def windowed_always(monkeypatch):
    """The reference lays every 8-slot table out in probe windows."""
    monkeypatch.setattr(ref_sp, "SLICED_THRESHOLD_BYTES", 0)


@pytest.fixture(scope="module")
def genomes():
    shared = random_protein(random.Random(999), 70)
    return [make_genome(f"100{i}.1", seed=i,
                        shared_protein=shared if i == 0 else None)
            for i in range(3)]


# ---------------------------------------------------------------------------
# FlatBatch
# ---------------------------------------------------------------------------

def _proteins(seed, lengths):
    rng = random.Random(seed)
    return [random_protein(rng, n) for n in lengths]


FLAT_CASES = {
    "mixed": [40, 7, 0, 300, 8, 9, 120, 1],
    "empty_and_short": [0, 3, 0, 7],
    "none": [],
    "many": random.Random(3).choices(range(0, 400), k=300),
    "past_min_tokens": [9000, 8000, 17],
}


@pytest.mark.parametrize("loader", ["native", "python"])
@pytest.mark.parametrize("case", list(FLAT_CASES))
def test_flat_batch_matches_reference(case, loader, monkeypatch):
    prots = _proteins(11, FLAT_CASES[case])
    if loader == "python":
        monkeypatch.setattr(port_engine.native, "flat_batch",
                            lambda *a: None)
    got = port_engine.FlatBatch(prots, K)
    want = ref_engine.FlatBatch(prots, K)
    assert got.n_seqs == want.n_seqs
    for name in ("codes", "seg_ids", "valid"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    total = sum(map(len, prots))
    assert len(got.codes) == max(16384, 1 << max(total - 1, 0).bit_length())
    assert int(got.valid.sum()) == sum(max(len(p) - K + 1, 0) for p in prots)


@pytest.mark.parametrize("loader", ["native", "python"])
def test_flat_batch_drop_last(drop_last_both, loader, monkeypatch):
    prots = ["MKLVANQRST", "ACDEFGHIKLMN", "MKV", "", "ACDEFGHI"]
    if loader == "python":
        monkeypatch.setattr(port_engine.native, "flat_batch",
                            lambda *a: None)
    got = port_engine.FlatBatch(prots, 8)
    want = ref_engine.FlatBatch(prots, 8)
    np.testing.assert_array_equal(got.valid, want.valid)
    assert int(got.valid.sum()) == 2 + 4 + 0 + 0 + 0


# ---------------------------------------------------------------------------
# the probe-window table and the sliced probe
# ---------------------------------------------------------------------------

def _keys(n_keys, seed):
    rng = np.random.default_rng(seed)
    combined = np.unique(rng.integers(0, 1 << 59, n_keys + 1000,
                                      dtype=np.uint64))[:n_keys]
    lo = (combined & np.uint64(0x3FFFFFFF)).astype(np.uint32)
    hi = (combined >> np.uint64(30)).astype(np.uint32)
    vals = rng.integers(0, 5000, n_keys, dtype=np.int64).astype(np.uint32)
    return lo, hi, vals


def _queries(lo, hi, n, seed, miss_frac=0.3):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, len(lo), n)
    qlo, qhi = lo[q].copy(), hi[q].copy()
    flip = rng.random(n) < miss_frac
    qlo[flip] ^= np.uint32(0x5)
    valid = np.ones(n, bool)
    valid[::17] = False
    return qlo, qhi, valid


def _ref_sliced(wt, qlo, qhi, valid, mp, payload=None):
    args = (jnp.asarray(wt), jnp.asarray(qlo), jnp.asarray(qhi),
            jnp.asarray(valid), mp)
    if payload is None:
        return np.asarray(ref_sp.probe_table_sliced(*args))
    v, p = ref_sp.probe_table_sliced(*args, payload=jnp.asarray(payload))
    return np.asarray(v), np.asarray(p)


def _port_args(wt, qlo, qhi, valid):
    return (wide_table_from_numpy(wt, CPU), _i32(qlo), _i32(qhi), _t(valid))


@pytest.mark.parametrize("n_keys,n_q,load", [
    (40_000, 10_000, 0.5), (300_000, 50_000, 0.5), (1_000, 333, 0.5),
    (3_000, 3_001, 0.9)])
def test_windowed_table_and_sliced_probe_match_reference(n_keys, n_q, load):
    """Both modes of the sliced probe and the windowed walk equal the
    reference's (payload mode in its bucket-sorted order); the 0.9 load
    walks up to the wrap from the last bucket to bucket 0."""
    lo, hi, vals = _keys(n_keys, 3)
    table, mp = build_table(lo, hi, vals, load_factor=load)
    wt = port_sp.windowed_table(table, mp)
    np.testing.assert_array_equal(wt, ref_sp.windowed_table(table, mp))
    if load > 0.5:
        assert mp >= 2
        qlo, qhi, valid = lo, hi, np.ones(len(lo), bool)
    else:
        qlo, qhi, valid = _queries(lo, hi, n_q, seed=4)
    args = _port_args(wt, qlo, qhi, valid)
    want = _ref_sliced(wt, qlo, qhi, valid, mp)
    got = port_sp.probe_table_sliced(*args, mp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        port_sp.probe_windowed(*args, mp).numpy(), want)
    seg = np.random.default_rng(n_q).integers(0, 1 << 20, len(qlo)).astype(
        np.int32)
    want_v, want_p = _ref_sliced(wt, qlo, qhi, valid, mp, seg)
    got_v, got_p = port_sp.probe_table_sliced(*args, mp, payload=_t(seg))
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    if load > 0.5:
        np.testing.assert_array_equal(want, vals.astype(np.int32))
    else:
        assert (want >= 0).any() and (want < 0).any()


@pytest.mark.parametrize("payload", [False, True])
def test_sliced_probe_duplicate_skew_overflow(payload):
    """Every query alike: one slice holds them all, past its window, and
    the whole-table fallback answers, in the reference's order."""
    lo, hi, vals = _keys(300_000, 7)
    table, mp = build_table(lo, hi, vals)
    wt = port_sp.windowed_table(table, mp)
    n = 50_000
    qlo = np.full(n, lo[123], np.uint32)
    qhi = np.full(n, hi[123], np.uint32)
    qlo[::7] = lo[5]                          # a second key, interleaved
    qhi[::7] = hi[5]
    valid = np.ones(n, bool)
    valid[::11] = False
    args = _port_args(wt, qlo, qhi, valid)
    if payload:
        seg = np.arange(n, dtype=np.int32)
        want_v, want_p = _ref_sliced(wt, qlo, qhi, valid, mp, seg)
        got_v, got_p = port_sp.probe_table_sliced(*args, mp, payload=_t(seg))
        np.testing.assert_array_equal(got_v.numpy(), want_v)
        np.testing.assert_array_equal(got_p.numpy(), want_p)
        back = np.full(n, -2, np.int32)
        back[got_p.numpy()] = got_v.numpy()
    else:
        back = port_sp.probe_table_sliced(*args, mp).numpy()
        np.testing.assert_array_equal(back, _ref_sliced(wt, qlo, qhi, valid,
                                                        mp))
    want = np.where(np.arange(n) % 7 == 0, vals[5], vals[123]).astype(
        np.int32)
    np.testing.assert_array_equal(back, np.where(valid, want, -1))


def test_pick_probe_threshold_matches_reference():
    for size in (1 << 20, 48 << 20, (48 << 20) + 1, 1 << 30):
        assert port_sp.pick_probe(size) == ref_sp.pick_probe(size)
    assert port_sp.SLICED_THRESHOLD_BYTES == ref_sp.SLICED_THRESHOLD_BYTES
    assert port_sp.MAX_SLICE_ROWS == ref_sp.MAX_SLICE_ROWS


def test_sliced_probe_rejects_bad_arguments():
    lo, hi, vals = _keys(500, 1)
    table, mp = build_table(lo, hi, vals, load_factor=0.9)
    assert mp >= 2
    wt, qlo, qhi, valid = _port_args(port_sp.windowed_table(table, mp), lo,
                                     hi, np.ones(len(lo), bool))
    for bad in ((wt[:, :24], qlo, qhi, valid, mp),
                (wt, qlo, qhi, valid, mp + 1),
                (wt, qlo.to(torch.int64), qhi, valid, mp),
                (wt, qlo, qhi, valid[:-1], mp),
                (wt, qlo[None], qhi[None], valid[None], mp)):
        with pytest.raises(ValueError):
            port_sp.probe_table_sliced(*bad)
        with pytest.raises(ValueError):
            port_sp.probe_windowed(*bad)


# ---------------------------------------------------------------------------
# the flat weighted votes
# ---------------------------------------------------------------------------

def _vote_case(seed, t, n_seqs, n_roles, weights):
    rng = np.random.default_rng(seed)
    roles = rng.integers(-1, n_roles, t).astype(np.int32)
    seg = np.sort(rng.integers(0, n_seqs + 1, t)).astype(np.int32)
    seg[-t // 10:] = n_seqs                               # padding tokens
    valid = rng.random(t) < 0.85
    if weights == "uniform":
        w = np.ones(t, np.float32)
    else:   # fp16-representable, as packed payloads carry them
        w = (rng.random(t) * 3).astype(np.float16).astype(np.float32)
    return roles, w, seg, valid


def _port_votes(roles, w, seg, valid, min_weight, n_seqs, n_roles, r_blk):
    args = (_t(roles), _t(w), _t(seg), _t(valid), min_weight)
    return {
        "flat": port_vote.weighted_vote_flat(*args, n_seqs=n_seqs),
        "dense": port_vote.weighted_vote_dense(*args, n_seqs=n_seqs,
                                               n_roles=n_roles),
        "chunked": port_vote.weighted_vote_chunked(
            *args, n_seqs=n_seqs, n_roles=n_roles, r_blk=r_blk)}


def _bit_equal(a, b):
    return (torch.equal(a[0], b[0])
            and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32)))


@pytest.mark.parametrize("weights", ["uniform", "fp16"])
@pytest.mark.parametrize("t,n_seqs,n_roles,r_blk", [
    (4096, 64, 17, 5), (999, 7, 3, 1), (5000, 300, 40, 16)])
def test_flat_votes_match_reference(t, n_seqs, n_roles, r_blk, weights):
    roles, w, seg, valid = _vote_case(t, t, n_seqs, n_roles, weights)
    min_weight = 1.5
    got = _port_votes(roles, w, seg, valid, min_weight, n_seqs, n_roles,
                      r_blk)
    jargs = (jnp.asarray(roles), jnp.asarray(w), jnp.asarray(seg),
             jnp.asarray(valid), jnp.float32(min_weight))
    want = {
        "flat": ref_vote.weighted_vote_flat(*jargs, n_seqs=n_seqs),
        "dense": ref_vote.weighted_vote_dense(*jargs, n_seqs=n_seqs,
                                              n_roles=n_roles),
        "chunked": ref_vote.weighted_vote_chunked(
            *jargs, n_seqs=n_seqs, n_roles=n_roles, r_blk=r_blk)}
    for name, (g_role, g_tally) in got.items():
        assert g_role.dtype == torch.int32 and g_tally.dtype == torch.float32
        np.testing.assert_array_equal(g_role.numpy(),
                                      np.asarray(want[name][0]))
        if weights == "uniform":
            np.testing.assert_array_equal(g_tally.numpy(),
                                          np.asarray(want[name][1]))
        else:
            np.testing.assert_allclose(g_tally.numpy(),
                                       np.asarray(want[name][1]), rtol=1e-5)
    assert _bit_equal(got["flat"], got["dense"])
    assert _bit_equal(got["flat"], got["chunked"])
    role, tally = (x.numpy() for x in got["flat"])
    assert (role >= 0).any() and (tally[role < 0] == 0).all()


@pytest.mark.parametrize("r_blk", [1, 3, 8, 40])
def test_flat_votes_are_order_free_and_exact(r_blk):
    """Mixed fp16 magnitudes (65,504 down to subnormals): any permutation
    of the tokens, any block size and every path give the same bits, each
    tally the exact sum rounded once; equal tallies call the smaller
    role."""
    rng = np.random.default_rng(r_blk)
    t, n_seqs, n_roles = 6000, 24, 40
    roles = rng.integers(0, n_roles, t).astype(np.int32)
    seg = rng.integers(0, n_seqs, t).astype(np.int32)
    kind = rng.integers(0, 3, t)
    w = np.where(kind == 0, 65504.0,
                 np.where(kind == 1, rng.integers(1, 1 << 10, t) * 2.0 ** -24,
                          2.0 ** rng.uniform(-14, 15, t)))
    w = w.astype(np.float16).astype(np.float32)
    valid = rng.random(t) < 0.95
    # protein 0: two roles with equal weight sets, the larger index first
    tie = seg == 0
    roles[tie] = np.where(np.arange(tie.sum()) % 2, 9, 31)
    w[tie] = np.repeat(w[tie][::2], 2)[: tie.sum()]
    valid[tie] = True
    if tie.sum() % 2:
        roles[np.flatnonzero(tie)[-1]] = -1
    want = _port_votes(roles, w, seg, valid, 0.0, n_seqs, n_roles, r_blk)
    assert _bit_equal(want["flat"], want["dense"])
    assert _bit_equal(want["flat"], want["chunked"])
    assert int(want["dense"][0][0]) == 9
    for _ in range(2):
        perm = rng.permutation(t)
        got = _port_votes(roles[perm], w[perm], seg[perm], valid[perm], 0.0,
                          n_seqs, n_roles, r_blk)
        assert all(_bit_equal(got[n], want[n]) for n in got)
    fixed = (w.astype(np.float64) * 2.0 ** 24).astype(np.int64)
    for s in range(n_seqs):
        m = valid & (seg == s) & (roles >= 0)
        sums = np.zeros(n_roles, np.int64)
        np.add.at(sums, roles[m], fixed[m])
        tallies = np.array([np.float32(x) * np.float32(2.0 ** -24)
                            for x in sums], np.float32)
        best = int(np.argmax(tallies))
        assert int(want["dense"][0][s]) == best
        assert want["dense"][1][s].item() == tallies[best]


def test_pick_weighted_vote_routes_like_reference():
    for n_seqs, n_roles in ((256, 2000), (8192, 2000), (8192, 4096),
                            (1 << 18, 2000), (1 << 26, 3)):
        got = port_vote.pick_weighted_vote(n_seqs, n_roles)
        want = ref_vote.pick_weighted_vote(n_seqs, n_roles)
        assert got.func.__name__ == want.func.__name__
        assert got.keywords == want.keywords
        assert port_vote.vote_block(n_seqs, n_roles) == want.keywords.get(
            "r_blk", n_roles)
    assert port_vote.DENSE_VOTE_LIMIT == ref_vote.DENSE_VOTE_LIMIT
    with pytest.raises(ValueError):
        port_vote.pick_weighted_vote(10, 0)


# ---------------------------------------------------------------------------
# the apply steps: apply_flat_plain / apply_weighted_flat_plain
# ---------------------------------------------------------------------------

def _stream_case(k, n_prot, seed, n_roles=6, weights=None, load=0.5):
    """A flat batch of proteins built from table kmers (hits, some of
    another role, so some proteins conflict), random residues and X; an
    8-slot table of those kmers.  Returns (batch, table, max_probes)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 90, n_prot)
    codes = [rng.integers(0, 20, n).astype(np.uint8) for n in lengths]
    for c in codes:
        c[rng.random(len(c)) < 0.01] = 23                # X
    from kmers_anno_tpu_torch.ops.encode import decode_protein
    prots = [decode_protein(c) for c in codes]
    batch = port_engine.FlatBatch(prots, k)
    lo, hi = ref_sig.pack_kmers_np(batch.codes, k)
    ok = np.flatnonzero(batch.valid[: len(lo)])
    take = rng.choice(ok, min(len(ok) // 3, 400), replace=False)
    key, first = np.unique((hi[take].astype(np.int64) << 32) | lo[take],
                           return_index=True)
    role = batch.seg_ids[take[first]] % n_roles
    flip = rng.random(len(key)) < 0.1
    role[flip] = (role[flip] + 1) % n_roles
    vals = role.astype(np.uint32)
    if weights is not None:
        w = ((rng.random(len(key)) * 3).astype(np.float16)
             if weights == "fp16" else np.ones(len(key), np.float16))
        vals = (w.view(np.uint16).astype(np.uint32) << np.uint32(16)) | vals
    table, mp = build_table((key & 0xFFFFFFFF).astype(np.uint32),
                            (key >> 32).astype(np.uint32), vals,
                            load_factor=load)
    return batch, table, mp


FLAT_STEP_CASES = {
    "k8": dict(k=8, n_prot=53, seed=1),
    "k12_walk": dict(k=12, n_prot=41, seed=2, load=0.95),
    "k8_walk": dict(k=8, n_prot=70, seed=3, load=0.95),
    "k3": dict(k=3, n_prot=20, seed=4),
}


def _flat_inputs(batch, table, mp, sliced):
    """The port's arguments (the plain table) and the reference's (the
    probe-window table when ``sliced``)."""
    t = ref_sp.windowed_table(table, mp) if sliced else table
    port = (wide_table_from_numpy(table, CPU), _t(batch.codes),
            _t(batch.seg_ids), _t(batch.valid))
    ref = (jnp.asarray(t), jnp.asarray(batch.codes),
           jnp.asarray(batch.seg_ids), jnp.asarray(batch.valid))
    return port, ref


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("case", list(FLAT_STEP_CASES))
@pytest.mark.parametrize("min_hits", [1, 3])
def test_apply_flat_plain_matches_reference(case, sliced, min_hits):
    params = FLAT_STEP_CASES[case]
    batch, table, mp = _stream_case(**params)
    if params.get("load", 0.5) > 0.5:
        assert mp >= 2
    k = params["k"]
    port, ref = _flat_inputs(batch, table, mp, sliced)
    kw = dict(k=k, max_probes=mp, n_seqs=batch.n_seqs)
    want = ref_engine.apply_flat(*ref, jnp.int32(min_hits), **kw,
                                 sliced=sliced)
    got = port_af.apply_flat_plain(*port, min_hits, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (batch.n_seqs,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    before = port_af.apply_flat.launches
    again = port_af.apply_flat(*port, min_hits, **kw)   # CPU: the plain one
    assert port_af.apply_flat.launches == before
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    role, hits = (g.numpy() for g in got)
    assert (role >= 0).any()
    assert ((role < 0) == (hits == 0)).all()     # uncalled: count 0


@pytest.mark.parametrize("weights", ["uniform", "fp16"])
@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("case", ["k8", "k12_walk"])
def test_apply_weighted_flat_plain_matches_reference(case, sliced, weights):
    params = FLAT_STEP_CASES[case]
    n_roles = 6
    batch, table, mp = _stream_case(**params, n_roles=n_roles,
                                    weights=weights)
    port, ref = _flat_inputs(batch, table, mp, sliced)
    kw = dict(k=params["k"], max_probes=mp, n_seqs=batch.n_seqs,
              n_roles=n_roles)
    want = ref_engine.apply_weighted_flat(*ref, jnp.float32(1.5), **kw,
                                          sliced=sliced)
    got = port_af.apply_weighted_flat_plain(*port, 1.5, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if weights == "uniform":
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    else:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-5)
    assert (got[0] >= 0).any()
    before = port_af.apply_weighted_flat.launches
    again = port_af.apply_weighted_flat(*port, 1.5, **kw)
    assert port_af.apply_weighted_flat.launches == before
    assert _bit_equal(again, got)
    # role blocks of 4 and of 1 give the same bits as the dense vote
    for r_blk in (4, 1):
        limit = batch.n_seqs * r_blk
        with pytest.MonkeyPatch.context() as mp_:
            mp_.setattr(port_vote, "DENSE_VOTE_LIMIT", limit)
            assert port_vote.vote_block(batch.n_seqs, n_roles) == r_blk
            chunked = port_af.apply_weighted_flat_plain(*port, 1.5, **kw)
        assert _bit_equal(chunked, got)


def test_apply_flat_rejects_bad_arguments():
    batch, table, mp = _stream_case(8, 10, 0)
    t = wide_table_from_numpy(table, CPU)
    wt = wide_table_from_numpy(port_sp.windowed_table(table, 2), CPU)
    c, s, v = _t(batch.codes), _t(batch.seg_ids), _t(batch.valid)
    kw = dict(max_probes=2, n_seqs=batch.n_seqs)
    bad = [
        ((t, c.to(torch.int32), s, v), dict(k=8)),
        ((t, c, s.to(torch.int64), v), dict(k=8)),
        ((t, c, s, v.to(torch.uint8)), dict(k=8)),
        ((t, c, s[:-1], v), dict(k=8)),
        ((t, c, s, v), dict(k=13)),
        ((wt, c, s, v), dict(k=8)),                  # the probe-window layout
        ((t.to(torch.int64), c, s, v), dict(k=8)),
    ]
    for args, extra in bad:
        with pytest.raises(ValueError):
            port_af.apply_flat(*args, 1, **kw, **extra)
        with pytest.raises(ValueError):
            port_af.apply_weighted_flat(*args, 1.0, n_roles=6, **kw,
                                        **extra)
    with pytest.raises(ValueError):
        port_af.apply_flat(t, c, s, v, 1, k=8, max_probes=0,
                           n_seqs=batch.n_seqs)


# ---------------------------------------------------------------------------
# the device tables and the engine on the flat path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
def test_device_table_matches_reference(genomes, packed, windowed_always):
    """The port's flat-path table equals the reference's 8-slot table, and
    the first block of every row of the reference's probe-window table."""
    want_t = ref_sig.build_signatures(genomes, make_role_map(), GOOD, k=K,
                                      progress=False, weight_mode="balance")
    table = signature_table_from_reference(want_t)
    got, mp = table.device_table(packed_weights=packed, device=CPU)
    want, want_mp = want_t.device_table(packed_weights=packed)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).view(np.int32))
    assert mp == want_mp and got.dtype == torch.int32
    want_w, want_mp_w, want_sliced = want_t.device_probe_table(
        packed_weights=packed)
    assert (want_mp_w, want_sliced) == (mp, True)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(want_w)[:, :24].view(np.int32))


def _engine_proteins(genomes, table):
    rng = random.Random(77)
    texts = table.kmer_texts()
    prots = [f.protein_translation for g in genomes for f in g.pegs]
    for _ in range(40):      # spliced from table kmers of several roles
        parts = [random_protein(rng, rng.randint(5, 20))]
        for _ in range(rng.randint(0, 6)):
            parts.append(rng.choice(texts))
            parts.append(random_protein(rng, rng.randint(0, 10)))
        prots.append("".join(parts))
    return prots + ["", "MKV"]


@pytest.mark.parametrize("layout", ["plain", "windowed"])
@pytest.mark.parametrize("mode", ["none", "uniform", "balance"])
def test_engine_flat_path_matches_reference(genomes, mode, layout, flat_only,
                                            monkeypatch):
    """Both engines on the flat path (``fits_wide`` False in both
    packages), the reference on the plain or the probe-window table, the
    port on the plain one: call_proteins and call_genome."""
    if layout == "windowed":
        monkeypatch.setattr(ref_sp, "SLICED_THRESHOLD_BYTES", 0)
    table = ref_sig.build_signatures(genomes, make_role_map(), GOOD, k=K,
                                     progress=False, weight_mode=mode)
    weighted = mode != "none"
    kw = dict(min_hits=2, weighted=weighted, min_weight=1.5)
    ref_eng = ref_engine.KmerApplyEngine(table, **kw)
    eng = port_engine.KmerApplyEngine(signature_table_from_reference(table),
                                      **kw, device=CPU)
    assert eng.mode == ref_eng.mode == "flat"
    assert ref_eng.sliced == (layout == "windowed")
    assert eng.table.shape[1] == 24
    prots = _engine_proteins(genomes, table)
    got = eng.call_proteins(prots)
    want = ref_eng.call_proteins(prots)
    assert [g and g[0] for g in got] == [w and w[0] for w in want]
    for g, w in zip(got, want):
        if w is not None:
            if mode == "balance":
                assert g[1] == pytest.approx(w[1], rel=1e-5)
            else:
                assert g[1] == w[1]
    assert sum(g is not None for g in got) > 10
    for genome in genomes:
        calls = eng.call_genome(genome)
        ref_calls = ref_eng.call_genome(genome)
        assert [(f.id, r) for f, r, _ in calls] == \
            [(f.id, r) for f, r, _ in ref_calls]
    assert eng.call_proteins([]) == []


@pytest.mark.parametrize("mode", ["none", "balance"])
def test_engine_flat_path_equals_wide_path(genomes, mode, monkeypatch):
    """In the port the two layouts give the same calls, tallies bit for
    bit: the flat votes and the row vote sum exactly and round once."""
    table = signature_table_from_reference(
        ref_sig.build_signatures(genomes, make_role_map(), GOOD, k=K,
                                 progress=False, weight_mode=mode))
    kw = dict(min_hits=3, weighted=mode != "none", min_weight=1.5,
              device=CPU)
    wide = port_engine.KmerApplyEngine(table, **kw)
    monkeypatch.setattr(port_sig, "fits_wide", lambda n: False)
    flat = port_engine.KmerApplyEngine(table, **kw)
    assert (wide.mode, flat.mode) == ("wide", "flat")
    prots = [f.protein_translation for g in genomes for f in g.pegs]
    want = wide._call_batches(len(prots), wide._prepare_proteins(prots))
    role, hits = flat._call_batches(len(prots), flat._prepare_proteins(prots))
    np.testing.assert_array_equal(role, want[0])
    called = role >= 0
    np.testing.assert_array_equal(hits[called].view(np.int32),
                                  want[1][called].view(np.int32))
    assert called.any() and (hits[~called] == 0).all()


def test_engine_flat_drop_last(genomes, drop_last_both, flat_only):
    table = ref_sig.build_signatures(genomes, make_role_map(), GOOD, k=K,
                                     progress=False)
    prots = [f.protein_translation for g in genomes for f in g.pegs
             if f.protein_translation]
    want = ref_engine.KmerApplyEngine(table, min_hits=3).call_proteins(prots)
    got = port_engine.KmerApplyEngine(signature_table_from_reference(table),
                                      min_hits=3,
                                      device=CPU).call_proteins(prots)
    assert got == want
    assert any(c is not None for c in got)
