"""The flat-stream kernels' key filter and the weighted step's contiguity
contract, on the CPU, against the JAX reference.

The key filter (``ops.key_filter``) sits in front of the 8-slot table walk
of ``csrc/apply_flat.cu``; it must pass every key of a table (walked and
wrapped buckets too, tables built by the port and by the reference), keep
its false-positive share under its design bound, and give the same bits in
any key order.  The weighted kernel owns each protein's tokens as one
contiguous run: ``FlatBatch`` lays proteins out so on both loaders, and
``apply_weighted_flat`` refuses a stream whose seg_ids decrease.  The plain
weighted step on the kernel's edge streams (``chip_smoke.WEIGHTED_EDGES``:
a 40,000-aa protein, 30,000 roles, float32 ties of unequal sums, zero
weights, empty proteins, owner-round edges) equals the reference's: roles
exact, tallies rtol 1e-5 (the reference sums in float32 in XLA's order).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (WEIGHTED_EDGES, collision_table,
                        check_bucket_collisions_and_wrap, flat_case,
                        weighted_edge)
from kmers_anno_tpu.engine import apply_engine as ref_engine
from kmers_anno_tpu.ops.hashtable import build_table as ref_build_table
from kmers_anno_tpu_torch.engine import apply_engine as port_engine
from kmers_anno_tpu_torch.engine.convert import wide_table_from_numpy
from kmers_anno_tpu_torch.ops import apply_flat as port_af
from kmers_anno_tpu_torch.ops import key_filter as kf
from kmers_anno_tpu_torch.ops.hashtable import build_table
from tests.fixtures import random_protein

CPU = torch.device("cpu")


def _keys(n_keys, seed):
    rng = np.random.default_rng(seed)
    combined = np.unique(rng.integers(0, 1 << 59, n_keys + 1000,
                                      dtype=np.uint64))[:n_keys]
    lo = (combined & np.uint64(0x3FFFFFFF)).astype(np.uint32)
    hi = (combined >> np.uint64(30)).astype(np.uint32)
    return lo, hi


def _held(key_filter, lo, hi):
    return kf.may_hold(key_filter, torch.from_numpy(lo.view(np.int32)),
                       torch.from_numpy(hi.view(np.int32))).numpy()


def _collide_keys(seed):
    """collision_table's keys: six lo words, so that buckets hold several
    keys of one lo word."""
    rng = np.random.default_rng(seed)
    _, _, _, (lo, hi, _), _ = collision_table(rng, 10)
    return lo, hi


TABLE_CASES = {
    "random": dict(n_keys=20_000, load=0.5),
    "walks": dict(n_keys=3_000, load=0.95),
    "collide_walk_wrap": dict(n_keys=150, n_buckets=32),
}


@pytest.mark.parametrize("package", ["port", "reference"])
@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_filter_passes_every_table_key(case, package):
    """The filter of a table's own keys passes every one of them, in
    walked and wrapped buckets too; the port's and the reference's builds
    of one key set give one filter."""
    params = TABLE_CASES[case]
    if case.startswith("collide"):
        lo, hi = _collide_keys(5)
        kw = dict(n_buckets=params["n_buckets"])
    else:
        lo, hi = _keys(params["n_keys"], 3)
        kw = dict(load_factor=params["load"])
    vals = np.arange(len(lo), dtype=np.uint32)
    build = build_table if package == "port" else ref_build_table
    table, mp = build(lo, hi, vals, **kw)
    table = np.asarray(table, np.uint32)
    if case != "random":
        assert mp >= 2                          # some keys walked
    t_lo, t_hi = kf.table_keys(table)
    assert len(t_lo) == len(lo)
    key_filter = kf.build_key_filter(t_lo, t_hi)
    assert key_filter.shape == (kf.filter_sectors(len(lo)), kf.SECTOR_WORDS)
    assert key_filter.dtype == torch.int32
    assert _held(key_filter, lo, hi).all()
    assert torch.equal(key_filter, kf.build_key_filter(lo, hi))


@pytest.mark.parametrize("case", ["k8_collide_wrap", "k12_collide_wrap"])
def test_filter_passes_keys_of_wrapped_buckets(case):
    """flat_case's squeezed tables (a bucket with two keys of one lo word,
    a walk that wraps from the last bucket to bucket 0)."""
    from chip_smoke import FLAT_EDGES

    _, table, mp = flat_case(np.random.default_rng(11), n_roles=5,
                             **FLAT_EDGES[case])
    check_bucket_collisions_and_wrap(table, mp)
    lo, hi = kf.table_keys(table)
    assert _held(kf.build_key_filter(lo, hi), lo, hi).all()


@pytest.mark.parametrize("n_keys", [1, 1_000, 100_000])
def test_filter_false_positive_share(n_keys):
    """10^5 random non-keys: the share that passes stays under 1%, the
    design bound (16 bits a key, one bit in each of a sector's 8 words:
    about 0.1-0.2%)."""
    lo, hi = _keys(n_keys + 100_000, 8)
    key_filter = kf.build_key_filter(lo[:n_keys], hi[:n_keys])
    share = _held(key_filter, lo[n_keys:], hi[n_keys:]).mean()
    assert share < 0.01
    n_bytes = 4 * key_filter.numel()
    assert n_bytes == 4 * kf.SECTOR_WORDS * kf.filter_sectors(n_keys)
    if n_keys >= 1_000:
        assert n_bytes * 8 / n_keys == pytest.approx(
            kf.FILTER_BITS_PER_KEY, rel=0.01)


def test_filter_bits_are_order_free():
    lo, hi = _keys(30_000, 9)
    want = kf.build_key_filter(lo, hi)
    rng = np.random.default_rng(9)
    for _ in range(3):
        perm = rng.permutation(len(lo))
        assert torch.equal(kf.build_key_filter(lo[perm], hi[perm]), want)


def test_filter_check_matches_the_bit_layout():
    """may_hold reads the bits build_key_filter sets: one key's sector
    holds exactly its 8 bits, one a word."""
    lo, hi = _keys(1, 4)
    key_filter = kf.build_key_filter(lo, hi)
    assert key_filter.shape == (1, kf.SECTOR_WORDS)
    assert [bin(int(w) & 0xFFFFFFFF).count("1")
            for w in key_filter[0]] == [1] * 8
    for word in range(kf.SECTOR_WORDS):
        cleared = key_filter.clone()
        cleared[0, word] = 0
        assert not _held(cleared, lo, hi).any()


# ---------------------------------------------------------------------------
# the weighted step's contiguity contract
# ---------------------------------------------------------------------------

SEG_CASES = {
    "mixed": [40, 7, 0, 300, 8, 9, 120, 1],
    "empty_and_short": [0, 3, 0, 7, 0],
    "none": [],
    "many": random.Random(3).choices(range(0, 400), k=300),
}


@pytest.mark.parametrize("loader", ["native", "python"])
@pytest.mark.parametrize("case", list(SEG_CASES))
def test_flat_batch_segments_are_contiguous(case, loader, monkeypatch):
    """FlatBatch's seg_ids never decrease: protein i owns exactly the
    tokens from the sum of the lengths before it, then padding (n_seqs),
    on both loaders."""
    rng = random.Random(7)
    prots = [random_protein(rng, n) for n in SEG_CASES[case]]
    if loader == "python":
        monkeypatch.setattr(port_engine.native, "flat_batch",
                            lambda *a: None)
    batch = port_engine.FlatBatch(prots, 8)
    seg = batch.seg_ids
    assert (np.diff(seg) >= 0).all()
    ends = np.cumsum([len(p) for p in prots], dtype=np.int64)
    starts = ends - [len(p) for p in prots]
    for i, (a, b) in enumerate(zip(starts, ends)):
        assert (seg[a:b] == i).all()
    total = int(ends[-1]) if len(ends) else 0
    assert (seg[total:] == batch.n_seqs).all()
    np.testing.assert_array_equal(
        np.searchsorted(seg, np.arange(len(prots) + 1), side="left"),
        np.concatenate([starts, [total]]))


def test_weighted_flat_rejects_a_stream_out_of_order():
    rng = np.random.default_rng(2)
    batch, table, mp, k, n_roles, _ = weighted_edge(rng, "tile_edges")
    args = [wide_table_from_numpy(table, CPU)] + [
        torch.from_numpy(a) for a in (batch.codes, batch.seg_ids,
                                      batch.valid)]
    kw = dict(k=k, max_probes=mp, n_seqs=batch.n_seqs, n_roles=n_roles)
    port_af.apply_weighted_flat(*args, 1.5, **kw)          # in order: fine
    seg = args[2].clone()
    a, b = int(np.flatnonzero(batch.seg_ids == 3)[0]), int(
        np.flatnonzero(batch.seg_ids == 5)[0])
    seg[a], seg[b] = seg[b].clone(), seg[a].clone()
    with pytest.raises(ValueError, match="never decrease"):
        port_af.apply_weighted_flat(args[0], args[1], seg, args[3], 1.5,
                                    **kw)
    # the plain version itself takes any order
    port_af.apply_weighted_flat_plain(args[0], args[1], seg, args[3], 1.5,
                                      **kw)
    for bad_roles in (0, 1 << 16 | 1):
        with pytest.raises(ValueError, match="n_roles"):
            port_af.apply_weighted_flat(*args, 1.5, **dict(
                kw, n_roles=bad_roles))


def test_weighted_flat_rejects_a_bad_filter():
    rng = np.random.default_rng(2)
    batch, table, mp, k, n_roles, _ = weighted_edge(rng, "empty_proteins")
    args = [wide_table_from_numpy(table, CPU)] + [
        torch.from_numpy(a) for a in (batch.codes, batch.seg_ids,
                                      batch.valid)]
    kw = dict(k=k, max_probes=mp, n_seqs=batch.n_seqs)
    good = torch.zeros((4, kf.SECTOR_WORDS), dtype=torch.int32)
    for bad in (good.to(torch.int64), good[:, :4], good[:0], good[0]):
        with pytest.raises(ValueError, match="key_filter"):
            port_af.apply_flat(*args, 1, **kw, key_filter=bad)
        with pytest.raises(ValueError, match="key_filter"):
            port_af.apply_weighted_flat(*args, 1.5, **kw, n_roles=n_roles,
                                        key_filter=bad)


@pytest.mark.parametrize("case", list(WEIGHTED_EDGES))
def test_weighted_edges_plain_match_reference(case):
    """The plain weighted step on the kernel's edge streams equals the
    reference's apply_weighted_flat; with min_weight 0 a tally of 0 is
    still not called."""
    rng = np.random.default_rng(len(case))
    batch, table, mp, k, n_roles, expect = weighted_edge(rng, case)
    port = [wide_table_from_numpy(table, CPU)] + [
        torch.from_numpy(a) for a in (batch.codes, batch.seg_ids,
                                      batch.valid)]
    ref = [jnp.asarray(a) for a in (table, batch.codes, batch.seg_ids,
                                    batch.valid)]
    kw = dict(k=k, max_probes=mp, n_seqs=batch.n_seqs, n_roles=n_roles)
    for min_weight in (1.5, 0.0):
        role, tally = port_af.apply_weighted_flat(*port, min_weight, **kw)
        want = ref_engine.apply_weighted_flat(*ref, jnp.float32(min_weight),
                                              **kw)
        np.testing.assert_array_equal(role.numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(tally.numpy(), np.asarray(want[1]),
                                   rtol=1e-5)
        assert (tally.numpy()[role.numpy() < 0] == 0).all()
        assert (tally.numpy()[role.numpy() >= 0] > 0).all()
        if expect is not None:
            np.testing.assert_array_equal(role.numpy(), expect)
    assert (role.numpy() >= 0).any()
