"""The port's wide-bucket table against the reference: byte-equal host
builds with the same salt, and the plain probe against the JAX probe on
hits, misses, invalid queries and a table that needs a bucket walk."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import collision_table
from kmers_anno_tpu.ops import hashing as ref_hashing
from kmers_anno_tpu.ops import widetable as ref
from kmers_anno_tpu_torch.engine.convert import wide_table_from_numpy
from kmers_anno_tpu_torch.ops import hashing
from kmers_anno_tpu_torch.ops import widetable as port

CPU = torch.device("cpu")


def _keys(rng, n):
    key = np.unique(rng.integers(0, 1 << 59, n * 2, dtype=np.uint64))
    key = rng.permutation(key)[:n]
    lo = (key & np.uint64(0x3FFFFFFF)).astype(np.uint32)
    hi = (key >> np.uint64(30)).astype(np.uint32)
    return lo, hi


BUILDS = {
    "empty": dict(n=0),
    "small": dict(n=100),
    "one_row_zone": dict(n=5000),
    "many_rows": dict(n=40000),
    "forced_walk": dict(n=48, n_rows=2, max_salts=1, seed=2),
}


@pytest.mark.parametrize("case", list(BUILDS))
def test_build_is_byte_equal_to_reference(case):
    spec = dict(BUILDS[case])
    n = spec.pop("n")
    lo, hi = _keys(np.random.default_rng(spec.pop("seed", n)), n)
    vals = np.arange(n, dtype=np.uint32) * 7
    want = ref.build_wide_table(lo, hi, vals, **spec)
    got = port.build_wide_table(lo, hi, vals, **spec)
    assert got[0].dtype == np.uint32
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1:] == want[1:]                       # salt, max_probes
    if case == "forced_walk":
        assert got[2] >= 2


@pytest.mark.parametrize("n", [0, 1, 1000, 1 << 20, 3_000_000, 3_200_000])
def test_wide_rows_for_matches_reference(n):
    assert port.wide_rows_for(n) == ref.wide_rows_for(n)


def test_fmix32_is_bit_equal_to_uint32_numpy():
    """Trap T1: the int64 emulation must wrap exactly like uint32."""
    rng = np.random.default_rng(7)
    lo = rng.integers(0, 1 << 32, 20000, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, 20000, dtype=np.uint64).astype(np.uint32)
    lo[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    hi[:4] = [0xFFFFFFFF, 0, 0x7FFFFFFF, 0xFFFFFFFF]
    t_lo = torch.from_numpy(lo.view(np.int32))
    t_hi = torch.from_numpy(hi.view(np.int32))
    for salt in ref_hashing.salt_sequence(6) + [0, 0xFFFFFFFF]:
        want = ref_hashing.mix_kmer_salted(lo, hi, np.uint32(salt), np)
        got = hashing.mix_kmer_salted(t_lo, t_hi, salt)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    x = torch.from_numpy(lo.astype(np.int64))
    np.testing.assert_array_equal(
        hashing.fmix32(x).numpy(),
        ref_hashing.fmix32(lo, np).astype(np.int64))


def _table(n, seed, **kw):
    lo, hi = _keys(np.random.default_rng(seed), n)
    vals = np.random.default_rng(seed + 1).integers(
        0, 1 << 31, n).astype(np.uint32)
    table, salt, mp = port.build_wide_table(lo, hi, vals, **kw)
    return lo, hi, vals, table, salt, mp


def _queries(case, lo, hi, rng):
    n = len(lo)
    if case == "hits":
        return lo, hi, np.ones(n, bool)
    if case == "misses":
        mlo, mhi = _keys(rng, 3000)
        keys = (hi.astype(np.uint64) << np.uint64(32)) | lo
        fresh = ~np.isin((mhi.astype(np.uint64) << np.uint64(32)) | mlo,
                         keys)
        return mlo[fresh], mhi[fresh], np.ones(int(fresh.sum()), bool)
    # mixed: half hits, half misses, 8% invalid, odd count
    mlo, mhi = _keys(rng, n)
    qlo = np.concatenate([lo, mlo])[: 2 * n - 1]
    qhi = np.concatenate([hi, mhi])[: 2 * n - 1]
    perm = rng.permutation(len(qlo))
    return qlo[perm], qhi[perm], rng.random(len(qlo)) >= 0.08


@pytest.mark.parametrize("case", ["hits", "misses", "mixed"])
@pytest.mark.parametrize("layout", ["single_row", "walk"])
def test_probe_plain_matches_jax(case, layout):
    kw = dict(n_rows=2, max_salts=1) if layout == "walk" else {}
    n = 48 if layout == "walk" else 5000
    lo, hi, vals, table, salt, mp = _table(n, 3, **kw)
    assert (mp >= 2) == (layout == "walk")
    qlo, qhi, valid = _queries(case, lo, hi, np.random.default_rng(4))
    want = np.asarray(ref.probe_wide(
        jnp.asarray(table), jnp.asarray(qlo), jnp.asarray(qhi),
        jnp.asarray(valid), jnp.uint32(salt), max_probes=mp))
    got = port.probe_wide(
        wide_table_from_numpy(table, CPU),
        torch.from_numpy(qlo.view(np.int32)),
        torch.from_numpy(qhi.view(np.int32)),
        torch.from_numpy(valid), salt, mp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "hits":
        np.testing.assert_array_equal(got.numpy(), vals.astype(np.int32))
    if case == "misses":
        assert (got.numpy() == -1).all()


def test_plain_probe_chunks_agree(monkeypatch):
    """The chunked plain probe gives the same answer for any chunk."""
    lo, hi, vals, table, salt, mp = _table(2000, 9)
    qlo, qhi, valid = _queries("mixed", lo, hi, np.random.default_rng(2))
    args = (wide_table_from_numpy(table, CPU),
            torch.from_numpy(qlo.view(np.int32)),
            torch.from_numpy(qhi.view(np.int32)),
            torch.from_numpy(valid), salt, mp)
    whole = port.probe_wide_plain(*args)
    monkeypatch.setattr(port, "PROBE_CHUNK", 333)
    assert torch.equal(port.probe_wide_plain(*args), whole)


def test_probe_rejects_bad_arguments():
    _, _, _, table, salt, _ = _table(100, 1)
    t = wide_table_from_numpy(table, CPU)
    q = torch.zeros(5, dtype=torch.int32)
    v = torch.ones(5, dtype=torch.bool)
    with pytest.raises(ValueError):           # keys must be int32
        port.probe_wide(t, q.long(), q, v, salt)
    with pytest.raises(ValueError):           # valid must be bool
        port.probe_wide(t, q, q, v.int(), salt)
    with pytest.raises(ValueError):           # rows must be a power of 2
        port.probe_wide(t[:3], q, q, v, salt)
    with pytest.raises(ValueError):           # mismatched shapes
        port.probe_wide(t, q, q[:4], v, salt)


def test_wide_table_from_numpy_keeps_bits():
    _, _, _, table, _, _ = _table(300, 5)
    t = wide_table_from_numpy(table, CPU)
    assert t.dtype == torch.int32 and t.shape == table.shape
    assert t.numpy().view(np.uint32).tobytes() == table.tobytes()
    empty = table == ref.EMPTY
    assert empty.any() and (t.numpy()[empty] == -1).all()


# ---------------------------------------------------------------------------
# the lookup's edge cases: equal lo keys in one row, a walk that wraps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_queries", [1, 7, 31, 33, 1001])
@pytest.mark.parametrize("valid_mode", ["all_valid", "mixed", "all_invalid"])
def test_probe_collisions_and_wrap_match_jax(n_queries, valid_mode):
    """Keys of one lo word and another hi in one row, misses that share a
    table key's lo, a walk wrapping from the last row to row 0; query
    counts off multiples of 32."""
    table, salt, mp, (klo, khi, vals), (qlo, qhi, valid) = collision_table(
        np.random.default_rng(n_queries), n_queries, valid_mode)
    assert mp >= 2
    want = np.asarray(ref.probe_wide(
        jnp.asarray(table), jnp.asarray(qlo), jnp.asarray(qhi),
        jnp.asarray(valid), jnp.uint32(salt), max_probes=mp))
    got = port.probe_wide(
        wide_table_from_numpy(table, CPU),
        torch.from_numpy(qlo.view(np.int32)),
        torch.from_numpy(qhi.view(np.int32)),
        torch.from_numpy(valid), salt, mp)
    np.testing.assert_array_equal(got.numpy(), want)
    stored = dict(zip(((khi.astype(np.int64) << 32) | klo).tolist(),
                      vals.astype(np.int64).tolist()))
    expect = [stored.get(int(h) << 32 | int(lo), -1) if v else -1
              for lo, h, v in zip(qlo, qhi, valid)]
    np.testing.assert_array_equal(got.numpy(), expect)
    if valid_mode == "all_valid" and n_queries == 1001:
        assert (got.numpy() >= 0).any() and (got.numpy() < 0).any()
