"""The DNA window probe's wrapper and the table's key filter on the CPU,
against the JAX reference.

``probe_dna`` takes the plain version on CPU tensors and ignores the key
filter there (a Bloom filter has no false negatives, so it changes no
output).  Tolerance 0: on every made-up stream of ``chip_smoke.dna_streams``
(tile edges of the kernel, windows alternating valid and invalid, slices
at byte offsets 1, 7 and 15, entries joined on table keys, streams valid
to their end) over tables whose walks wrap, the wrapper with the filter and
without equals the reference's jitted ``probe_dna_flat``; every key of a
DNA table passes its filter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import dna_stream_tensors, dna_streams, dna_wrap_table
from kmers_anno_tpu.engine import dna_apply as ref_dna
from kmers_anno_tpu_torch.engine.convert import wide_table_from_numpy
from kmers_anno_tpu_torch.engine.dna_apply import DnaApplyEngine
from kmers_anno_tpu_torch.engine.signature import SignatureTable
from kmers_anno_tpu_torch.ops.dna_kmers import pack_dna_np
from kmers_anno_tpu_torch.ops.dna_probe import probe_dna
from kmers_anno_tpu_torch.ops.hashtable import build_table
from kmers_anno_tpu_torch.ops.key_filter import (build_key_filter, may_hold,
                                                 table_keys)

CPU = torch.device("cpu")
KS = [4, 8, 11, 15]


def reference_probe(table, codes, valid, k, max_probes) -> np.ndarray:
    """The reference's jitted ``probe_dna_flat`` on a stream padded to a
    power of two (code 0, invalid), so that streams share compiles; a
    window near the end reads code 0 past it either way."""
    n = len(codes)
    width = 1 << max(n - 1, 1).bit_length()
    c = np.zeros(width, np.uint8)
    v = np.zeros(width, bool)
    c[:n], v[:n] = codes, valid
    out = ref_dna.probe_dna_flat(jnp.asarray(table), jnp.asarray(c),
                                 jnp.asarray(v), k=k, max_probes=max_probes)
    return np.asarray(out)[:n]


@pytest.mark.parametrize("k", KS)
def test_every_dna_table_key_passes_its_filter(k):
    """Every key of a DNA table passes ``build_key_filter(*table_keys(...))``:
    the walked and wrapped buckets of ``dna_wrap_table`` and a table of a
    random sequence's k-mers at the engine's load factor."""
    rng = np.random.default_rng(k)
    wrap, _, _ = dna_wrap_table(rng, k, weighted=False)
    key = np.unique(pack_dna_np(rng.integers(0, 4, 60_000).astype(np.uint8),
                                k)[0])
    big, _ = build_table(key, np.zeros_like(key), np.arange(len(key),
                                                            dtype=np.uint32))
    for table in (wrap, big):
        lo, hi = table_keys(table)
        assert len(lo) and not hi.any()
        key_filter = build_key_filter(lo, hi)
        as_i32 = [torch.from_numpy(x.view(np.int32)) for x in (lo, hi)]
        assert bool(may_hold(key_filter, *as_i32).all())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k", KS)
def test_probe_with_and_without_filter_matches_reference(k, weighted):
    rng = np.random.default_rng(10 * k + weighted)
    table, mp, seq = dna_wrap_table(rng, k, weighted)
    t = wide_table_from_numpy(table, CPU)
    key_filter = build_key_filter(*table_keys(table))
    before = probe_dna.launches
    n_hits = 0
    for name, codes_np, valid_np, offsets in dna_streams(rng, k, seq):
        want = reference_probe(table, codes_np, valid_np, k, mp)
        codes, valid = dna_stream_tensors(codes_np, valid_np, offsets, CPU)
        plain = probe_dna(t, codes, valid, k=k, max_probes=mp)
        filtered = probe_dna(t, codes, valid, k=k, max_probes=mp,
                             key_filter=key_filter)
        np.testing.assert_array_equal(plain.numpy(), want, err_msg=name)
        np.testing.assert_array_equal(filtered.numpy(), want, err_msg=name)
        n_hits += int((want >= 0).sum())
    assert probe_dna.launches == before       # the CPU launches nothing
    assert n_hits > 1000


def test_probe_rejects_a_bad_filter():
    table, mp, seq = dna_wrap_table(np.random.default_rng(1), 8, False)
    t = wide_table_from_numpy(table, CPU)
    codes = torch.from_numpy(seq[:100].copy())
    valid = torch.ones(100, dtype=torch.bool)
    key_filter = build_key_filter(*table_keys(table))
    for bad in (key_filter.to(torch.int64), key_filter.view(torch.uint8),
                key_filter.reshape(-1, 4), key_filter[:0]):
        with pytest.raises(ValueError, match="key_filter must be"):
            probe_dna(t, codes, valid, k=8, max_probes=mp, key_filter=bad)
    with pytest.raises(ValueError, match="key_filter lies on meta"):
        probe_dna(t, codes, valid, k=8, max_probes=mp,
                  key_filter=key_filter.to("meta"))


def test_engine_holds_the_key_filter_beside_its_table():
    """``DnaApplyEngine`` keeps the filter of its table's keys on its
    device and probes through it: the payloads equal the reference's."""
    rng = np.random.default_rng(3)
    seq = rng.integers(0, 4, 5_000).astype(np.uint8)
    lo, hi = pack_dna_np(seq, 11)
    lo, idx = np.unique(lo, return_index=True)
    table = SignatureTable(k=11, key_lo=lo, key_hi=hi[idx],
                           role_idx=(idx % 7).astype(np.int32),
                           alphabet="dna",
                           role_ids=[f"Role{r}" for r in range(7)])
    engine = DnaApplyEngine(table, device="cpu")
    words = engine.table.numpy().view(np.uint32)
    assert torch.equal(engine.key_filter,
                       build_key_filter(*table_keys(words)))
    assert engine.key_filter.device == engine.table.device
    codes = torch.from_numpy(seq)
    valid = torch.ones(len(seq), dtype=torch.bool)
    valid[-10:] = False
    got = probe_dna(engine.table, codes, valid, k=11,
                    max_probes=engine.max_probes,
                    key_filter=engine.key_filter)
    want = reference_probe(words, seq, valid.numpy(), 11, engine.max_probes)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int((got >= 0).sum()) == len(seq) - 10
