"""The port's contig scanner against the reference's Pallas kernel, run
in interpret mode on the CPU (as tests/test_pallas_contig.py runs it).
Every comparison is exact: the outputs are integers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmers_anno_tpu.ops import kmers as ref_kmers
from kmers_anno_tpu.ops import translate as ref_translate
from kmers_anno_tpu.ops.pallas_contig import scan_stream_device
from kmers_anno_tpu_torch.ops import kmers
from kmers_anno_tpu_torch.ops.contig_scan import scan_stream, scan_stream_plain
from kmers_anno_tpu_torch.ops.translate import codon_lut, sliding_translate


def _stream(seed: int, n: int, p_amb: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < p_amb] = 4
    return codes


@pytest.mark.parametrize("k", [8, 12])
@pytest.mark.parametrize("n,p_amb,gc", [
    (2001, 0.0, 11),        # random, odd length
    (4097, 0.02, 11),       # ambiguous bases, one past a power of two
    (977, 0.3, 11),         # mostly ambiguous windows
    (1501, 0.01, 4),        # another genetic code (TGA = W)
])
def test_plain_matches_pallas(k, n, p_amb, gc):
    codes = _stream(n + k, n, p_amb)
    lo, hi, bad = scan_stream(torch.from_numpy(codes), k, codon_lut(gc))
    rlo, rhi, rbad, _ = scan_stream_device(codes, k, gc, interpret=True)
    m = n - 3 * k + 1
    assert lo.dtype == hi.dtype == torch.int32 and bad.dtype == torch.uint8
    assert lo.shape == hi.shape == bad.shape == (n,)
    np.testing.assert_array_equal(lo.numpy()[:m], np.asarray(rlo)[:m])
    np.testing.assert_array_equal(hi.numpy()[:m], np.asarray(rhi)[:m])
    np.testing.assert_array_equal(bad.numpy()[:m], np.asarray(rbad)[:m])
    assert (bad.numpy()[m:] == 1).all()     # windows past the end: masked


def test_short_stream_is_all_bad():
    lo, hi, bad = scan_stream(torch.zeros(10, dtype=torch.uint8), 8,
                              codon_lut(11))
    assert bad.tolist() == [1] * 10


@pytest.mark.parametrize("k", [0, 13])
def test_rejects_k_out_of_range(k):
    with pytest.raises(ValueError):
        scan_stream(torch.zeros(100, dtype=torch.uint8), k, codon_lut(11))


def test_rejects_empty_and_wrong_dtype():
    with pytest.raises(ValueError):
        scan_stream(torch.zeros(0, dtype=torch.uint8), 8, codon_lut(11))
    with pytest.raises(ValueError):
        scan_stream(torch.zeros(100, dtype=torch.int32), 8, codon_lut(11))


def test_cpu_tensor_takes_plain_version_without_launch():
    codes = torch.from_numpy(_stream(5, 300, 0.05))
    before = scan_stream.launches
    got = scan_stream(codes, 8, codon_lut(11))
    want = scan_stream_plain(codes, 8, codon_lut(11))
    assert scan_stream.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("gc", [11, 4, 1])
def test_codon_lut_and_sliding_translate_match_jax(gc):
    np.testing.assert_array_equal(codon_lut(gc), ref_translate.codon_lut(gc))
    codes = _stream(gc, 1003, 0.05)
    codes[::97] = 5                                  # padding codes too
    want = np.asarray(ref_translate.sliding_translate(
        jnp.asarray(codes), jnp.asarray(ref_translate.codon_lut(gc))))
    got = sliding_translate(torch.from_numpy(codes),
                            torch.from_numpy(codon_lut(gc)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [5, 8, 12])
def test_kmer_packing_matches_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 32, (3, 61)).astype(np.uint8)   # X, *, pads
    lo, hi = kmers.pack_kmer_windows(torch.from_numpy(codes), k)
    rlo, rhi = ref_kmers.pack_kmer_windows(jnp.asarray(codes), k)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo).view(np.int32))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi).view(np.int32))
    flags = codes == 23
    np.testing.assert_array_equal(
        kmers.window_any(torch.from_numpy(flags), k).numpy(),
        np.asarray(ref_kmers.window_any(jnp.asarray(flags), k)))
    nlo, nhi = kmers.pack_kmers_np(codes[0], k)
    np.testing.assert_array_equal(nlo, np.asarray(rlo)[0, : 62 - k])
    np.testing.assert_array_equal(nhi, np.asarray(rhi)[0, : 62 - k])
