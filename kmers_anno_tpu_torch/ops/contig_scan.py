"""Contig scanner: translate a DNA stream and pack a k-mer at every base.

Counterpart of ``kmers_anno_tpu/ops/pallas_contig.py`` (the one Pallas
kernel of the reference).  Position p of the stream holds the k-mer whose
amino acids are the codons at p, p+3, …, p+3(k-1):

    lo/hi[p] = packed 5-bit residue codes          (== ops.kmers packing)
    bad[p]   = any residue of the window is 'X', '*' or padding

``scan_stream`` launches the CUDA kernel ``csrc/contig_scan.cu`` for a
CUDA tensor and takes :func:`scan_stream_plain` for a CPU tensor.  Frame
and position bookkeeping (Q1 drop-last, the KmerPosition left edge) stays
with the caller, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .encode import DNA_AMBIG, PROT_PAD, PROT_STOP, PROT_X
from .kmers import MAX_K
from .translate import sliding_translate

# outputs one block of the kernel covers (``kTile`` in csrc/contig_scan.cu)
KERNEL_TILE = 4096


def _check_args(stream: torch.Tensor, k: int, lut: np.ndarray) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"contig scan supports 1 <= k <= {MAX_K}, got {k}")
    if stream.dim() != 1 or stream.dtype != torch.uint8:
        raise ValueError("stream must be a 1-D uint8 tensor of DNA codes")
    if stream.numel() == 0:
        raise ValueError("contig scan of an empty stream")
    if np.asarray(lut).shape != (65,):
        raise ValueError("lut must hold the 65 codon entries")
    if int(np.max(lut)) > PROT_PAD:
        raise ValueError("lut entries must be 5-bit residue codes")


def scan_stream_plain(stream: torch.Tensor, k: int, lut: np.ndarray
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-PyTorch scan; same contract as :func:`scan_stream`."""
    _check_args(stream, k, lut)
    n = stream.numel()
    dev = stream.device
    lut_t = torch.as_tensor(np.asarray(lut, np.int32), device=dev)
    pad = torch.full((3 * k - 1,), DNA_AMBIG, dtype=torch.uint8, device=dev)
    aa = sliding_translate(torch.cat([stream, pad]), lut_t)  # (n + 3k - 3,)
    lo = torch.zeros(n, dtype=torch.int32, device=dev)
    hi = torch.zeros_like(lo)
    bad = torch.zeros(n, dtype=torch.bool, device=dev)
    for j in range(k):
        a = aa[3 * j: 3 * j + n]
        if j < 6:
            lo |= a << (5 * j)
        else:
            hi |= a << (5 * (j - 6))
        bad |= (a == PROT_X) | (a == PROT_STOP) | (a >= PROT_PAD)
    return lo, hi, bad.to(torch.uint8)


def scan_stream(stream: torch.Tensor, k: int, lut: np.ndarray
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scan a concatenated DNA code stream on the stream's device.

    stream: (L,) uint8 DNA codes (0..3 = t,c,a,g; >= 4 ambiguous).
            Segments should be separated by >= 3k-1 ambiguity codes so no
            window crosses one.
    k:      kmer length, 1..12
    lut:    (65,) uint8 codon LUT (``ops.translate.codon_lut``), entries
            <= PROT_PAD
    returns (lo, hi, bad): (L,) int32, int32, uint8.  Reads past the end
            see ambiguous codes, so positions p >= L - 3k + 1 have
            bad == 1; the caller masks them.

    A CPU tensor takes :func:`scan_stream_plain`; a CUDA tensor launches
    the kernel (``csrc/contig_scan.cu``) or raises.  The stream may start
    at any byte (a slice of a larger tensor); the kernel takes the LUT by
    value, so launches on several CUDA streams with different genetic
    codes do not disturb each other.
    """
    _check_args(stream, k, lut)
    if stream.device.type == "cpu":
        return scan_stream_plain(stream, k, lut)
    if stream.device.type != "cuda":
        raise ValueError(f"scan_stream: unsupported device {stream.device}")
    stream = stream.contiguous()
    n = stream.numel()
    lo = torch.empty(n, dtype=torch.int32, device=stream.device)
    hi = torch.empty_like(lo)
    bad = torch.empty(n, dtype=torch.uint8, device=stream.device)
    with torch.cuda.device(stream.device):
        err = kernels.lib().kan_contig_scan(
            stream.data_ptr(), n, np.asarray(lut, np.uint8).tobytes(), k,
            lo.data_ptr(), hi.data_ptr(), bad.data_ptr(),
            kernels.stream_of(stream))
    kernels.check(err, "contig_scan kernel")
    scan_stream.launches += 1
    return lo, hi, bad


scan_stream.launches = 0
