"""Six-frame contig k-mer extraction, one strand at a time
(KmerReference.getContigKmers, KmerReference.java:157-203).

Counterpart of ``extract_contig_kmers_fused`` in
``kmers_anno_tpu/ops/contig_kmers.py`` and of the route it takes to the
Pallas kernel, ``strand_kmers_pallas`` (``ops/pallas_contig.py``): each
strand's codes go through the contig scanner (``ops.contig_scan``: the
CUDA kernel ``csrc/contig_scan.cu`` for a CUDA device, its plain version
for the CPU), and the base-granularity result comes back to the host,
where the Q1 mask and the KmerPosition left edges are applied.  No route
of the projection engine calls it: the engine scans every contig's both
strands as one window stream (``engine.projection.StreamWindowIndex``).

Semantics, as the reference's:

* Q1 — the final possible kmer of each frame protein is dropped
  (loop bound ``i < frameLen - K``, KmerReference.java:186-187);
* Q2 — kmers containing 'X' or '*' are rejected (KmerReference.java:190);
* coordinates — plus-strand left = p + 1 for base p (KmerPosition.java:
  60-62); minus-strand left = (contigLen - 3K + 1) - p (KmerPosition.java:
  78-86, Q11); every location spans 3K bases (Q4).
"""

from __future__ import annotations

import numpy as np
import torch

from .encode import encode_dna
from .contig_scan import scan_stream
from .translate import codon_lut


def strand_kmers(codes: np.ndarray, k: int, gc: int, device: torch.device
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Base-granularity (lo, hi, bad) for ONE strand's code array.

    codes: (L,) uint8 DNA codes in reading order.
    returns host arrays (lo uint32, hi uint32, bad bool) of length
    n_out = max(L - 3k + 1, 0): one entry per base whose window of k
    codons fits the strand.

    The scanner reads past the end of its stream as ambiguous code, so
    the codes go up as they are; entries past n_out (always bad) are
    dropped.  On a CUDA device that is one launch of the scanner, counted
    by ``scan_stream.launches``.
    """
    n_out = max(len(codes) - 3 * k + 1, 0)
    if n_out == 0:
        z = np.zeros(0, np.uint32)
        return z, z.copy(), np.zeros(0, bool)
    stream = torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(
        device)
    lo, hi, bad = scan_stream(stream, k, codon_lut(gc))
    return (lo[:n_out].cpu().numpy().astype(np.uint32),
            hi[:n_out].cpu().numpy().astype(np.uint32),
            bad[:n_out].cpu().numpy() != 0)


def extract_contig_kmers(contig_seq: str, k: int, gc: int,
                         device: torch.device) -> dict:
    """All valid (kmer, left, strand) tuples of one contig, both strands,
    in base-major order per strand (the reference's fused order).

    returns dict with host arrays lo, hi (uint32), left (int32, 1-based),
    strand (int8, '+'=0, '-'=1), all shape (N,).
    """
    codes = encode_dna(contig_seq)
    length = len(codes)
    rc_codes = np.where(codes < 4, codes ^ 2, codes)[::-1].copy()
    out_lo, out_hi, out_left, out_strand = [], [], [], []
    for strand, seq in ((0, codes), (1, rc_codes)):
        lo, hi, bad = strand_kmers(seq, k, gc, device)
        p = np.arange(len(lo), dtype=np.int64)
        f = p % 3                       # 0-based frame
        flen = (length - f) // 3        # frame protein length
        valid = ((p // 3) < flen - k) & ~bad        # Q1 strict drop-last
        v = np.flatnonzero(valid)
        left = v + 1 if strand == 0 else (length - 3 * k + 1) - v
        out_lo.append(lo[v])
        out_hi.append(hi[v])
        out_left.append(left.astype(np.int32))
        out_strand.append(np.full(len(v), strand, np.int8))
    return {
        "lo": np.concatenate(out_lo),
        "hi": np.concatenate(out_hi),
        "left": np.concatenate(out_left),
        "strand": np.concatenate(out_strand),
    }
