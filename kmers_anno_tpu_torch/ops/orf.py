"""Vectorized ORF extension (the batch form of ``Location.extend``).

A copy of the reference package's ``ops/orf.py``.  ``Location.extend``
(the reference's genome/locations.py, mirroring PegProposal.create's
``loc.extend(genome)`` contract — PegProposal.java:50-58) walks codons one
at a time per proposal; the projection engine calls it ~40k times per close
genome.  This module precomputes, once per contig, the per-phase
"next stop at/after p" and "previous start-or-stop at/before p" scans for
both strands, making every extension an O(1) array lookup with identical
semantics:

* '+': the stop scan walks codons upward from the right edge stopping at
  the first stop codon; the start scan walks downward from the begin codon,
  succeeding on a start codon and aborting on a stop.
* '-': mirrored — stop scan walks downward below the left edge; start scan
  walks upward from the begin codon (at the right edge), aborting on stop.

Start/stop sets come from genome.dna.GeneticCode; the tests drive this
and the reference's scalar walker against each other.
"""

from __future__ import annotations

import numpy as np

from ..genome.dna import GeneticCode, codon_mask
from .encode import encode_dna

_BIG = np.int64(1) << 60


def _next_true(mask: np.ndarray) -> np.ndarray:
    """out[p] = smallest q >= p with q ≡ p (mod 3) and mask[q], else -1."""
    n = len(mask)
    out = np.full(n, -1, np.int64)
    pos = np.arange(n, dtype=np.int64)
    for ph in range(3):
        sl = slice(ph, n, 3)
        v = np.where(mask[sl], pos[sl], _BIG)
        m = np.minimum.accumulate(v[::-1])[::-1]
        out[sl] = np.where(m < _BIG, m, -1)
    return out


def _prev_true(mask: np.ndarray) -> np.ndarray:
    """out[p] = largest q <= p with q ≡ p (mod 3) and mask[q], else -1."""
    n = len(mask)
    out = np.full(n, -1, np.int64)
    pos = np.arange(n, dtype=np.int64)
    for ph in range(3):
        sl = slice(ph, n, 3)
        v = np.where(mask[sl], pos[sl], np.int64(-1))
        out[sl] = np.maximum.accumulate(v)
    return out


class ContigOrfScan:
    """Per-contig codon-class scan arrays (both strands)."""

    def __init__(self, seq: str, gc: int):
        code = GeneticCode.get(gc)
        codes = encode_dna(seq).astype(np.int64)
        self.length = len(codes)
        n = max(self.length - 2, 0)
        if n == 0:
            empty = np.zeros(0, np.int64)
            self.next_stop_plus = self.prev_event_plus = empty
            self.prev_stop_minus = self.next_event_minus = empty
            self.plus_start = self.minus_start = np.zeros(0, bool)
            return
        c0, c1, c2 = codes[:-2], codes[1:-1], codes[2:]
        ok = (c0 < 4) & (c1 < 4) & (c2 < 4)
        plus_id = np.where(ok, c0 * 16 + c1 * 4 + c2, 64)
        minus_id = np.where(ok, (c2 ^ 2) * 16 + (c1 ^ 2) * 4 + (c0 ^ 2), 64)
        start_lut = codon_mask(code.starts)
        stop_lut = codon_mask(code.stops)
        self.plus_start = start_lut[plus_id]
        plus_stop = stop_lut[plus_id]
        self.minus_start = start_lut[minus_id]
        minus_stop = stop_lut[minus_id]
        self.next_stop_plus = _next_true(plus_stop)
        self.prev_event_plus = _prev_true(self.plus_start | plus_stop)
        self.prev_stop_minus = _prev_true(minus_stop)
        self.next_event_minus = _next_true(self.minus_start | minus_stop)


class OrfExtender:
    """Genome-level O(1) replacement for ``Location.extend``."""

    def __init__(self, genome):
        self.genome = genome
        self._scans: dict[str, ContigOrfScan | None] = {}

    def _scan(self, contig_id: str) -> ContigOrfScan | None:
        scan = self._scans.get(contig_id, _MISSING)
        if scan is _MISSING:
            contig = self.genome.get_contig(contig_id)
            scan = (ContigOrfScan(contig.sequence, self.genome.genetic_code)
                    if contig is not None else None)
            self._scans[contig_id] = scan
        return scan

    def extend_batch(self, contig_idx: np.ndarray, contig_ids: list,
                     strands: np.ndarray, lefts: np.ndarray,
                     rights: np.ndarray):
        """Vectorized ``Location.extend`` over candidate arrays (the projection
        engine's proposal tail calls this once per close genome instead of
        ~40k scalar extends).

        contig_idx: (m,) int — index into contig_ids
        strands:    (m,) int — 0 = '+', 1 = '-'
        lefts/rights: (m,) int 1-based location edges
        returns (ext_left (m,) int64, ext_right (m,) int64, ok (m,) bool)
        — element-wise identical to ``Location.extend(genome)``, which the
        scalar walker tolerates outside [0, L-3): out-of-range scan origins
        are clamped into range phase-preserving (tests drive both).
        """
        m = len(lefts)
        lefts = np.asarray(lefts, np.int64)
        rights = np.asarray(rights, np.int64)
        out_l = np.zeros(m, np.int64)
        out_r = np.zeros(m, np.int64)
        ok = np.zeros(m, bool)
        length_ok = ((rights - lefts + 1) % 3) == 0
        for ci in np.unique(np.asarray(contig_idx)):
            scan = self._scan(contig_ids[ci])
            sel_c = contig_idx == ci
            if scan is None:
                continue
            n2 = len(scan.next_stop_plus)
            if n2 == 0:
                continue

            def lut(arr, pos, valid):
                return np.where(valid, arr[np.clip(pos, 0, n2 - 1)], -1)

            sel = np.flatnonzero(sel_c & (strands == 0) & length_ok)
            if len(sel):
                pos = rights[sel]
                q = lut(scan.next_stop_plus, pos, pos < n2)
                p0 = _clamp_down_vec(lefts[sel] - 1, n2)
                e = lut(scan.prev_event_plus, p0, p0 >= 0)
                is_start = np.where(
                    e >= 0, scan.plus_start[np.clip(e, 0, n2 - 1)], False)
                good = (q >= 0) & is_start
                out_l[sel] = e + 1
                out_r[sel] = q + 3
                ok[sel] = good
            sel = np.flatnonzero(sel_c & (strands == 1) & length_ok)
            if len(sel):
                pos = _clamp_down_vec(lefts[sel] - 4, n2)
                q = lut(scan.prev_stop_minus, pos, pos >= 0)
                p0 = _clamp_up_vec(rights[sel] - 3)
                e = lut(scan.next_event_minus, p0, p0 < n2)
                is_start = np.where(
                    e >= 0, scan.minus_start[np.clip(e, 0, n2 - 1)], False)
                good = (q >= 0) & is_start
                out_l[sel] = q + 1
                out_r[sel] = e + 3
                ok[sel] = good
        return out_l, out_r, ok


def _clamp_down_vec(pos: np.ndarray, n2: int) -> np.ndarray:
    over = pos >= n2
    return np.where(over, pos - 3 * ((pos - (n2 - 1) + 2) // 3), pos)


def _clamp_up_vec(pos: np.ndarray) -> np.ndarray:
    under = pos < 0
    return np.where(under, pos + 3 * ((-pos + 2) // 3), pos)


_MISSING = object()
