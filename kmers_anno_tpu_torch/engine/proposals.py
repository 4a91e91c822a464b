"""Peg proposals and the per-ORF proposal list (PegProposal.java:15-165,
PegProposalList.java:20-142).

Semantics preserved exactly (SURVEY.md §2c Q7):

* a proposal's identity is (contig, end, strand) — one proposal per ORF;
* ``create`` extends the location to a start/stop codon via
  ``Location.extend``, returning None when impossible;
* strength = evidence / extended length; filters run in the order
  invalid → weak (strength < min) → small (evidence < minEvidence);
* a duplicate ORF keeps the better proposal (more evidence, tie → longer)
  by merging: function/begin/evidence overwrite the stored proposal;
* iteration order is (contig, left edge, length) — the peg numbering order
  (PegProposal.compareTo, PegProposal.java:85-99).

Host NumPy: ``propose_batch`` and ``replay_stored`` of
``kmers_anno_tpu/engine/proposals.py`` copied as they are (that package's
``engine/__init__`` imports jax).  The one-at-a-time ``propose`` is a
batch of one here, with the same counters and results.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterator

import numpy as np

from ..genome.locations import Location
from ..ops.orf import OrfExtender

if TYPE_CHECKING:  # pragma: no cover
    from ..genome.gto import Genome


class PegProposal:
    """A proposed peg: extended location + function + evidence."""

    __slots__ = ("loc", "function", "evidence")

    def __init__(self, loc: Location, function: str, evidence: int):
        self.loc = loc
        self.function = function
        self.evidence = evidence

    @staticmethod
    def create(genome: "Genome", loc: Location, function: str,
               evidence: int) -> "PegProposal | None":
        real = loc.extend(genome)
        if real is None:
            return None
        return PegProposal(real, function, evidence)

    @property
    def strength(self) -> float:
        return self.evidence / self.loc.length

    def better_than(self, other: "PegProposal") -> bool:
        if self.evidence > other.evidence:
            return True
        return (self.evidence == other.evidence
                and self.loc.length > other.loc.length)

    def merge(self, other: "PegProposal") -> None:
        """Overwrite with the better proposal's data; the ORF end stays."""
        self.function = other.function
        self.loc.set_begin(other.loc.begin)
        self.evidence = other.evidence

    def orf_key(self) -> tuple:
        return (self.loc.contig_id, self.loc.end, self.loc.strand)

    def sort_key(self) -> tuple:
        return (self.loc.contig_id, self.loc.left, self.loc.length)

    def __repr__(self) -> str:
        return (f"PegProposal({self.loc}, {self.function!r}, "
                f"evidence={self.evidence})")


class PegProposalList:
    """One proposal per ORF, strongest wins; iterates in numbering order."""

    def __init__(self, genome: "Genome", min_strength: float,
                 min_evidence: int):
        self.genome = genome
        self.min_strength = min_strength
        self.min_evidence = min_evidence
        self.made = 0
        self.rejected = 0
        self.weak = 0
        self.small = 0
        self.merged = 0
        self._by_orf: dict[tuple, PegProposal] = {}
        self._extender = None

    def propose(self, loc: Location, function: str,
                evidence: int) -> PegProposal | None:
        """Propose one candidate: the stored proposal when it was inserted
        or won a merge, else None."""
        stored = self.propose_batch(
            np.zeros(1, np.int64), [loc.contig_id],
            np.array([0 if loc.strand == "+" else 1]), np.array([loc.left]),
            np.array([loc.right]), np.array([evidence]),
            np.zeros(1, np.int64), [function])
        return stored[0][1] if stored else None

    def propose_batch(self, contig_idx: np.ndarray, contig_ids: list,
                      strands: np.ndarray, lefts: np.ndarray,
                      rights: np.ndarray, evidence: np.ndarray,
                      func_idx: np.ndarray, functions: list[str]
                      ) -> list[tuple[int, "PegProposal"]]:
        """Propose every candidate of the arrays, in candidate order.

        Counter-identical and result-identical to the reference's scalar
        ``propose`` called element by element: extension, the
        invalid→weak→small filter order, ORF dedup with better_than
        merging against both in-batch predecessors AND incumbents from
        earlier batches, and the ``merged`` running-improvement count all
        reproduce the sequential semantics — but as array passes (one
        extend_batch + one lexsort + one segmented running max).

        contig_idx: (m,) int — index into contig_ids
        strands:    (m,) int — 0='+', 1='-'
        lefts/rights/evidence: (m,) int
        func_idx:   (m,) int — index into functions
        returns [(candidate_index, stored_proposal), …] — one entry per
        candidate that was stored (inserted or won a merge), matching the
        sequence of non-None ``propose`` returns (for --trace parity).
        """
        m = len(lefts)
        self.made += m
        if m == 0:
            return []
        if self._extender is None:
            self._extender = OrfExtender(self.genome)
        ext_l, ext_r, ok = self._extender.extend_batch(
            contig_idx, contig_ids, strands, lefts, rights)
        self.rejected += int((~ok).sum())
        length = ext_r - ext_l + 1
        evidence = np.asarray(evidence, np.int64)
        # float semantics must match scalar propose exactly: ev/len < s
        with np.errstate(divide="ignore", invalid="ignore"):
            weak = ok & (evidence / length < self.min_strength)
        self.weak += int(weak.sum())
        small = ok & ~weak & (evidence < self.min_evidence)
        self.small += int(small.sum())
        live = np.flatnonzero(ok & ~weak & ~small)
        if not len(live):
            return []

        # ---- ORF dedup: one proposal per (contig, end, strand) ----
        l_c = np.asarray(contig_idx)[live]
        l_s = np.asarray(strands)[live]
        l_end = np.where(l_s == 0, ext_r[live], ext_l[live])
        order = np.lexsort((l_s, l_end, l_c))      # stable: ties stay in
        g_c, g_e, g_s = l_c[order], l_end[order], l_s[order]  # cand order
        first = np.ones(len(order), bool)
        first[1:] = ((g_c[1:] != g_c[:-1]) | (g_e[1:] != g_e[:-1])
                     | (g_s[1:] != g_s[:-1]))
        group_id = np.cumsum(first) - 1
        n_groups = int(group_id[-1]) + 1
        group_starts = np.flatnonzero(first)

        # better_than is lexicographic on (evidence, length), strict;
        # rank-compress packed scores so a segmented running max fits int64
        packed = (evidence[live][order] << np.int64(32)) | length[live][order]
        # incumbents from earlier batches participate as the initial max
        inc: list[PegProposal | None] = []
        for gs in group_starts:
            key = (contig_ids[g_c[gs]], int(g_e[gs]),
                   "+" if g_s[gs] == 0 else "-")
            inc.append(self._by_orf.get(key))
        inc_packed = np.array(
            [(-1 if p is None else
              (np.int64(p.evidence) << np.int64(32)) | p.loc.length)
             for p in inc], np.int64)
        ranks = np.unique(np.concatenate([packed, inc_packed]),
                          return_inverse=True)[1]
        rank = ranks[: len(packed)].astype(np.int64)
        inc_rank = np.where(inc_packed < 0, np.int64(-1),
                            ranks[len(packed):]).astype(np.int64)
        base = group_id * (int(ranks.max()) + 2)
        cummax = np.maximum.accumulate(base + rank)
        prev = np.concatenate([[np.int64(-1)], cummax[:-1]])
        prev_rank = np.where(prev >= base, prev - base, np.int64(-1))
        eff_prev = np.maximum(prev_rank, inc_rank[group_id])
        stored = rank > eff_prev                       # insert or improve
        self.merged += int((stored & (eff_prev >= 0)).sum())

        # apply stores sequentially per group (few, dict ops only), in
        # candidate order so the returned list matches scalar propose
        out: list[tuple[int, PegProposal]] = []
        store_pos = np.flatnonzero(stored)
        for sp in store_pos:
            ci = live[order[sp]]
            g = group_id[sp]
            loc = Location(contig_ids[g_c[sp]],
                           "+" if g_s[sp] == 0 else "-",
                           int(ext_l[ci]), int(ext_r[ci]))
            new = PegProposal(loc, functions[func_idx[ci]],
                              int(evidence[ci]))
            old = inc[g]
            if old is None:
                self._by_orf[new.orf_key()] = new
                inc[g] = new
            else:
                old.merge(new)
                new = old
            out.append((int(ci), new))
        out.sort(key=lambda t: t[0])
        return out

    def replay_stored(self, rows: np.ndarray, contig_ids: list,
                      functions: list[str], made: int, rejected: int,
                      weak: int, small: int
                      ) -> list[tuple[int, "PegProposal"]]:
        """Apply DEVICE-decided stored events (the fused projection
        route, engine/projection._scan_genome).

        The device replicates propose_batch's whole decision chain —
        extension, float64-exact weak/small filters, Q7 dedup against
        both in-batch predecessors and cross-genome incumbents (carried
        from genome to genome) — and emits only the events that insert or
        win a merge, in candidate order.  This applies them to the dict:
        every row whose ORF key is already present is by construction a
        winning merge (the device's eff-prev test saw the same
        incumbent), so counters reproduce the sequential semantics.

        rows: (n, 8) int — [contig, strand, ext_l, ext_r, evidence,
              func_idx, left, best_edge]
        returns [(row_index, stored_proposal), …] for --trace parity.
        """
        self.made += made
        self.rejected += rejected
        self.weak += weak
        self.small += small
        out = []
        for i, (c, s, el, er, ev, fx, _l, _b) in enumerate(rows):
            loc = Location(contig_ids[int(c)], "+" if s == 0 else "-",
                           int(el), int(er))
            key = (loc.contig_id, loc.end, loc.strand)
            old = self._by_orf.get(key)
            new = PegProposal(loc, functions[int(fx)], int(ev))
            if old is None:
                self._by_orf[key] = new
                out.append((i, new))
            else:
                old.merge(new)
                self.merged += 1
                out.append((i, old))
        return out

    @property
    def count(self) -> int:
        return len(self._by_orf)

    def __iter__(self) -> Iterator[PegProposal]:
        return iter(sorted(self._by_orf.values(),
                           key=PegProposal.sort_key))
