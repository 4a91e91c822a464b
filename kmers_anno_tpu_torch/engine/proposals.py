"""Peg proposals and the per-ORF proposal list (PegProposal.java:15-165,
PegProposalList.java:20-142).

Semantics preserved exactly (SURVEY.md §2c Q7):

* a proposal's identity is (contig, end, strand) — one proposal per ORF;
* a candidate location is extended to a start/stop codon
  (``ops.orf.OrfExtender``), and is rejected when that is impossible;
* strength = evidence / extended length; filters run in the order
  invalid → weak (strength < min) → small (evidence < minEvidence);
* a duplicate ORF keeps the better proposal (more evidence, tie → longer)
  by merging: function/begin/evidence overwrite the stored proposal;
* iteration order is (contig, left edge, length) — the peg numbering order
  (PegProposal.compareTo, PegProposal.java:85-99).

Host NumPy, the batch path of ``kmers_anno_tpu/engine/proposals.py``
copied as it is (that package's ``engine/__init__`` imports jax).  The
reference's scalar ``propose`` and the fused branch's ``replay_stored``
are not copied: no ported path calls them.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterator

import numpy as np

from ..host import Location, OrfExtender

if TYPE_CHECKING:  # pragma: no cover
    from ..host import Genome


class PegProposal:
    """A proposed peg: extended location + function + evidence."""

    __slots__ = ("loc", "function", "evidence")

    def __init__(self, loc: Location, function: str, evidence: int):
        self.loc = loc
        self.function = function
        self.evidence = evidence

    @property
    def strength(self) -> float:
        return self.evidence / self.loc.length

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

    @property
    def count(self) -> int:
        return len(self._by_orf)

    def __iter__(self) -> Iterator[PegProposal]:
        return iter(sorted(self._by_orf.values(),
                           key=PegProposal.sort_key))
