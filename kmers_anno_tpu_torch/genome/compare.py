"""ORF-matched genome comparison engines (CompareFunctions.java:28-152,
CompareGenomes.java:19-94, CompareSubsystems.java:22-75, CompareType.java,
plus the reference tool's external CompareORFs/MatchGenomes contracts).

A copy of the reference package's ``genome/compare.py``.

CompareORFs walks feature pairs matched by ORF identity — the
(contig, end, strand) triple, the same key PegProposal uses (Q7) — calling
``both``/``old_only``/``new_only``.  MatchGenomes provides the
whole-genome-MD5 → file map used to pair sequence-identical genomes
(BaseCompareProcessor.java:55-69).
"""

from __future__ import annotations

import logging
import os

from .gto import Feature, Genome
from .roles import Function, FunctionMap

log = logging.getLogger(__name__)


def md5_genome_map(genome_dir: str) -> dict[str, str]:
    """Whole-genome-sequence MD5 → GTO file path (MatchGenomes
    .getMd5GenomeMap contract)."""
    out: dict[str, str] = {}
    for name in sorted(os.listdir(genome_dir)):
        if name.endswith(".gto"):
            path = os.path.join(genome_dir, name)
            out[Genome.load(path).md5] = path
    return out


def _orf_key(feat: Feature):
    loc = feat.location
    return (loc.contig_id, loc.end, loc.strand) if loc else None


class CompareORFs:
    """Template: walk ORF-matched peg pairs of two genomes."""

    def compare(self, left: Genome, right: Genome) -> bool:
        """Walk matched pairs; returns False when the genomes share no
        contig IDs (the 'contig IDs are invalid' failure,
        GenomeCompareProcessor.java:117 — inferred contract)."""
        left_contigs = {c.id for c in left.contigs}
        right_contigs = {c.id for c in right.contigs}
        if (left_contigs and right_contigs
                and not left_contigs & right_contigs):
            return False
        self.init_compare_data()
        right_by_orf = {}
        for feat in right.pegs:
            key = _orf_key(feat)
            if key is not None:
                right_by_orf[key] = feat
        matched = set()
        for feat in left.pegs:
            key = _orf_key(feat)
            other = right_by_orf.get(key) if key is not None else None
            if other is None:
                self.old_only(feat)
            else:
                matched.add(key)
                self.both(feat, other)
        for key, feat in right_by_orf.items():
            if key not in matched:
                self.new_only(feat)
        return True

    # subclass hooks
    def init_compare_data(self) -> None: ...
    def both(self, old_feat: Feature, new_feat: Feature) -> None: ...
    def old_only(self, old_feat: Feature) -> None: ...
    def new_only(self, new_feat: Feature) -> None: ...


class CompareFunctions(CompareORFs):
    """Annotation-drift tracker: identity matches vs per-function miss
    counts (CompareFunctions.java:53-150)."""

    def __init__(self) -> None:
        self.fun_map = FunctionMap()
        self._good: dict[str, int] = {}
        self._bad: dict[str, int] = {}
        self._miss: dict[str, dict[str, int]] = {}

    def _fid(self, function: str) -> str:
        return self.fun_map.find_or_insert(function or "").id

    def both(self, old_feat: Feature, new_feat: Feature) -> None:
        old_fun = self._fid(old_feat.function)
        new_fun = self._fid(new_feat.function)
        if old_fun == new_fun:
            self._good[old_fun] = self._good.get(old_fun, 0) + 1
        else:
            miss = self._miss.setdefault(old_fun, {})
            miss[new_fun] = miss.get(new_fun, 0) + 1
            self._bad[old_fun] = self._bad.get(old_fun, 0) + 1

    def get_miss_counts(self, fun_id: str) -> dict[str, int]:
        return self._miss.get(fun_id, {})

    def get_match_count(self, fun_id: str) -> int:
        return self._good.get(fun_id, 0)

    def get_total_count(self, fun_id: str) -> int:
        return self._good.get(fun_id, 0) + self._bad.get(fun_id, 0)

    def get_name(self, fun_id: str) -> str:
        return self.fun_map.get_name(fun_id)

    def miss_functions(self) -> list[Function]:
        """Functions with misses, sorted by ascending good count then
        name (CompareFunctions.FunctionCompare)."""
        funs = [self.fun_map.get_by_id(f) for f in self._miss]
        return sorted(funs,
                      key=lambda f: (self._good.get(f.id, 0), f.name))


class CompareGenomes(CompareORFs):
    """Good/bad functional-match counter (CompareGenomes.java:19-94)."""

    def __init__(self) -> None:
        self.fun_map = FunctionMap()
        self.good = 0
        self.bad = 0

    def init_compare_data(self) -> None:
        self.good = 0
        self.bad = 0

    def both(self, old_feat: Feature, new_feat: Feature) -> None:
        fun = self.fun_map.find_or_insert(old_feat.peg_function)
        other = self.fun_map.get_by_name(new_feat.peg_function)
        if other is not None and other.id == fun.id:
            self.good += 1
        else:
            self.bad += 1

    def percent(self) -> float:
        if self.good > 0:
            return self.good * 100.0 / (self.good + self.bad)
        return 0.0


class CompareSubsystems:
    """Good = new genome's subsystem name exists in the old genome
    (CompareSubsystems.java:40-75)."""

    def __init__(self) -> None:
        self.good = 0
        self.bad = 0

    def compare(self, new_genome: Genome, old_genome: Genome) -> bool:
        self.good = 0
        self.bad = 0
        old_subs = {s.name for s in old_genome.subsystems}
        for sub in new_genome.subsystems:
            if sub.name in old_subs:
                self.good += 1
            else:
                self.bad += 1
        return True

    def percent(self) -> float:
        if self.good > 0:
            return self.good * 100.0 / (self.good + self.bad)
        return 0.0


def create_matcher(type_name: str):
    """CompareType.create (CompareType.java:17-28)."""
    matchers = {"FUNCTIONS": CompareGenomes, "SUBSYSTEMS": CompareSubsystems}
    try:
        return matchers[type_name.upper()]()
    except KeyError:
        raise ValueError(f"unknown comparison type {type_name!r}")
