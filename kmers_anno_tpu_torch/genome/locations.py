"""Location / Frame coordinate math (contract of the reference tool's
external shared jar; a copy of the reference package's
``genome/locations.py``).

* ``Location(contig, strand, left, right)`` takes genome-coordinate left
  and right regardless of strand (AppTest.java:79-88: a '-' location
  created with (100, 124) has left==100 and end==100).
* begin/end are strand-relative: '+' begin=left end=right; '-' begin=right
  end=left.

* ``extend(genome)`` grows the region to a start codon upstream and a stop
  codon downstream, returning None on failure (PegProposal.java:50-58).
  The reference walks codon by codon; here it is one candidate of
  ``ops.orf.OrfExtender``, which the tests hold to that walker.

Frame bucketing: locations bucket by (strand, codon phase).  '+' locations
use left % 3, '-' locations use right % 3; either choice groups kmers that
were extracted from the same contig translation frame (KmerPosition.java:
60-62, 78-86) identically.  XX is the sentinel/invalid frame and sorts last
(FramedLocationLists.java:104: "the last map is ALWAYS empty").
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from enum import IntEnum
from typing import TYPE_CHECKING, Iterator

import numpy as np

from .dna import reverse_complement

if TYPE_CHECKING:  # pragma: no cover
    from .gto import Genome


class Frame(IntEnum):
    """Reading-frame identity of a location: strand plus codon phase."""

    M0 = 0
    M1 = 1
    M2 = 2
    P0 = 3
    P1 = 4
    P2 = 5
    XX = 6

    @property
    def idx(self) -> int:
        return int(self)


N_FRAMES = len(Frame)


@dataclass
class Location:
    """A contiguous stranded region of a contig, 1-based inclusive."""

    contig_id: str
    strand: str  # '+' or '-'
    left: int
    right: int

    @staticmethod
    def create(contig_id: str, strand: str, left: int,
               right: int) -> "Location":
        return Location(contig_id, strand, left, right)

    @property
    def length(self) -> int:
        return self.right - self.left + 1

    @property
    def begin(self) -> int:
        return self.left if self.strand == "+" else self.right

    @property
    def end(self) -> int:
        return self.right if self.strand == "+" else self.left

    @property
    def dir(self) -> str:
        return self.strand

    def set_begin(self, begin: int) -> None:
        """Move the strand-relative begin (PegProposal.merge semantics)."""
        if self.strand == "+":
            self.left = begin
        else:
            self.right = begin

    @property
    def frame(self) -> Frame:
        if self.strand == "+":
            return Frame(Frame.P0 + self.left % 3)
        if self.strand == "-":
            return Frame(Frame.M0 + self.right % 3)
        return Frame.XX

    def __str__(self) -> str:
        return f"{self.contig_id}{self.strand}[{self.left}..{self.right}]"

    def dna(self, contig_seq: str) -> str:
        """Region sequence in reading direction given the contig sequence."""
        seg = contig_seq[self.left - 1: self.right]
        return reverse_complement(seg) if self.strand == "-" else seg

    def extend(self, genome: "Genome") -> "Location | None":
        """Extend to a start codon upstream and a stop codon downstream;
        a new Location, or None when extension is impossible."""
        from ..ops.orf import OrfExtender

        ext_l, ext_r, ok = OrfExtender(genome).extend_batch(
            np.zeros(1, np.int64), [self.contig_id],
            np.array([0 if self.strand == "+" else 1]),
            np.array([self.left]), np.array([self.right]))
        if not ok[0]:
            return None
        return Location(self.contig_id, self.strand, int(ext_l[0]),
                        int(ext_r[0]))


@dataclass
class SortedLocationList:
    """List of locations kept sorted by (contig, left, right).

    Matches the external SortedLocationList contract: sorted insert,
    ``get(i)``, ``size``, and ``contig_range(i)`` — the locations after
    index i that share location i's contig (KmerProcessor.java:243; the
    window-scan evidence count starts at 1 *because it already includes the
    first location*, so the range excludes index i itself).
    """

    _locs: list[Location] = field(default_factory=list)
    _keys: list[tuple] = field(default_factory=list)

    def add(self, loc: Location) -> None:
        key = (loc.contig_id, loc.left, loc.right)
        i = bisect.bisect_right(self._keys, key)
        self._keys.insert(i, key)
        self._locs.insert(i, loc)

    def get(self, i: int) -> Location:
        return self._locs[i]

    def size(self) -> int:
        return len(self._locs)

    def __len__(self) -> int:
        return len(self._locs)

    def __iter__(self) -> Iterator[Location]:
        return iter(self._locs)

    def contig_range(self, i: int) -> Iterator[Location]:
        contig = self._locs[i].contig_id
        for j in range(i + 1, len(self._locs)):
            loc = self._locs[j]
            if loc.contig_id != contig:
                break
            yield loc


class FramedLocationLists:
    """Map of [frame][target] -> SortedLocationList (FramedLocationLists.java).

    ``connect(target, loc)`` buckets by ``loc.frame``; iteration yields
    (target_id, list) pairs frame by frame.  Unlike the Java original we
    iterate targets in insertion order (Java HashMap order is arbitrary), the
    accepted tie-break deviation.
    """

    def __init__(self) -> None:
        self._maps: list[dict[str, SortedLocationList]] = [
            {} for _ in range(N_FRAMES)]
        self._count = 0

    def connect(self, target: str, loc: Location) -> None:
        frame_map = self._maps[loc.frame.idx]
        lst = frame_map.get(target)
        if lst is None:
            lst = SortedLocationList()
            frame_map[target] = lst
        lst.add(loc)
        self._count += 1

    def clear(self) -> None:
        for m in self._maps:
            m.clear()
        self._count = 0

    def size(self) -> int:
        return self._count

    def __iter__(self) -> Iterator[tuple[str, SortedLocationList]]:
        for frame_map in self._maps:
            yield from frame_map.items()
