"""Location coordinate math (contract of the reference tool's external
shared jar; a copy of the reference package's ``genome/locations.py``,
holding what the port uses).

* ``Location(contig, strand, left, right)`` takes genome-coordinate left
  and right regardless of strand (AppTest.java:79-88: a '-' location
  created with (100, 124) has left==100 and end==100).
* begin/end are strand-relative: '+' begin=left end=right; '-' begin=right
  end=left.

ORF extension (``Location.extend`` in the reference) is
``ops.orf.OrfExtender`` here, which the tests hold to the reference's
scalar walker.
"""

from __future__ import annotations

from dataclasses import dataclass

from .dna import reverse_complement


@dataclass
class Location:
    """A contiguous stranded region of a contig, 1-based inclusive."""

    contig_id: str
    strand: str  # '+' or '-'
    left: int
    right: int

    @property
    def length(self) -> int:
        return self.right - self.left + 1

    @property
    def begin(self) -> int:
        return self.left if self.strand == "+" else self.right

    @property
    def end(self) -> int:
        return self.right if self.strand == "+" else self.left

    def set_begin(self, begin: int) -> None:
        """Move the strand-relative begin (PegProposal.merge semantics)."""
        if self.strand == "+":
            self.left = begin
        else:
            self.right = begin

    def __str__(self) -> str:
        return f"{self.contig_id}{self.strand}[{self.left}..{self.right}]"

    def dna(self, contig_seq: str) -> str:
        """Region sequence in reading direction given the contig sequence."""
        seg = contig_seq[self.left - 1: self.right]
        return reverse_complement(seg) if self.strand == "-" else seg
