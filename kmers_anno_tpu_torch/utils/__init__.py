"""Host utilities: counting maps, tabular and FASTA I/O, prefetching
(copies of the reference package's ``utils/`` modules)."""

from .counters import CountMap, QualityCountMap
from .io import (TabbedLineReader, LineReader, FastaReader, FastaWriter,
                 Sequence, read_set)

__all__ = [
    "CountMap", "QualityCountMap",
    "TabbedLineReader", "LineReader", "FastaReader", "FastaWriter",
    "Sequence", "read_set",
]
