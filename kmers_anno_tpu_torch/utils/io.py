"""Tabular and FASTA I/O (contracts of the reference tool's external
TabbedLineReader / LineReader / FastaInputStream / FastaOutputStream).  A
copy of the reference package's ``utils/io.py``.

* ``TabbedLineReader(path)`` — header-indexed TSV with ``find_field`` by
  column name or 1-based index string (Annotation.java:131-134).
* ``TabbedLineReader(path, n)`` — headerless fixed-column mode
  (ApplyKmerProcessor.java:102).
* ``read_set(path, "1")`` — the set of values of a column
  (BuildKmerProcessor.java:117).
* FASTA streams of ``Sequence{label, comment, sequence}``
  (BuildKmerProcessor.java:160-162, 196-207).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import IO, Iterator

from .. import native


class LineReader:
    """Plain line reader, stripping line terminators."""

    def __init__(self, source: str | IO):
        self._own = isinstance(source, str)
        self._fh = open(source, "r") if self._own else source

    def __enter__(self) -> "LineReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._own:
            self._fh.close()

    def __iter__(self) -> Iterator[str]:
        for line in self._fh:
            yield line.rstrip("\r\n")

    @staticmethod
    def read_set(path: str) -> set[str]:
        """Set of whole lines (LineReader.readSet —
        BuildKmerProcessor.java:126).  Only the first tab-delimited field is
        kept so role lists with extra columns behave like the reference."""
        out = set()
        with open(path, "r") as fh:
            for line in fh:
                line = line.rstrip("\r\n")
                if line:
                    out.add(line.split("\t")[0])
        return out


class TabbedLine:
    """One data row of a tabbed file."""

    __slots__ = ("_fields",)

    def __init__(self, fields: list[str]):
        self._fields = fields

    def get(self, idx: int) -> str:
        return self._fields[idx] if idx < len(self._fields) else ""

    def get_int(self, idx: int) -> int:
        return int(self.get(idx))

    def get_float(self, idx: int) -> float:
        return float(self.get(idx))

    @property
    def fields(self) -> list[str]:
        return self._fields


class TabbedLineReader:
    """Header-indexed (or headerless fixed-column) TSV reader."""

    def __init__(self, source: str | IO, columns: int | None = None):
        self._own = isinstance(source, str)
        self._fh = open(source, "r") if self._own else source
        if columns is None:
            header = self._fh.readline().rstrip("\r\n")
            self.labels = header.split("\t") if header else []
        else:
            self.labels = [str(i + 1) for i in range(columns)]

    def find_field(self, name: str) -> int:
        """Column index for a header name; a numeric string is a 1-based
        column index (TabbedLineReader.findField contract)."""
        if name in self.labels:
            return self.labels.index(name)
        try:
            idx = int(name)
        except ValueError:
            raise KeyError(f"column {name!r} not found in {self.labels}")
        if 1 <= idx <= len(self.labels):
            return idx - 1
        raise KeyError(f"column index {name} out of range")

    def __iter__(self) -> Iterator[TabbedLine]:
        for line in self._fh:
            line = line.rstrip("\r\n")
            if line:
                yield TabbedLine(line.split("\t"))

    def __enter__(self) -> "TabbedLineReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._own:
            self._fh.close()


def read_set(path: str, column: str) -> set[str]:
    """Set of the values of one column of a tabbed file, header included
    as data when the column is numeric?  No: the reference's
    TabbedLineReader.readSet reads a headered file — we mirror that: the
    first row is the header unless the file has a single unnamed column
    layout.  For the common ``readSet(file, "1")`` call the first column of
    every data row is collected."""
    out = set()
    with open(path, "r") as fh:
        header = fh.readline()
        labels = header.rstrip("\r\n").split("\t")
        try:
            idx = int(column) - 1
        except ValueError:
            idx = labels.index(column)
        for line in fh:
            line = line.rstrip("\r\n")
            if line:
                fields = line.split("\t")
                if idx < len(fields):
                    out.add(fields[idx])
    return out


@dataclass
class Sequence:
    """A FASTA record: label, comment, sequence."""

    label: str
    comment: str
    sequence: str


class FastaReader:
    """Stream of Sequence records from a FASTA file or an open text file.

    A file path is parsed by the C++ loader (``native.read_fasta``) when
    the native library is available, as in the reference package; an open
    file, or a path without the native library, by the line parser.  The
    two agree on files whose headers hold one blank after the label and
    whose sequence lines hold no blanks, such as ``FastaWriter`` writes.
    """

    def __init__(self, source: str | IO):
        self._own = isinstance(source, str)
        self._path = source if self._own else None
        self._fh = None if self._own else source

    def __enter__(self) -> "FastaReader":
        return self

    def __exit__(self, *exc) -> None:
        if self._fh is not None and self._own:
            self._fh.close()

    def __iter__(self) -> Iterator[Sequence]:
        if self._own:
            records = native.read_fasta(self._path)
            if records is not None:
                for label, comment, seq in records:
                    yield Sequence(label, comment, seq)
                return
            self._fh = open(self._path, "r")
        yield from self._iter_lines()

    def _iter_lines(self) -> Iterator[Sequence]:
        label, comment, chunks = None, "", []
        for line in self._fh:
            line = line.rstrip("\r\n")
            if line.startswith(">"):
                if label is not None:
                    yield Sequence(label, comment, "".join(chunks))
                head = line[1:].split(None, 1)
                label = head[0] if head else ""
                comment = head[1] if len(head) > 1 else ""
                chunks = []
            elif line:
                chunks.append(line)
        if label is not None:
            yield Sequence(label, comment, "".join(chunks))


class FastaWriter:
    """Writer of Sequence records to a FASTA file."""

    def __init__(self, target: str | IO, width: int = 60):
        self._own = isinstance(target, str)
        self._fh = open(target, "w") if self._own else target
        self.width = width

    def __enter__(self) -> "FastaWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._own:
            self._fh.close()

    def write(self, seq: Sequence) -> None:
        header = f">{seq.label}"
        if seq.comment:
            header += f" {seq.comment}"
        self._fh.write(header + "\n")
        s = seq.sequence
        for i in range(0, len(s), self.width):
            self._fh.write(s[i:i + self.width] + "\n")
