"""Annotation records from ``*.anno.tbl`` files (Annotation.java:26-220).
A copy of the reference package's ``engine/annotation.py``.

* equality/hash on the (old, new) annotation string pair only;
* ``is_null`` ⇔ score NaN or 0.0 (an empty score field parses to NaN);
* directory scanner keyed by the ``(\\d+\\.\\d+)\\.anno\\.tbl`` pattern;
* ``OUTPUT_HEADER``: the header of the hash annotator's output files.
"""

from __future__ import annotations

import math
import os
import re
from typing import Iterator

from ..utils.io import TabbedLineReader

ANNO_FILE_RE = re.compile(r"(\d+\.\d+)\.anno\.tbl")
OUTPUT_HEADER = "fid\tscore\tnew_annotation\told_annotation"


class Annotation:
    """One row of an anno.tbl file: fid, score, old, new."""

    __slots__ = ("fid", "score", "old_annotation", "new_annotation")

    def __init__(self, fid: str, score: float, old_anno: str,
                 new_anno: str):
        self.fid = fid
        self.score = score
        self.old_annotation = old_anno
        self.new_annotation = new_anno

    @property
    def is_good(self) -> bool:
        return self.new_annotation == self.old_annotation

    @property
    def is_hypothetical(self) -> bool:
        return self.new_annotation == "hypothetical protein"

    @property
    def is_null(self) -> bool:
        return math.isnan(self.score) or self.score == 0.0

    def key(self) -> tuple:
        """Identity = (old, new) strings only (Annotation.java:189-218)."""
        return (self.old_annotation, self.new_annotation)

    def __eq__(self, other) -> bool:
        return isinstance(other, Annotation) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())


def iter_annotations(reader: TabbedLineReader) -> Iterator[Annotation]:
    """Annotation.Iter: header-indexed fid/score/new/old columns."""
    fid_i = reader.find_field("fid")
    score_i = reader.find_field("score")
    new_i = reader.find_field("new_annotation")
    old_i = reader.find_field("old_annotation")
    for line in reader:
        raw = line.get(score_i)
        try:
            score = float(raw) if raw else math.nan
        except ValueError:
            score = math.nan
        yield Annotation(line.get(fid_i), score, line.get(old_i),
                         line.get(new_i))


def get_anno_map(anno_dir: str) -> dict[str, str]:
    """genome ID → annotation file path, sorted by genome ID
    (Annotation.getAnnoMap uses a TreeMap)."""
    if not os.path.isdir(anno_dir):
        raise FileNotFoundError(
            f"Annotation directory {anno_dir} is not found or invalid.")
    out: dict[str, str] = {}
    for name in sorted(os.listdir(anno_dir)):
        m = ANNO_FILE_RE.fullmatch(name)
        if m:
            out[m.group(1)] = os.path.join(anno_dir, name)
    return dict(sorted(out.items()))
