"""Annotation-comparison reporters (AnnotationReporter.java:17-148,
FullCompareAnnotationReporter.java, NewRoleAnnotationReporter.java).

A copy of the reference package's ``reports/annotation_reports.py``.

Strategy-enum factory with two formats:

* FULL — every feature pair, 11 columns including old/new subsystem
  name + up to 3 classification levels; one row per paired subsystem row
  (FullCompareAnnotationReporter.java:29-68).
* NEW_ROLES — only rows where the old annotation is exactly
  "hypothetical protein" and the annotation changed
  (NewRoleAnnotationReporter.java:35-60).
"""

from __future__ import annotations

import logging
from typing import IO

from ..genome.gto import Feature, SubsystemRow

log = logging.getLogger(__name__)


class AnnotationReporter:
    """Base annotation reporter: header/data tab-writer with width check
    (AnnotationReporter.java:79-114)."""

    TYPES: dict[str, type] = {}

    def __init__(self) -> None:
        self.writer: IO | None = None
        self.counter = 0
        self.width = 0

    @classmethod
    def create(cls, fmt: str) -> "AnnotationReporter":
        try:
            return cls.TYPES[fmt.upper()]()
        except KeyError:
            raise ValueError(f"unknown annotation report format {fmt!r}")

    def write_header(self, *fields: str) -> None:
        self.writer.write("\t".join(fields) + "\n")
        self.width = len(fields)

    def write_data(self, *fields) -> None:
        """Write exactly ``width`` tab-separated fields; missing/None → ''."""
        row = []
        for i in range(self.width):
            val = fields[i] if i < len(fields) else None
            row.append("" if val is None else str(val))
        self.writer.write("\t".join(row) + "\n")
        self.counter += 1

    def start_report(self, processor, writer: IO) -> None:
        self.writer = writer
        self.start(processor)
        if self.width == 0:
            raise RuntimeError(
                "AnnotationReporter subclass did not write a header")

    def finish_report(self) -> None:
        self.finish()
        log.info("%d lines written to report.", self.counter)

    # subclass hooks
    def start(self, processor) -> None: ...
    def process_feature(self, old_feat: Feature, new_feat: Feature) -> None: ...
    def finish(self) -> None: ...


def _sub_data(row: SubsystemRow) -> list:
    """Subsystem name + up to 3 classification levels
    (FullCompareAnnotationReporter.fillSubData)."""
    out = [row.name, None, None, None]
    for j, cls in enumerate(row.classifications[:3]):
        out[1 + j] = cls
    return out


class FullCompareAnnotationReporter(AnnotationReporter):
    """Every feature pair with old/new annotation and subsystem data."""

    def start(self, processor) -> None:
        self.write_header(
            "fid", "old_annotation", "old_subsystem", "old_subclass1",
            "old_subclass2", "old_subclass3", "new_annotation",
            "new_subsystem", "new_subclass1", "new_subclass2",
            "new_subclass3")

    def process_feature(self, old_feat: Feature, new_feat: Feature) -> None:
        fid = old_feat.id
        old_anno = old_feat.peg_function
        new_anno = new_feat.peg_function
        old_subs = old_feat.subsystem_rows
        new_subs = new_feat.subsystem_rows
        if not old_subs and not new_subs:
            self.write_data(fid, old_anno, None, None, None, None,
                            new_anno, None, None, None, None)
        else:
            # Dual-iterator pairing, FullCompareAnnotationReporter.java:
            # 50-68: the while loop requires BOTH iterators non-empty, so
            # one-sided subsystem data produces no rows at all.
            for old_row, new_row in zip(old_subs, new_subs):
                self.write_data(fid, old_anno, *_sub_data(old_row),
                                new_anno, *_sub_data(new_row))


class NewRoleAnnotationReporter(AnnotationReporter):
    """Only features whose old annotation was hypothetical and changed."""

    def start(self, processor) -> None:
        self.write_header(
            "fid", "old_annotation", "new_annotation", "new_subsystem",
            "new_subclass1", "new_subclass2", "new_subclass3")

    def process_feature(self, old_feat: Feature, new_feat: Feature) -> None:
        old_anno = old_feat.peg_function
        new_anno = new_feat.peg_function
        if old_anno != "hypothetical protein" or old_anno == new_anno:
            return
        new_subs = new_feat.subsystem_rows
        if not new_subs:
            self.write_data(old_feat.id, old_anno, new_anno,
                            None, None, None, None)
        else:
            for row in new_subs:
                self.write_data(old_feat.id, old_anno, new_anno,
                                *_sub_data(row))


AnnotationReporter.TYPES.update(
    FULL=FullCompareAnnotationReporter, NEW_ROLES=NewRoleAnnotationReporter)
