"""Reporters for the ``apply`` command (ApplyKmerReporter.java:21-126,
DefaultApplyKmerReporter.java, VerifyApplyKmerReporter.java).  A copy of
the reference package's ``reports/apply_reports.py``.

Two formats selected by a strategy enum, exactly as in the reference:

* APPLY ("TRAIN" format) — one row per genome: ``genome_id`` followed by
  the per-role **called-feature counts** in roles.to.use column order; no
  header row (DefaultApplyKmerReporter.java:33-56).
* VERIFY — header ``genome_id peg_id role hits function`` then one row per
  called feature (VerifyApplyKmerReporter.java:33-45).
"""

from __future__ import annotations

from typing import IO

from ..genome.gto import Feature, Genome


class ApplyKmerReporter:
    """Abstract apply reporter with the role→column-index map
    (ApplyKmerReporter.java:43-54)."""

    TYPES: dict[str, type] = {}

    def __init__(self, output: IO):
        self.output = output
        self._role_idx: dict[str, int] = {}

    @classmethod
    def create(cls, fmt: str, output: IO) -> "ApplyKmerReporter":
        """Factory keyed by format name (Type.create,
        ApplyKmerReporter.java:107-125)."""
        try:
            return cls.TYPES[fmt.upper()](output)
        except KeyError:
            raise ValueError(f"unknown apply report format {fmt!r}")

    def init_report(self, roles_to_use: str) -> None:
        """Read the interesting-role file: role IDs in order in column 1
        become output column indices 1..N."""
        idx = 1
        with open(roles_to_use, "r") as fh:
            for line in fh:
                line = line.rstrip("\r\n")
                if line:
                    self._role_idx[line.split("\t")[0]] = idx
                    idx += 1
        self.open_report()

    def get_role_idx(self, role_id: str) -> int:
        """Column index of a role, or 0 when uninteresting."""
        return self._role_idx.get(role_id, 0)

    @property
    def num_roles(self) -> int:
        return len(self._role_idx)

    def print(self, line: str) -> None:
        self.output.write(line + "\n")

    # lifecycle hooks
    def open_report(self) -> None: ...
    def open_genome(self, genome: Genome) -> None: ...
    def record_feature(self, feat: Feature, role: str, count: int) -> None: ...
    def close_genome(self) -> None: ...
    def close_report(self) -> None: ...


class DefaultApplyKmerReporter(ApplyKmerReporter):
    """TRAIN format: per-genome per-role called-feature counts."""

    def open_report(self) -> None:
        self._counts = [0] * self.num_roles
        self._genome_id = ""

    def open_genome(self, genome: Genome) -> None:
        self._genome_id = genome.id
        self._counts = [0] * self.num_roles

    def record_feature(self, feat: Feature, role: str, count: int) -> None:
        idx = self.get_role_idx(role)
        if idx > 0:
            self._counts[idx - 1] += 1

    def close_genome(self) -> None:
        counts = "\t".join(str(c) for c in self._counts)
        self.print(f"{self._genome_id}\t{counts}")


class VerifyApplyKmerReporter(ApplyKmerReporter):
    """One row per called feature with its current function."""

    def open_report(self) -> None:
        self._genome_id = ""
        self.print("genome_id\tpeg_id\trole\thits\tfunction")

    def open_genome(self, genome: Genome) -> None:
        self._genome_id = genome.id

    def record_feature(self, feat: Feature, role: str, count: int) -> None:
        self.print(f"{self._genome_id}\t{feat.id}\t{role}\t{count}\t"
                   f"{feat.function}")


ApplyKmerReporter.TYPES.update(
    APPLY=DefaultApplyKmerReporter, VERIFY=VerifyApplyKmerReporter)
