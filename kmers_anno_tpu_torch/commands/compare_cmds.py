"""``compare`` / ``funMap`` — verification comparisons against
sequence-identical reference genomes (GenomeCompareProcessor.java:43-146,
FunctionCompareProcessor.java:37-143, BaseCompareProcessor.java:28-95).

A copy of the reference package's ``commands/compare_cmds.py``.
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..genome.compare import (CompareFunctions, create_matcher,
                              md5_genome_map)
from ..genome.gto import Genome, GenomeDirectory
from ..genome.roles import RoleMap
from .base import BaseProcessor

log = logging.getLogger(__name__)


class BaseCompareProcessorMixin(BaseProcessor):
    """Shared MD5 pairing of new genomes to old ones."""

    def add_options(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument("oldDir", metavar="refDir",
                            help="reference-genome directory")
        self.add_sub_options(parser)
        parser.add_argument(
            "-o", "--output", default=None,
            help="report output file (default: stdout)")

    def add_sub_options(self, parser: argparse.ArgumentParser) -> None:
        ...

    def validate_parms(self) -> None:
        self.require_dir(self.oldDir, "Reference genome directory")
        self.validate_sub_parms()
        log.info("Scanning old-genome directory %s.", self.oldDir)
        self.md5_map = md5_genome_map(self.oldDir)
        log.info("%d genomes found in %s.", len(self.md5_map), self.oldDir)

    def validate_sub_parms(self) -> None:
        ...

    def find_old_genome(self, genome: Genome) -> str | None:
        """Old-genome file path for a sequence-identical new genome."""
        return self.md5_map.get(genome.md5)

    def open_out(self):
        return open(self.output, "w") if self.output else sys.stdout

    def close_out(self, out) -> None:
        if self.output:
            out.close()


class GenomeCompareProcessor(BaseCompareProcessorMixin):

    HELP = "compare functional assignments between new and old genomes"

    def add_sub_options(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument("-t", "--type", default="FUNCTIONS",
                            choices=["FUNCTIONS", "SUBSYSTEMS"],
                            help="type of comparison to perform")
        parser.add_argument("newDirs", metavar="newDir", nargs="+",
                            help="directory of new (modified) genomes")

    def validate_sub_parms(self) -> None:
        self.engine = create_matcher(self.type)
        for new_dir in self.newDirs:
            self.require_dir(new_dir, "New-genome directory")

    def run_command(self) -> None:
        import os
        n_dirs = len(self.newDirs)
        match_map: dict[str, list] = {}
        good = [0] * n_dirs
        bad = [0] * n_dirs
        for i_dir, new_dir in enumerate(self.newDirs):
            log.info("Processing input directory %s.", new_dir)
            for genome in GenomeDirectory(new_dir):
                old_file = self.find_old_genome(genome)
                if old_file is None:
                    log.warning("No reference match for %s-- skipping.",
                                genome)
                    continue
                old_genome = Genome.load(old_file)
                log.info("Comparing %s to %s.", genome, old_genome)
                # old genome goes first (GenomeCompareProcessor.java:114)
                if not self.engine.compare(old_genome, genome):
                    log.error("Contig IDs in %s are invalid.  Comparison "
                              "aborted.", genome)
                    continue
                row = match_map.setdefault(old_genome.id, [None] * n_dirs)
                row[i_dir] = "%8.4f" % self.engine.percent()
                good[i_dir] += self.engine.good
                bad[i_dir] += self.engine.bad
        out = self.open_out()
        try:
            names = [os.path.basename(os.path.normpath(d))
                     for d in self.newDirs]
            out.write("reference\t" + "\t".join(names) + "\n")
            for ref_id in sorted(match_map):
                row = ["" if x is None else x for x in match_map[ref_id]]
                out.write(ref_id + "\t" + "\t".join(row) + "\n")
            out.write("\n")
            totals = []
            for i in range(n_dirs):
                if good[i] > 0:
                    pct = good[i] * 100.0 / (good[i] + bad[i])
                    totals.append("%8.4f" % pct)
                else:
                    totals.append("")
            out.write("TOTAL\t" + "\t".join(totals) + "\n")
        finally:
            self.close_out(out)


class FunctionCompareProcessor(BaseCompareProcessorMixin):

    HELP = ("map functions between genomes annotated using an old system "
            "and newly-annotated genomes")

    def add_sub_options(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument("--roles", dest="roles_needed", default=None,
                            metavar="roles.needed",
                            help="important-role definition file")
        parser.add_argument("newDir", metavar="newDir",
                            help="new-genome directory")

    def validate_sub_parms(self) -> None:
        self.role_map = None
        if self.roles_needed:
            self.require_file(self.roles_needed, "Role file")
            self.role_map = RoleMap.load(self.roles_needed)
        self.engine = CompareFunctions()
        self.require_dir(self.newDir, "New-genome directory")

    def run_command(self) -> None:
        log.info("Scanning new-genome directory %s.", self.newDir)
        for genome in GenomeDirectory(self.newDir):
            old_file = self.find_old_genome(genome)
            if old_file is None:
                log.info("Skipping %s.", genome)
                continue
            old_genome = Genome.load(old_file)
            # the NEW genome goes first here (FunctionCompareProcessor
            # .java:103): the report maps new-dir functions to old-dir ones
            if not self.engine.compare(genome, old_genome):
                log.warning("Contig IDs are invalid, comparison for %s "
                            "and %s aborted.", genome, old_genome)
        out = self.open_out()
        try:
            header = "old_function\tnew_function\tcount\tpercent"
            if self.role_map is not None:
                header += "\tneeded"
            out.write(header + "\n")
            for old_fun in self.engine.miss_functions():
                fun_id = old_fun.id
                total = float(self.engine.get_total_count(fun_id))
                matches = self.engine.get_match_count(fun_id)
                out.write("%s\t%s\t%d\t%8.2f\n"
                          % (old_fun.name, "", matches,
                             matches * 100 / total))
                miss = self.engine.get_miss_counts(fun_id)
                for new_fun, count in sorted(miss.items(),
                                             key=lambda kv: -kv[1]):
                    new_name = self.engine.get_name(new_fun)
                    if not new_name:
                        new_name = "(empty string)"
                    line = ("%s\t%s\t%d\t%8.2f"
                            % (old_fun.name, new_name, count,
                               count * 100 / total))
                    if self.role_map is not None:
                        roles = self.role_map.useful_roles(new_name)
                        line += "\tY" if roles else "\t"
                    out.write(line + "\n")
        finally:
            self.close_out(out)
