"""``seqCheck`` — flag proteins annotated inconsistently across genomes
(SequenceCheckProcessor.java:44-137).

A copy of the reference package's ``commands/seq_check_cmd.py``.
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..genome.gto import GenomeDirectory, protein_md5
from ..genome.roles import FunctionMap, RoleMap
from .base import BaseProcessor

log = logging.getLogger(__name__)


class SequenceCheckProcessor(BaseProcessor):

    HELP = "verify that proteins in genomes are consistently annotated"

    def add_options(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument(
            "--roles", dest="role_file", metavar="roles.in.subsystems",
            default=None,
            help="role definition file containing interesting roles")
        parser.add_argument(
            "-o", "--output", default=None,
            help="report output file (default: stdout)")
        parser.add_argument("inDir", metavar="inDir",
                            help="input GTO directory")

    def validate_parms(self) -> None:
        self.require_dir(self.inDir, "Input directory")
        if self.role_file:
            self.require_file(self.role_file, "Role definition file")
            self.role_map = RoleMap.load(self.role_file)
        else:
            self.role_map = RoleMap()

    def run_command(self) -> None:
        out = open(self.output, "w") if self.output else sys.stdout
        try:
            # protein MD5 → list of (fid, peg_function, interesting)
            protein_map: dict[str, list] = {}
            genomes = GenomeDirectory(self.inDir)
            for genome in genomes:
                log.info("Scanning %s.", genome)
                for feat in genome.pegs:
                    seq = feat.protein_translation
                    if seq:
                        protein_map.setdefault(protein_md5(seq), []).append(
                            (feat.id, feat.peg_function,
                             feat.is_interesting(self.role_map)))
            out.write("num\tfid\tfunction\tinteresting\n")
            fun_map = FunctionMap()
            bad_count = 0
            prot_count = 0
            for flist in protein_map.values():
                if len(flist) < 2:
                    continue
                prot_count += 1
                fun_ids = {fun_map.find_or_insert(fn).id
                           for _, fn, _ in flist}
                if len(fun_ids) > 1:
                    bad_count += 1
                    for fid, fn, interesting in flist:
                        flag = "*" if interesting else ""
                        out.write(f"{bad_count:8d}\t{fid}\t{fn}\t{flag}\n")
                    out.write("\n")
            log.info("%d inconsistent proteins found.  %d proteins "
                     "occurred multiple times.", bad_count, prot_count)
        finally:
            if self.output:
                out.close()
