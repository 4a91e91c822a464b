"""``build`` — build a discriminating-kmer database
(BuildKmerProcessor.java:57-225).

The options are the reference's (``kmers_anno_tpu/commands/build_cmd.py``)
plus ``--device``, the device of the torch group-bys, which run when the
C++ merge builder is unavailable.  ``--dna`` builds nucleotide kmers
(k 4..15, default 15) from the coding-strand CDS DNA of each peg.
"""

from __future__ import annotations

import argparse
import sys

from ..device import resolve_device
from ..engine.protein_kmers import set_drop_last
from ..engine.signature import build_signatures
from ..genome.gto import GenomeDirectory
from ..genome.roles import RoleMap
from ..utils.io import LineReader, read_set
from .base import BaseProcessor, ParseFailureException


class BuildKmerProcessor(BaseProcessor):

    HELP = "build a discriminating-kmer database for a specified list of roles"

    def add_options(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument(
            "-g", "--genomes", metavar="genomeFile.tbl", default=None,
            help="file of acceptable genome IDs (first column)")
        parser.add_argument(
            "-K", "--kmer", type=int, default=None, metavar="10",
            help="kmer length (default 8 for protein, 15 for --dna)")
        parser.add_argument(
            "--dna", action="store_true",
            help="build nucleotide kmers from coding-strand CDS DNA "
                 "instead of protein kmers (DNA mode)")
        parser.add_argument(
            "--weights", default="none",
            choices=["none", "uniform", "balance"],
            help="emit a per-kmer weight column for weighted voting: "
                 "uniform=1.0, balance=equal total mass per role "
                 "(default none: reference-exact table)")
        parser.add_argument(
            "-o", "--output", metavar="kmerdb.tbl", default=None,
            help="output file for the kmer database (default: stdout)")
        parser.add_argument(
            "--dropLast", action="store_true", dest="drop_last",
            help="drop the final kmer window of every protein (see "
                 "engine/protein_kmers.py)")
        parser.add_argument(
            "--device", default="cuda",
            help="torch device of the group-bys when the C++ builder is "
                 "unavailable: cuda (default), cuda:N or cpu")
        parser.add_argument("roleMapFile", metavar="roles.in.subsystems",
                            help="role definition file")
        parser.add_argument("roleIdFile", metavar="roles.to.use",
                            help="interesting role file")
        parser.add_argument("gtoDir", metavar="genomeDir",
                            help="input genome directory")

    def validate_parms(self) -> None:
        if self.drop_last:
            set_drop_last(True)
        self.alphabet = "dna" if self.dna else "prot"
        if self.kmer is None:
            self.kmer = 15 if self.dna else 8
        lo_k, hi_k = (4, 15) if self.dna else (3, 12)
        if self.kmer < lo_k or self.kmer > hi_k:
            raise ParseFailureException(
                f"kmer size {self.kmer} out of supported "
                f"{self.alphabet} range {lo_k}..{hi_k}")
        try:
            self.device = resolve_device(self.device)
        except RuntimeError as exc:     # the device does not exist here
            raise ParseFailureException(str(exc)) from exc
        self.require_file(self.roleMapFile, "Role definition file")
        self.require_file(self.roleIdFile, "Good-role file")
        self.require_dir(self.gtoDir, "Genome directory")
        self.genome_filter = None
        if self.genomes:
            self.require_file(self.genomes, "Good-genome file")
            self.genome_filter = read_set(self.genomes, "1")
        self.role_map = RoleMap.load(self.roleMapFile)
        # readSet over a headerless role list keeps the first column
        # (LineReader.readSet, BuildKmerProcessor.java:126)
        self.good_roles = LineReader.read_set(self.roleIdFile)

    def run_command(self) -> None:
        table = build_signatures(
            GenomeDirectory(self.gtoDir), self.role_map, self.good_roles,
            k=self.kmer, genome_filter=self.genome_filter,
            alphabet=self.alphabet, weight_mode=self.weights,
            device=self.device)
        table.save(self.output if self.output else sys.stdout)
