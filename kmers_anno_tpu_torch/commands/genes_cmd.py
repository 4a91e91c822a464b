"""``genes`` — copy aliases between same-function features of close genomes
(GeneCopyProcessor.java:43-168).

A copy of the reference package's ``commands/genes_cmd.py``.
"""

from __future__ import annotations

import argparse
import logging

from ..engine.protein_kmers import ProteinKmers
from ..genome.gto import Genome
from ..genome.roles import FunctionMap
from .base import BaseProcessor, ParseFailureException

log = logging.getLogger(__name__)


class GeneCopyProcessor(BaseProcessor):

    HELP = ("copy gene names from one genome to a close genome without "
            "gene names")

    def add_options(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument(
            "-m", "--maxDist", dest="max_dist", type=float, default=0.5,
            metavar="0.2",
            help="maximum permissible distance for a name transfer")
        parser.add_argument(
            "-K", "--kmer", "--kmerSize", dest="kmer_size", type=int,
            default=8, metavar="10",
            help="protein kmer size for distance computation")
        parser.add_argument("sourceFile", metavar="source.gto",
                            help="source genome file")
        parser.add_argument("targetFile", metavar="target.gto",
                            help="genome file to update")
        parser.add_argument("outputFile", metavar="output.gto",
                            help="output file for modified genome")

    def validate_parms(self) -> None:
        if not 0.0 <= self.max_dist <= 1.0:
            raise ParseFailureException(
                "Distance must be between 0 and 1.")
        if self.kmer_size < 2:
            raise ParseFailureException("Kmer size must be at least 2.")
        self.require_file(self.sourceFile, "Input genome file")
        self.require_file(self.targetFile, "Input genome file")
        self.source = Genome.load(self.sourceFile)
        self.target = Genome.load(self.targetFile)

    def run_command(self) -> None:
        fun_map = FunctionMap()
        fun_features: dict[str, list] = {}
        alias_map: dict[str, dict] = {}
        for feat in self.source.pegs:
            aliases = feat.alias_map
            if aliases:
                fun = fun_map.find_or_insert(feat.peg_function)
                fun_features.setdefault(fun.id, []).append(feat)
                alias_map[feat.id] = aliases
        log.info("%d features with aliases, %d functions found.",
                 len(alias_map), len(fun_features))
        updates = 0
        for feat in self.target.pegs:
            fun = fun_map.get_by_name(feat.peg_function)
            if fun is None:
                continue
            feats = fun_features.get(fun.id)
            if not feats:
                continue
            kmers = ProteinKmers(feat.protein_translation, self.kmer_size)
            found = None
            f_dist = self.max_dist
            for f2 in feats:
                d = kmers.distance(
                    ProteinKmers(f2.protein_translation, self.kmer_size))
                if d <= f_dist:
                    f_dist = d
                    found = f2
            if found is not None:
                for alias_type, values in alias_map[found.id].items():
                    for alias in values:
                        feat.add_alias(alias_type, alias)
                updates += 1
        log.info("Writing genome with %d updates to %s.", updates,
                 self.outputFile)
        self.target.save(self.outputFile)
