"""``buildGtos`` — build GTOs from PATRIC data plus calls/family files
(GtoBuildProcessor.java:53-274).

A copy of the reference package's ``commands/build_gtos_cmd.py``.
"""

from __future__ import annotations

import argparse
import logging
import os
import re

from ..genome.gto import Feature, Genome
from ..genome.sources import GenomeSource
from ..utils.io import TabbedLineReader
from .base import BaseMultiReportProcessor, ParseFailureException

log = logging.getLogger(__name__)

GENUS_ID_RE = re.compile(r"[1-9][0-9]*")


class GtoBuildProcessor(BaseMultiReportProcessor):

    HELP = "build GTOs from PATRIC data and annotation update files"

    def add_options(self, parser: argparse.ArgumentParser) -> None:
        super().add_options(parser)
        parser.add_argument("--type", "--source", "-t", dest="source_type",
                            default="PATRIC",
                            help="type of input genome source")
        parser.add_argument("genusId", metavar="genus_id",
                            help="numeric genus ID for the input genomes")
        parser.add_argument("inDir", metavar="inDir",
                            help="input directory for protein family / "
                                 "annotation files")
        parser.add_argument("genomeDir", metavar="genomeDir",
                            help="input genome source (file or directory)")

    def default_out_dir(self) -> str:
        return os.path.join(os.getcwd(), "gtos")

    def validate_parms(self) -> None:
        if not GENUS_ID_RE.fullmatch(self.genusId):
            raise ParseFailureException(
                f'Genus ID of "{self.genusId}" is not valid.')
        self.prefix = f"PLF_{self.genusId}_"
        self.require_dir(self.inDir, "Input directory")
        self.anno_file = os.path.join(self.inDir, "calls")
        self.family_file = os.path.join(self.inDir,
                                        "local.family.members.expanded")
        self.function_file = os.path.join(self.inDir, "local.family.defs")
        self.require_file(self.anno_file, "Annotation file")
        self.require_file(self.family_file, "Family list file")
        self.require_file(self.function_file, "Family definition file")
        self.genomes = GenomeSource.create(self.source_type, self.genomeDir)
        log.info("%d genomes found in source %s.", len(self.genomes),
                 self.genomeDir)

    def _family_id(self, fam_idx: str) -> str:
        return self.prefix + fam_idx.rjust(8, "0")

    def run_command(self) -> None:
        self.prepare_out_dir()
        genome_map: dict[str, Genome] = {}
        p_count = 0
        for genome in self.genomes:
            log.info("Processing genome: %s", genome)
            for feat in genome.features:
                if feat.is_protein:
                    feat.function = "hypothetical protein"
                    feat.pgfam = None
                    feat.plfam = None
                    feat.gene_name = ""
                    p_count += 1
            genome_map[genome.id] = genome
        log.info("%d genomes read, %d proteins cleared.", len(genome_map),
                 p_count)

        def get_feature(fid: str):
            genome = genome_map.get(Feature.genome_of(fid))
            return genome.get_feature(fid) if genome else None

        # calls: feature ID (col 1) → new annotation (col 2)
        a_count = err_count = 0
        with TabbedLineReader(self.anno_file, 4) as reader:
            for line in reader:
                feat = get_feature(line.get(0))
                if feat is None:
                    err_count += 1
                else:
                    feat.function = line.get(1)
                    a_count += 1
        log.info("%d total features annotated, %d total errors.", a_count,
                 err_count)
        # local.family.defs: family index (col 1) → function (col 2)
        family_map: dict[str, str] = {}
        with TabbedLineReader(self.function_file, 6) as reader:
            for line in reader:
                family_map[self._family_id(line.get(0))] = line.get(1)
        log.info("%d family definitions read.", len(family_map))
        # local.family.members.expanded: index (col 1), fid (col 2),
        # gene name (col 5)
        f_count = g_count = fun_count = err_count = 0
        with TabbedLineReader(self.family_file, 5) as reader:
            for line in reader:
                feat = get_feature(line.get(1))
                if feat is None:
                    err_count += 1
                    continue
                plfam = self._family_id(line.get(0))
                feat.plfam = plfam
                f_count += 1
                function = family_map.get(plfam)
                if function is not None:
                    feat.function = function
                    fun_count += 1
                gene = line.get(4)
                if gene.strip():
                    feat.gene_name = gene
                    g_count += 1
        log.info("%d total families updated, %d total gene names stored, "
                 "%d total functions stored, %d total errors.", f_count,
                 g_count, fun_count, err_count)
        for genome in genome_map.values():
            out_file = self.out_file(genome.id + ".gto")
            log.info("Saving %s to %s.", genome, out_file)
            genome.save(out_file)
