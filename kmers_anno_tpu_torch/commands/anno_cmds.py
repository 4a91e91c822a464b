"""``applyAnno`` / ``checkAnno`` / ``listAnno`` — annotation file consumers
(ApplyAnnotationProcessor.java:47-163, CheckAnnotationProcessor.java:44-184,
ListNewAnnotationProcessor.java:42-154).

A copy of the reference package's ``commands/anno_cmds.py``.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import IO

from ..engine.annotation import Annotation, get_anno_map, iter_annotations
from ..genome.sources import GenomeSource, GenomeTarget
from ..reports.annotation_reports import AnnotationReporter
from ..utils.io import TabbedLineReader
from ..utils.stats import SummaryStatistics, java_double
from .base import BaseProcessor, BaseReportProcessor, ParseFailureException

log = logging.getLogger(__name__)


class ApplyAnnotationProcessor(BaseProcessor):

    HELP = "apply annotations produced by the hash annotator"

    def add_options(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument("--source", dest="source_type", default="DIR",
                            help="type of genome input source")
        parser.add_argument("--target", dest="target_type", default="DIR",
                            help="type of genome output target")
        parser.add_argument("--clear", action="store_true",
                            help="erase the genome target before processing")
        parser.add_argument("annoDir", metavar="annoDir",
                            help="name of the annotation file directory")
        parser.add_argument("inDir", metavar="inDir",
                            help="genome source input directory")
        parser.add_argument("outDir", metavar="outDir",
                            help="genome target output directory")

    def validate_parms(self) -> None:
        self.anno_map = get_anno_map(self.annoDir)
        if not os.path.exists(self.inDir):
            raise FileNotFoundError(
                f"Input genome source {self.inDir} does not exist.")
        self.genomes_in = GenomeSource.create(self.source_type, self.inDir)
        # LIST / DNAFASTA are accepted like the reference enum does, even
        # though those targets drop the applied annotations
        # (ApplyAnnotationProcessor.java:33-34, 105)
        try:
            self.genomes_out = GenomeTarget.create(
                self.target_type, self.outDir, clear=self.clear)
        except ValueError as exc:
            raise ParseFailureException(str(exc))

    def run_command(self) -> None:
        changes = SummaryStatistics()
        count = 0
        for genome_id, anno_file in self.anno_map.items():
            count += 1
            genome = self.genomes_in.get(genome_id)
            if genome is None:
                raise IOError(f"Genome {genome_id} not found in "
                              f"{self.inDir}.")
            log.info("Processing genome %d of %d: %s.", count,
                     len(self.anno_map), genome)
            local = SummaryStatistics()
            fid_count = skip_count = 0
            with TabbedLineReader(anno_file) as reader:
                for anno in iter_annotations(reader):
                    fid_count += 1
                    feat = genome.get_feature(anno.fid)
                    if feat is None:
                        log.error("%s not found in %s.", anno.fid, genome)
                        skip_count += 1
                    elif anno.new_annotation != feat.peg_function:
                        feat.function = anno.new_annotation
                        local.add_value(anno.score)
                        changes.add_value(anno.score)
            log.info("%d lines read, %d skipped. %d new annotations with "
                     "mean score %s and score deviation %s.", fid_count,
                     skip_count, local.n, local.mean, local.std)
            self.genomes_out.add(genome)
        self.genomes_out.close()
        log.info("%d genomes processed. %d new annotations with mean "
                 "score %s and score deviation %s.", count, changes.n,
                 changes.mean, changes.std)


class CheckAnnotationProcessor(BaseReportProcessor):

    HELP = "examine hash-annotator results and write statistics"

    def add_options(self, parser: argparse.ArgumentParser) -> None:
        super().add_options(parser)
        parser.add_argument(
            "--min", "-m", dest="min_score", type=float, default=0.9,
            metavar="0.95",
            help="minimum score for a confirmed re-annotation")
        parser.add_argument("inDir", metavar="annoDir",
                            help="input annotation directory")

    def validate_parms(self) -> None:
        if not 0.0 < self.min_score <= 1.0:
            raise ParseFailureException(
                "Minimum score must be greater than 0 and no greater "
                "than 1.")
        self.anno_map = get_anno_map(self.inDir)
        change_file = os.path.join(self.inDir, "changes.tbl")
        self.require_file(change_file, "Changes file")
        # confirmed set keyed on (old, new) annotation pairs
        self.confirmed: set[Annotation] = set()
        with TabbedLineReader(change_file) as reader:
            n = 0
            for anno in iter_annotations(reader):
                n += 1
                if anno.score >= self.min_score:
                    self.confirmed.add(anno)
        log.info("%d changes checked, %d were confirmed.", n,
                 len(self.confirmed))

    @staticmethod
    def _row(writer: IO, genome_id: str, feat: int, keep: int, hypo: int,
             good: SummaryStatistics, bad: SummaryStatistics) -> None:
        # NOTE: the reference's report() declares (feat, hypo, keep) but is
        # called with (feat, keep, hypo), so the "defaulted" column actually
        # carries the hypothetical count and "hypo_defaulted" the kept count
        # (CheckAnnotationProcessor.java:109/159 vs 174-184).  Replicated
        # for byte-identical output.
        fields = [genome_id, str(feat), str(hypo), str(keep),
                  str(good.n), java_double(good.mean),
                  java_double(good.minimum), java_double(good.std),
                  str(bad.n), java_double(bad.mean),
                  java_double(bad.minimum), java_double(bad.std)]
        writer.write("\t".join(fields) + "\n")

    def run_reporter(self, writer: IO) -> None:
        keep_total = hypo_total = feat_total = 0
        good_total = SummaryStatistics()
        bad_total = SummaryStatistics()
        writer.write("genome\tfids\tdefaulted\thypo_defaulted\tgood_count"
                     "\tgood_mean\tgood_min\tgood_sdev\tother_count"
                     "\tother_mean\tother_min\tother_sdev\n")
        for genome_id, anno_file in self.anno_map.items():
            good = SummaryStatistics()
            bad = SummaryStatistics()
            keep = feat = hypo = 0
            with TabbedLineReader(anno_file) as reader:
                for anno in iter_annotations(reader):
                    feat += 1
                    feat_total += 1
                    if anno.is_null:
                        if anno.is_hypothetical:
                            hypo += 1
                            hypo_total += 1
                        else:
                            keep += 1
                            keep_total += 1
                    elif anno.is_good or anno in self.confirmed:
                        good.add_value(anno.score)
                        good_total.add_value(anno.score)
                    else:
                        bad.add_value(anno.score)
                        bad_total.add_value(anno.score)
            self._row(writer, genome_id, feat, keep, hypo, good, bad)
        self._row(writer, "TOTALS", feat_total, keep_total, hypo_total,
                  good_total, bad_total)


class ListNewAnnotationProcessor(BaseReportProcessor):

    HELP = "list annotation changes between identical genomes"

    def add_options(self, parser: argparse.ArgumentParser) -> None:
        super().add_options(parser)
        parser.add_argument("--oldType", dest="old_type", default="DIR",
                            help="genome source type for old-annotation "
                                 "genomes")
        parser.add_argument("--newType", dest="new_type", default="DIR",
                            help="genome source type for new-annotation "
                                 "genomes")
        parser.add_argument("--format", dest="out_type", default="FULL",
                            choices=["FULL", "NEW_ROLES"],
                            help="output report format")
        parser.add_argument("oldDir", metavar="oldDir",
                            help="genome source for old-annotation genomes")
        parser.add_argument("newDir", metavar="newDir",
                            help="genome source for new-annotation genomes")

    def validate_parms(self) -> None:
        if not os.path.exists(self.oldDir):
            raise FileNotFoundError(
                f"Old-annotation source {self.oldDir} is not found.")
        if not os.path.exists(self.newDir):
            raise FileNotFoundError(
                f"New-annotation source {self.newDir} is not found.")
        self.old_genomes = GenomeSource.create(self.old_type, self.oldDir)
        self.new_genomes = GenomeSource.create(self.new_type, self.newDir)
        if len(self.old_genomes) != len(self.new_genomes):
            log.warning("WARNING: Genome sources are different sizes!")
        self.reporter = AnnotationReporter.create(self.out_type)

    def run_reporter(self, writer: IO) -> None:
        self.reporter.start_report(self, writer)
        f_count = f_errors = g_errors = 0
        for genome in self.old_genomes:
            new_genome = self.new_genomes.get(genome.id)
            if new_genome is None:
                log.error("ERROR: Genome %s not found in new-annotation "
                          "library.", genome.id)
                g_errors += 1
                continue
            for feat in genome.features:
                new_feat = new_genome.get_feature(feat.id)
                f_count += 1
                if new_feat is None:
                    log.error("ERROR: Feature %s not found in new version "
                              "of %s.", feat.id, new_genome)
                    f_errors += 1
                else:
                    self.reporter.process_feature(feat, new_feat)
        log.info("%d features processed.  %d feature errors and %d genome "
                 "errors.", f_count, f_errors, g_errors)
        self.reporter.finish_report()
