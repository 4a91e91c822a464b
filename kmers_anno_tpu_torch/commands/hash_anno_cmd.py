"""``hashAnno``: kmer-hash re-annotation over a genome source
(HashAnnotationProcessor.java:63-330).

The options are the reference's (``kmers_anno_tpu/commands/
hash_anno_cmd.py``) plus ``--device``.  Genome batches run one after
another on one device; ``--data-parallel N`` fans them over lanes
(``parallel.lanes``: one a visible card on ``cuda``, threads on ``cpu``),
with the same per-genome files and ``changes.tbl`` rows in genome-id
order.
"""

from __future__ import annotations

import argparse
import logging
import os
import threading
import time

from ..device import resolve_device
from ..engine.annotation import ANNO_FILE_RE, OUTPUT_HEADER
from ..engine.hashanno import (Prototype, PrototypeSet, RateLogger,
                               annotate_genomes_batched)
from ..genome.sources import GenomeSource
from ..parallel.lanes import lane_devices, run_lanes
from ..utils.io import TabbedLineReader
from ..utils.prefetch import prefetch_map
from .base import BaseMultiReportProcessor, ParseFailureException

log = logging.getLogger(__name__)


class HashAnnotationProcessor(BaseMultiReportProcessor):

    HELP = ("use a protein kmer hash to annotate features in a PATRIC "
            "dump directory")

    def add_options(self, parser: argparse.ArgumentParser) -> None:
        super().add_options(parser)
        parser.add_argument(
            "-K", "--kmer", dest="kmer_size", type=int, default=8,
            metavar="10", help="protein kmer size")
        parser.add_argument(
            "--minSim", dest="min_score", type=float, default=0.0125,
            metavar="0.1",
            help="minimum acceptable similarity score for annotation")
        parser.add_argument(
            "--minLen", dest="min_prot_len", type=int, default=50,
            metavar="200",
            help="minimum acceptable length for an annotation protein")
        parser.add_argument(
            "--source", "-t", dest="source_type", default="DIR",
            help="type of genome source")
        parser.add_argument(
            "--missing", action="store_true",
            help="if specified, only new genomes will be annotated")
        parser.add_argument(
            "--batch", dest="batch_size", type=int, default=4, metavar="4",
            help="genomes scored per combined device batch (1 = one "
                 "genome per device pass, the reference's granularity)")
        parser.add_argument(
            "--data-parallel", dest="data_parallel", type=int, default=1,
            metavar="N",
            help="fan genome batches across N lanes: one a visible card "
                 "on cuda, threads on cpu")
        parser.add_argument(
            "--device", default="cuda",
            help="torch device to run on: cuda (default), cuda:N or cpu")
        parser.add_argument("annoFile", metavar="annoFile",
                            help="input role annotation file")
        parser.add_argument("inDir", metavar="inDir",
                            help="input genome source")

    def default_out_dir(self) -> str:
        return os.path.join(os.getcwd(), "Annotations")

    def validate_parms(self) -> None:
        if self.kmer_size < 2:
            raise ParseFailureException("Kmer Size must be at least 2.")
        if self.batch_size < 1:
            raise ParseFailureException("Batch size must be at least 1.")
        if self.data_parallel < 1:
            raise ParseFailureException("--data-parallel must be >= 1")
        if not 0.0 <= self.min_score < 1.0:
            raise ParseFailureException(
                "Minimum similarity score must be between 0 and 1.")
        if self.min_prot_len < self.kmer_size:
            raise ParseFailureException(
                "Minimum protein length cannot be less than kmer size.")
        self.require_file(self.annoFile, "Role annotation file")
        if not os.path.exists(self.inDir):
            raise FileNotFoundError(
                f"Genome source {self.inDir} not found.")
        try:
            self.device = resolve_device(self.device)
        except RuntimeError as exc:     # the device does not exist here
            raise ParseFailureException(str(exc)) from exc
        # role annotation file: headered TSV with protein + annotation cols
        self.prototypes: list[Prototype] = []
        with TabbedLineReader(self.annoFile) as reader:
            anno_i = reader.find_field("annotation")
            prot_i = reader.find_field("protein")
            for line in reader:
                anno = line.get(anno_i)
                prot = line.get(prot_i)
                if anno.strip() and len(prot) >= self.min_prot_len:
                    self.prototypes.append(Prototype(prot, anno))
        log.info("%d annotations found.", len(self.prototypes))
        self.genomes = GenomeSource.create(self.source_type, self.inDir)
        log.info("%d genomes loaded from %s.", len(self.genomes),
                 self.inDir)

    def run_command(self) -> None:
        self.prepare_out_dir()
        genome_ids = set(self.genomes.ids())
        if self.missing:
            for name in os.listdir(self.outDir):
                m = ANNO_FILE_RE.fullmatch(name)
                if m:
                    genome_ids.discard(m.group(1))
            log.info("%d genomes left to process.", len(genome_ids))
        totals = dict(features=0, proteins=0, confirmed=0, defaulted=0,
                      changed=0)
        # pack prototype kmers once for the whole run
        protoset = PrototypeSet(self.prototypes, self.kmer_size)
        rate = RateLogger("lines")   # 5-second prototype lines/s logger
        ids = sorted(genome_ids)
        groups = [ids[i: i + self.batch_size]
                  for i in range(0, len(ids), self.batch_size)]
        if self.data_parallel > 1 and len(groups) > 1:
            return self._run_data_parallel(groups, protoset, rate, totals,
                                           len(genome_ids))
        with open(self.out_file("changes.tbl"), "w") as change_writer:
            change_writer.write(OUTPUT_HEADER + "\n")
            # genome load/parse of the next batch overlaps device scoring
            # of the current one, and each batch's genomes score through
            # one combined device index (outputs stay in order)
            stream = prefetch_map(
                groups, lambda g: [(gid, self.genomes.get(gid))
                                   for gid in g])
            done = 0
            for group in stream:
                start = time.time()
                results = annotate_genomes_batched(
                    [genome for _, genome in group], protoset,
                    self.kmer_size, self.min_score, rate=rate,
                    device=self.device)
                for (gid, genome), (rows, changes, stats) in zip(group,
                                                                 results):
                    done += 1
                    log.info("Processed genome %d of %d:  %s.", done,
                             len(ids), genome)
                    with open(self.out_file(f"{gid}.anno.tbl"), "w") as fh:
                        fh.write(OUTPUT_HEADER + "\n")
                        for row in rows:
                            fh.write("\t".join(row) + "\n")
                    for row in changes:
                        change_writer.write("\t".join(row) + "\n")
                    log.info("%d default annotations, %d confirmed "
                             "annotations, %d new annotations in %s.",
                             stats["defaulted"], stats["confirmed"],
                             stats["changed"], genome)
                    for key in totals:
                        totals[key] += stats[key]
                log.info("%.1fs to annotate %d genomes.",
                         time.time() - start, len(group))
        log.info("%d total proteins out of %d features processed for %d "
                 "genomes.", totals["proteins"], totals["features"],
                 len(genome_ids))
        log.info("%d annotations confirmed, %d updated, %d defaulted.",
                 totals["confirmed"], totals["changed"],
                 totals["defaulted"])

    def _run_data_parallel(self, groups, protoset, rate, totals,
                           n_genomes: int) -> None:
        """Fan genome batches over lanes, round-robin: a thread, a device
        and a combined index a batch each.  Per-genome ``<id>.anno.tbl``
        files are the sequential run's; ``changes.tbl`` rows are gathered
        a genome and written in genome-id order, as the sequential run
        writes them."""
        devs = lane_devices(self.device, self.data_parallel, len(groups))
        n = len(devs)
        log.info("Fanning %d genome batches across %d lanes.", len(groups),
                 n)
        lanes = [groups[i::n] for i in range(n)]
        lock = threading.Lock()
        all_changes: dict[str, list] = {}
        done = [0]

        def lane(i: int) -> None:
            for group in lanes[i]:
                loaded = [(gid, self.genomes.get(gid)) for gid in group]
                results = annotate_genomes_batched(
                    [g for _, g in loaded], protoset, self.kmer_size,
                    self.min_score, rate=rate, device=devs[i])
                for (gid, genome), (rows, changes, stats) in zip(loaded,
                                                                 results):
                    with open(self.out_file(f"{gid}.anno.tbl"), "w") as fh:
                        fh.write(OUTPUT_HEADER + "\n")
                        for row in rows:
                            fh.write("\t".join(row) + "\n")
                    with lock:
                        done[0] += 1
                        log.info("Processed genome %d of %d:  %s.", done[0],
                                 n_genomes, genome)
                        all_changes[gid] = changes
                        for key in totals:
                            totals[key] += stats[key]

        run_lanes(devs, lane)
        with open(self.out_file("changes.tbl"), "w") as change_writer:
            change_writer.write(OUTPUT_HEADER + "\n")
            for gid in sorted(all_changes):
                for row in all_changes[gid]:
                    change_writer.write("\t".join(row) + "\n")
        log.info("%d total proteins out of %d features processed for %d "
                 "genomes.", totals["proteins"], totals["features"],
                 n_genomes)
        log.info("%d annotations confirmed, %d updated, %d defaulted.",
                 totals["confirmed"], totals["changed"],
                 totals["defaulted"])
