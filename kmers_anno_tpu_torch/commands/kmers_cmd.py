"""``kmers`` / ``batch`` — annotate genomes by close-genome ORF projection
(GenomeKmerProcessor.java:37-82, BatchKmerProcessor.java:36-83).

The options are the reference's (``kmers_anno_tpu/commands/kmers_cmd.py``)
plus ``--device``.  ``batch --data-parallel N`` fans the genomes over
lanes, one thread and annotator a lane: on ``cuda`` one lane a visible
card, ``min(N, cards, genomes)`` of them; on ``cpu`` ``min(N, genomes)``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

from ..engine.projection import ProjectionAnnotator
from ..genome.gto import Genome
from ..genome.sources import PatricGenomeSource
from ..parallel.lanes import lane_devices, run_lanes
from ..utils.io import TabbedLineReader
from ..utils.prefetch import Prefetcher
from .base import BaseProcessor, ParseFailureException

log = logging.getLogger(__name__)


class KmerProcessorBase(BaseProcessor):
    """Shared options of the ORF-projection commands
    (KmerProcessor.java:59-102)."""

    def add_options(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument(
            "-m", "--minStrength", "--min", dest="min_strength", type=float,
            default=0.50, metavar="0.30",
            help="minimum acceptable proposal strength (0 to 1)")
        parser.add_argument(
            "-f", "--fuzz", "--maxLength", "--max", dest="max_fuzz",
            type=float, default=1.5, metavar="2.0",
            help="maximum length increase factor for proteins (>= 1)")
        parser.add_argument(
            "--minLength", "--minFuzz", dest="min_fuzz", type=float,
            default=0.8, metavar="0.5",
            help="maximum length decrease factor for proteins (<= 1)")
        parser.add_argument(
            "--algorithm", default="AGGRESSIVE",
            choices=["STRICT", "AGGRESSIVE"],
            help="algorithm for retrieving contig kmers")
        parser.add_argument(
            "-e", "--minEvidence", dest="min_evidence", type=int,
            default=10, metavar="2",
            help="minimum acceptable proposal kmers")
        parser.add_argument(
            "-K", "--kmer", type=int, default=8, metavar="10",
            help="protein kmer length (default 8)")
        parser.add_argument(
            "-n", "--nGenomes", "--num", dest="max_genomes", type=int,
            default=10, metavar="2",
            help="maximum number of close genomes to scan")
        parser.add_argument(
            "--cache", default=None,
            help="directory for saving PATRIC genomes for re-use")
        parser.add_argument(
            "--trace", dest="trace_function", default=None,
            help="function assignment to be traced")
        parser.add_argument(
            "--device", default="cuda",
            help="torch device to run on: cuda (default), cuda:N or cpu")
        self.add_command_options(parser)

    def add_command_options(self, parser: argparse.ArgumentParser) -> None:
        ...

    def validate_parms(self) -> None:
        if self.min_strength >= 1.0:
            raise ParseFailureException(
                "Minimum strength must be less than 1.")
        if self.max_fuzz <= 1.0:
            raise ParseFailureException(
                "Max length factor must be greater than 1.")
        if self.min_fuzz > 1.0:
            raise ParseFailureException(
                "Min length factor must be less than or equal to 1.")
        if self.cache is not None and not os.path.isdir(self.cache):
            raise FileNotFoundError("Genome cache is not a directory.")
        self.source = PatricGenomeSource(self.cache)
        try:
            self.annotator = self.make_annotator(self.device)
        except RuntimeError as exc:     # the device does not exist here
            raise ParseFailureException(str(exc)) from exc
        self.validate_command_parms()

    def make_annotator(self, device) -> ProjectionAnnotator:
        """An annotator with this command's options on ``device``."""
        return ProjectionAnnotator(
            min_strength=self.min_strength, max_fuzz=self.max_fuzz,
            min_fuzz=self.min_fuzz, max_genomes=self.max_genomes,
            min_evidence=self.min_evidence, k=self.kmer,
            algorithm=self.algorithm, trace_function=self.trace_function,
            device=device)

    def validate_command_parms(self) -> None:
        ...

    def annotate(self, genome: Genome) -> None:
        self.annotator.annotate_genome(genome, self.source.get)


class GenomeKmerProcessor(KmerProcessorBase):

    HELP = "annotate a genome using kmer comparison"

    def add_command_options(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument(
            "-i", "--input", dest="in_file", default=None,
            help="input file name (if not STDIN)")
        parser.add_argument(
            "-o", "--output", dest="out_file", default=None,
            help="output file name (if not STDOUT)")

    def run_command(self) -> None:
        if self.in_file:
            log.info("Reading genome from %s.", self.in_file)
            genome = Genome.load(self.in_file)
        else:
            log.info("Reading genome from standard input.")
            genome = Genome.load(sys.stdin)
        self.annotate(genome)
        if self.out_file:
            log.info("Writing genome to %s.", self.out_file)
            genome.save(self.out_file)
        else:
            genome.save(sys.stdout)


class BatchKmerProcessor(KmerProcessorBase):

    HELP = "annotate multiple genomes using kmer comparison"

    def add_command_options(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument(
            "--data-parallel", dest="data_parallel", type=int, default=1,
            metavar="N",
            help="fan input genomes across N lanes: one a visible card "
                 "on cuda, threads on cpu (outputs identical to the "
                 "sequential run)")
        parser.add_argument(
            "in_file", metavar="inFile",
            help="input file containing input and output GTO names")

    def validate_command_parms(self) -> None:
        self.require_file(self.in_file, "Input file")
        if self.data_parallel < 1:
            raise ParseFailureException("--data-parallel must be >= 1")

    def run_command(self) -> None:
        start = time.time()
        base_dir = os.path.dirname(os.path.abspath(self.in_file))
        log.info("Reading GTO names from %s in directory %s.",
                 self.in_file, base_dir)
        with TabbedLineReader(self.in_file, 2) as reader:
            jobs = [(os.path.join(base_dir, line.get(0)),
                     os.path.join(base_dir, line.get(1)))
                    for line in reader]
        if self.data_parallel > 1 and len(jobs) > 1:
            count = self._run_data_parallel(jobs)
            if count:
                log.info("Processing complete.  %d genomes annotated, "
                         "%s seconds / genome.", count,
                         (time.time() - start) / count)
            return

        def load(job):
            in_path, out_path = job
            log.info("Reading genome from %s.", in_path)
            genome = Genome.load(in_path)
            genome.de_annotate()
            return genome, out_path

        # prefetch overlaps the next genome's GTO parse with the current
        # genome's annotation; results come back in input order
        count = 0
        for genome, out_path in Prefetcher(jobs, load):
            self.annotate(genome)
            log.info("Writing genome to %s.", out_path)
            genome.save(out_path)
            count += 1
        if count:
            log.info("Processing complete.  %d genomes annotated, "
                     "%s seconds / genome.", count,
                     (time.time() - start) / count)

    def _run_data_parallel(self, jobs) -> int:
        """Round-robin the genome list over lanes; each lane thread owns
        one device and its own annotator, so close-genome tables replicate
        a lane and the lanes' device work overlaps.  Every genome still
        runs the single-genome pipeline, so outputs are byte-identical to
        the sequential loop, in any lane order."""
        devs = lane_devices(self.annotator.device, self.data_parallel,
                            len(jobs))
        n = len(devs)
        log.info("Fanning %d genomes across %d lanes.", len(jobs), n)
        lanes = [jobs[i::n] for i in range(n)]
        counts = [0] * n

        def lane(i: int) -> None:
            annot = self.make_annotator(devs[i])
            for in_path, out_path in lanes[i]:
                log.info("Reading genome from %s.", in_path)
                genome = Genome.load(in_path)
                genome.de_annotate()
                annot.annotate_genome(genome, self.source.get)
                log.info("Writing genome to %s.", out_path)
                genome.save(out_path)
                counts[i] += 1

        run_lanes(devs, lane)
        return sum(counts)
