"""``apply`` — apply a discriminating-kmer database to genomes
(ApplyKmerProcessor.java:45-157).

The options are the reference's (``kmers_anno_tpu/commands/apply_cmd.py``)
plus ``--device``.  Protein tables call roles for the pegs of each genome
(``engine.apply_engine``); a DNA table (``build --dna``) calls regions on
both strands of each genome's raw contigs (``engine.dna_apply``, with
``--max-gap``), both on one device.  ``--mesh DxT`` runs either on a
(data, table) mesh of members (``engine.mesh_apply``): with ``--device
cuda`` each process contributes its visible cards, with ``--device cpu``
D·T / processes virtual CPU members.  Several processes join through the
``KAN_*`` variables (``parallel.distributed``); every process writes the
report's header and only the primary its genome rows.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

from ..device import resolve_device
from ..engine.apply_engine import KmerApplyEngine
from ..engine.dna_apply import DnaApplyEngine
from ..engine.mesh_apply import (DnaMeshApplyEngine, MeshApplyEngine,
                                 parse_mesh_spec)
from ..engine.protein_kmers import set_drop_last
from ..engine.signature import SignatureTable
from ..genome.gto import Genome, GenomeDirectory
from ..parallel.distributed import (is_primary, maybe_init_distributed,
                                    process_count)
from ..reports.apply_reports import ApplyKmerReporter
from ..utils.prefetch import prefetch_map
from .base import BaseProcessor, ParseFailureException

log = logging.getLogger(__name__)


class ApplyKmerProcessor(BaseProcessor):

    HELP = ("apply a discriminating-kmer database to genomes to create a "
            "role-count file")

    def add_options(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument(
            "--format", default="APPLY", choices=["APPLY", "VERIFY"],
            help="reporting format (default APPLY)")
        parser.add_argument(
            "-m", "--min", dest="min_hits", type=int, default=5,
            metavar="10", help="minimum number of hits to call a role")
        parser.add_argument(
            "-o", "--output", metavar="outFile", default=None,
            help="report output file (default: stdout)")
        parser.add_argument(
            "--mesh", metavar="DATAxTABLE", default=None,
            help="run on a device mesh, e.g. 8x1 (data-parallel, table "
                 "replicated) or 4x2 (table hash-sharded over 2 members "
                 "with routed lookups); --device cuda gives each process's "
                 "visible cards, --device cpu virtual CPU members")
        parser.add_argument(
            "--table-mode", default="auto",
            choices=["auto", "replicated", "pmax", "routed"],
            help="sharded-table merge strategy (default: routed when the "
                 "table axis is >1)")
        parser.add_argument(
            "--capacity-factor", type=float, default=None, metavar="2.0",
            help="routing-buffer slack per shard (default: provably safe "
                 "worst case; smaller is faster but may trigger an exact "
                 "re-run)")
        parser.add_argument(
            "--max-gap", type=int, default=500, metavar="500",
            help="DNA mode: max window-start gap between same-role hits "
                 "merged into one called region (default 500)")
        parser.add_argument(
            "--weighted", action="store_true",
            help="weighted best-tally voting instead of reference "
                 "unanimity; uses the table's weight column (1.0 when "
                 "absent)")
        parser.add_argument(
            "--min-weight", type=float, default=None, metavar="5.0",
            help="minimum winning tally to call a role in --weighted "
                 "mode (default: the -m value)")
        parser.add_argument(
            "--dropLast", action="store_true", dest="drop_last",
            help="drop the final kmer window of every protein (see "
                 "engine/protein_kmers.py)")
        parser.add_argument(
            "--device", default="cuda",
            help="torch device to run on: cuda (default), cuda:N or cpu")
        parser.add_argument("kmerDbFile", metavar="kmerdb.tbl",
                            help="discriminating kmer database")
        parser.add_argument("goodRoleFile", metavar="roles.in.use",
                            help="list of roles in use")
        parser.add_argument("inDir", metavar="gtoDir",
                            help="input genome directory")

    def validate_parms(self) -> None:
        if self.drop_last:
            set_drop_last(True)
        self.require_dir(self.inDir, "Input directory")
        self.require_file(self.kmerDbFile, "Kmer database file")
        self.require_file(self.goodRoleFile, "Roles-to-use file")
        if self.min_hits < 1:
            raise ParseFailureException("Min-hits must be positive.")
        self.mesh_shape = None
        if self.mesh:
            try:
                self.mesh_shape = parse_mesh_spec(self.mesh)
            except ValueError as exc:
                raise ParseFailureException(str(exc)) from exc
            if ":" in str(self.device):
                raise ParseFailureException(
                    "--mesh names its own members: give --device cuda or "
                    "cpu, not a single card")
        try:
            self.device = resolve_device(self.device)
        except RuntimeError as exc:     # the device does not exist here
            raise ParseFailureException(str(exc)) from exc

    def run_command(self) -> None:
        out = open(self.output, "w") if self.output else sys.stdout
        try:
            reporter = ApplyKmerReporter.create(self.format, out)
            reporter.init_report(self.goodRoleFile)
            log.info("Loading kmer database from %s.", self.kmerDbFile)
            signatures = SignatureTable.load(self.kmerDbFile)
            log.info("Kmer size is %d.", signatures.k)
            genomes = GenomeDirectory(self.inDir)
            log.info("%d genomes found in input directory.", len(genomes))
            if signatures.alphabet == "dna":
                log.info("DNA-mode table detected: annotating raw contigs "
                         "on both strands.")
            if self.mesh_shape:
                self._run_mesh(signatures, genomes, reporter)
            else:
                self._run_single(signatures, genomes, reporter)
            reporter.close_report()
        finally:
            if self.output:
                out.close()

    def _run_single(self, signatures, genomes, reporter) -> None:
        kw = dict(min_hits=self.min_hits, weighted=self.weighted,
                  min_weight=self.min_weight, device=self.device)
        if signatures.alphabet == "dna":
            engine = DnaApplyEngine(signatures, max_gap=self.max_gap, **kw)
            call = engine.call_prepared
        else:
            engine = KmerApplyEngine(signatures, **kw)

            def call(genome, prepared):
                return engine.call_prepared(*prepared)

        def load(name: str):
            genome = Genome.load(os.path.join(self.inDir, name))
            return genome, engine.prepare(genome)

        # host load + encode of genome i+1 overlaps the device step of
        # genome i (prefetch_map keeps input order)
        for genome, prepared in prefetch_map(genomes.files, load):
            log.info("Processing genome %s.", genome)
            reporter.open_genome(genome)
            for feat, role, count in call(genome, prepared):
                reporter.record_feature(feat, role, count)
            reporter.close_genome()

    def _members(self) -> list[torch.device]:
        """The members this process contributes to the mesh: its visible
        cards, or D·T / processes virtual CPU members."""
        if self.device.type == "cuda":
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        n_data, n_table = self.mesh_shape
        return [self.device] * -(-n_data * n_table // process_count())

    def _run_mesh(self, signatures, genomes, reporter) -> None:
        maybe_init_distributed()
        n_data, n_table = self.mesh_shape
        kw = dict(min_hits=self.min_hits, weighted=self.weighted,
                  min_weight=self.min_weight, devices=self._members())
        if signatures.alphabet == "dna":
            engine = DnaMeshApplyEngine(signatures, n_data, n_table,
                                        max_gap=self.max_gap, **kw)
            log.info("DNA mesh apply: data=%d × table=%d (%s table).",
                     n_data, n_table,
                     "pmax-sharded" if n_table > 1 else "replicated")
        else:
            engine = MeshApplyEngine(
                signatures, n_data, n_table, mode=self.table_mode,
                capacity_factor=self.capacity_factor, **kw)
            log.info("Mesh apply: data=%d × table=%d, %s table layout.",
                     n_data, n_table, engine.mode)

        def load(name: str):
            return Genome.load(os.path.join(self.inDir, name))

        # every process holds the same allgathered results; only the
        # primary writes them (the reference emits exactly one report)
        primary = is_primary()
        for genome, calls in engine.call_genomes(
                prefetch_map(genomes.files, load)):
            log.info("Processing genome %s.", genome)
            if not primary:
                continue
            reporter.open_genome(genome)
            for feat, role, count in calls:
                reporter.record_feature(feat, role, count)
            reporter.close_genome()
