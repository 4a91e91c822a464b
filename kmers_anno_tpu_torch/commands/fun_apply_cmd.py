"""``funApply`` — apply a good-flagged function mapping to genomes
(FunctionApplyProcessor.java:42-188).

A copy of the reference package's ``commands/fun_apply_cmd.py``.
"""

from __future__ import annotations

import argparse
import logging
import os

from ..genome.gto import GenomeDirectory
from ..genome.roles import FunctionMap
from ..utils.io import TabbedLineReader
from .base import BaseProcessor, ParseFailureException

log = logging.getLogger(__name__)

_TRUE_FLAGS = {"y", "yes", "true", "1", "x", "*"}


class FunctionApplyProcessor(BaseProcessor):

    HELP = "apply a function mapping to one or more genomes"

    def add_options(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument(
            "--project", dest="projector_file", metavar="projector.tbl",
            default=None,
            help="if specified, a file used to project new subsystems "
                 "before output")
        parser.add_argument("--clear", action="store_true",
                            help="clear output directory before processing")
        parser.add_argument("conversionFile", metavar="functionMapping.tbl",
                            help="function-mapping file from core.utils")
        parser.add_argument("inDir", metavar="inDir",
                            help="input GTO directory")
        parser.add_argument("outDir", metavar="outDir",
                            help="output directory")

    def validate_parms(self) -> None:
        self.require_dir(self.inDir, "Input directory")
        self.require_file(self.conversionFile, "Function-mapping file")
        self.projector = None
        if self.projector_file is not None:
            # FunctionApplyProcessor.java:89-91: load the projector up
            # front so a bad file fails before any genome is written
            from ..genome.subsystems import (RuleError,
                                             SubsystemRuleProjector)
            self.require_file(self.projector_file, "Projector file")
            log.info("Loading subsystem projector from %s.",
                     self.projector_file)
            try:
                self.projector = SubsystemRuleProjector.load(
                    self.projector_file)
            except RuleError as exc:
                raise ParseFailureException(str(exc))
        self.fun_map = FunctionMap()
        self.conversion: dict[str, str] = {}
        with TabbedLineReader(self.conversionFile) as reader:
            old_i = reader.find_field("patric_function")
            new_i = reader.find_field("core_function")
            good_i = reader.find_field("good")
            for line in reader:
                if line.get(good_i).strip().lower() in _TRUE_FLAGS:
                    old_fun = self.fun_map.find_or_insert(line.get(old_i))
                    new_desc = line.get(new_i)
                    new_fun = self.fun_map.get_by_name(new_desc)
                    if new_fun is None or new_fun.id != old_fun.id:
                        self.conversion[old_fun.id] = new_desc
        log.info("%d function mappings found.", len(self.conversion))
        os.makedirs(self.outDir, exist_ok=True)
        if self.clear:
            for name in os.listdir(self.outDir):
                p = os.path.join(self.outDir, name)
                if os.path.isfile(p):
                    os.unlink(p)

    def run_command(self) -> None:
        n_genomes = total = changed_total = 0
        for genome in GenomeDirectory(self.inDir):
            n_genomes += 1
            changed = n = 0
            for feat in genome.features:
                n += 1
                fn = feat.function
                if fn:
                    old_fun = self.fun_map.get_by_name(fn)
                    if old_fun is not None:
                        new_fn = self.conversion.get(old_fun.id)
                        if new_fn is not None:
                            feat.function = new_fn
                            changed += 1
            log.info("%d features found and %d changed.", n, changed)
            total += n
            changed_total += changed
            if self.projector is not None:
                # FunctionApplyProcessor.java:172-174: re-project
                # subsystems from the (possibly renamed) functions
                log.info("Updating subsystems in %s.", genome)
                self.projector.project(genome, active_only=True)
            else:
                log.info("Deleting subsystems in %s.", genome)
                genome.clear_subsystems()
            genome.save(os.path.join(self.outDir, genome.id + ".gto"))
        log.info("All done.  %d genomes processed, %d features analyzed, "
                 "%d updated.", n_genomes, total, changed_total)
