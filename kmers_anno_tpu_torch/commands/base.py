"""Processor lifecycle framework (contract of the reference tool's external
BaseProcessor / BaseReportProcessor / BaseMultiReportProcessor).  A copy
of the reference package's ``commands/base.py``.

Lifecycle: ``parse(args)`` builds an argparse parser from the subclass's
``add_options`` and stores parsed values on the instance; ``run()`` calls
``validate_parms`` then ``run_command``.  ``ParseFailureException`` mirrors
the reference's validation failure type.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import IO, Sequence


class ParseFailureException(Exception):
    """Parameter validation failure (org.theseed.basic.ParseFailureException)."""


class BaseProcessor:
    """A subcommand processor."""

    #: one-line description shown by the command table
    HELP = ""

    def __init__(self) -> None:
        self.set_defaults()

    # ----- subclass surface -----

    def set_defaults(self) -> None:
        """Initialize option defaults before parsing."""

    def add_options(self, parser: argparse.ArgumentParser) -> None:
        """Declare options/arguments (the @Option/@Argument analogue)."""

    def validate_parms(self) -> None:
        """Validate parsed parameters; raise ParseFailureException /
        FileNotFoundError on bad input (fail-fast, SURVEY.md §5.3)."""

    def run_command(self) -> None:
        """Execute the command."""

    # ----- lifecycle -----

    def parse(self, prog: str, args: Sequence[str]) -> None:
        parser = argparse.ArgumentParser(prog=prog, description=self.HELP)
        parser.add_argument("-v", "--verbose", action="store_true",
                            help="display more detailed progress messages")
        self.add_options(parser)
        ns = parser.parse_args(args)
        for key, value in vars(ns).items():
            setattr(self, key, value)
        level = logging.DEBUG if ns.verbose else logging.INFO
        handlers: list[logging.Handler] = [logging.StreamHandler(sys.stderr)]
        # reference logs to stderr AND a kmers.anno.log file in the working
        # directory (logback.xml:4-16); KMERS_ANNO_LOG overrides the path,
        # "off" disables the file ("" keeps the default name).
        log_path = os.environ.get("KMERS_ANNO_LOG", "") or "kmers.anno.log"
        if log_path.lower() != "off":
            try:
                handlers.append(logging.FileHandler(log_path, delay=True))
            except OSError:
                pass  # unwritable cwd: keep stderr only
        logging.basicConfig(
            level=level, handlers=handlers, force=True,
            format="%(asctime)s %(levelname)-5s %(name)s: %(message)s")

    def run(self) -> int:
        try:
            self.validate_parms()
        except (ParseFailureException, FileNotFoundError, NotADirectoryError,
                ValueError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        self.run_command()
        return 0

    # ----- shared validation helpers -----

    @staticmethod
    def require_file(path: str, what: str) -> None:
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{what} {path} not found or unreadable.")

    @staticmethod
    def require_dir(path: str, what: str) -> None:
        if not os.path.isdir(path):
            raise FileNotFoundError(f"{what} {path} not found or invalid.")


class BaseReportProcessor(BaseProcessor):
    """Adds the ``-o`` report-output option (BaseReportProcessor contract,
    CheckAnnotationProcessor.java:109)."""

    def add_options(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument(
            "-o", "--output", metavar="outFile", default=None,
            help="report output file (default: stdout)")

    def open_report(self) -> IO:
        return open(self.output, "w") if self.output else sys.stdout

    def run_command(self) -> None:
        out = self.open_report()
        try:
            self.run_reporter(out)
        finally:
            if self.output:
                out.close()

    def run_reporter(self, writer: IO) -> None:
        raise NotImplementedError


class BaseMultiReportProcessor(BaseProcessor):
    """Adds the multi-file output-directory options ``-D`` and ``--clear``
    (BaseMultiReportProcessor contract, HashAnnotationProcessor.java:
    131-134, 201)."""

    def add_options(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument(
            "-D", "--outDir", metavar="outDir",
            default=self.default_out_dir(),
            help="output directory for report files")
        parser.add_argument(
            "--clear", action="store_true",
            help="erase the output directory before processing")

    def default_out_dir(self) -> str:
        return os.getcwd()

    def prepare_out_dir(self) -> None:
        if os.path.isdir(self.outDir):
            if self.clear:
                for name in os.listdir(self.outDir):
                    p = os.path.join(self.outDir, name)
                    if os.path.isfile(p):
                        os.unlink(p)
        else:
            os.makedirs(self.outDir)

    def out_file(self, name: str) -> str:
        return os.path.join(self.outDir, name)
