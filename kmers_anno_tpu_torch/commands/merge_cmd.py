"""``merge`` — merge testing.tbl atop training.tbl, dropping all-zero role
columns (MergeFilesProcessor.java:38-169).

A copy of the reference package's ``commands/merge_cmd.py``.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil

from ..utils.io import LineReader
from .base import BaseProcessor

log = logging.getLogger(__name__)


class MergeFilesProcessor(BaseProcessor):

    HELP = "merge the testing set and the training set into a single file"

    def add_options(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument("evalDir", metavar="evalDir",
                            help="evaluation directory")

    def validate_parms(self) -> None:
        self.require_dir(self.evalDir, "Evaluation directory")
        backup = os.path.join(self.evalDir, "Backup")
        os.makedirs(backup, exist_ok=True)
        self.roles_file = os.path.join(self.evalDir, "roles.to.use")
        self.testing_file = os.path.join(self.evalDir, "testing.tbl")
        self.training_file = os.path.join(self.evalDir, "training.tbl")
        self.require_file(self.roles_file, "Roles-to-use file")
        self.require_file(self.testing_file, "Testing file")
        self.require_file(self.training_file, "Training file")
        # back up the files we rewrite (MergeFilesProcessor.java:86-87)
        shutil.copy(self.roles_file, backup)
        shutil.copy(self.training_file, backup)

    def run_command(self) -> None:
        with LineReader(self.training_file) as fh:
            train_lines = [line.split("\t") for line in fh]
        keep = [False] * len(train_lines[0])
        with LineReader(self.testing_file) as fh:
            test_lines = []
            for line in fh:
                fields = line.split("\t")
                for i, val in enumerate(fields[: len(keep)]):
                    if val != "0":
                        keep[i] = True
                test_lines.append(fields)
        log.info("%d columns will be kept.", sum(keep))

        def write_line(out, fields):
            row = [fields[0]] + [fields[i] for i in range(1, len(keep))
                                 if keep[i]]
            out.write("\t".join(row) + "\n")

        # testing set rows go first, under the training header
        with open(self.training_file, "w") as out:
            write_line(out, train_lines[0])
            for fields in test_lines:
                write_line(out, fields)
            for fields in train_lines[1:]:
                write_line(out, fields)
        # rewrite roles.to.use, keeping roles whose column survived;
        # role i corresponds to column i+1 (MergeFilesProcessor.java:139-143)
        with LineReader(self.roles_file) as fh:
            role_lines = [line for i, line in enumerate(fh, 1)
                          if i < len(keep) and keep[i]]
        log.info("Updating role file. %d roles will be kept.",
                 len(role_lines))
        with open(self.roles_file, "w") as out:
            for line in role_lines:
                out.write(line + "\n")
