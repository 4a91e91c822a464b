"""Command dispatcher of the port (App.java:29-85): the first argument
selects the subcommand, the rest go to its processor."""

from __future__ import annotations

import sys
from typing import Callable, Sequence

PROG = "kmers_anno_tpu_torch"


def _lazy(module: str, cls: str) -> Callable:
    def factory():
        mod = __import__(f"{__package__}.{module}", fromlist=[cls])
        return getattr(mod, cls)()
    return factory


# command name → (factory, description), the reference's table
# (App.java:32-49)
COMMANDS: dict[str, tuple[Callable, str]] = {
    "kmers": (_lazy("kmers_cmd", "GenomeKmerProcessor"),
              "annotate a genome using kmer comparison"),
    "batch": (_lazy("kmers_cmd", "BatchKmerProcessor"),
              "annotate multiple genomes using kmer comparison"),
    "build": (_lazy("build_cmd", "BuildKmerProcessor"),
              "build a discriminating-kmer database for a specified list of roles"),
    "apply": (_lazy("apply_cmd", "ApplyKmerProcessor"),
              "apply a discriminating-kmer database to genomes to create a role-count file"),
    "merge": (_lazy("merge_cmd", "MergeFilesProcessor"),
              "merge the testing set and the training set into a single file"),
    "funMap": (_lazy("compare_cmds", "FunctionCompareProcessor"),
               "map functions between genomes annotated using an old system and newly-annotated genomes"),
    "funApply": (_lazy("fun_apply_cmd", "FunctionApplyProcessor"),
                 "apply a function mapping to one or more genomes"),
    "compare": (_lazy("compare_cmds", "GenomeCompareProcessor"),
                "compare functional assignments between new and old genomes"),
    "seqCheck": (_lazy("seq_check_cmd", "SequenceCheckProcessor"),
                 "verify that proteins in genomes are consistently annotated"),
    "genes": (_lazy("genes_cmd", "GeneCopyProcessor"),
              "copy gene names from one genome to a close genome without gene names"),
    "hashAnno": (_lazy("hash_anno_cmd", "HashAnnotationProcessor"),
                 "use a protein kmer hash to annotate features in a PATRIC dump directory"),
    "applyAnno": (_lazy("anno_cmds", "ApplyAnnotationProcessor"),
                  "apply annotations produced by the hash annotator"),
    "checkAnno": (_lazy("anno_cmds", "CheckAnnotationProcessor"),
                  "examine hash-annotator results and write statistics"),
    "listAnno": (_lazy("anno_cmds", "ListNewAnnotationProcessor"),
                 "list annotation changes between identical genomes"),
    "updateJson": (_lazy("update_json_cmd", "UpdateJsonProcessor"),
                   "update annotations in JSON genome files"),
    "buildGtos": (_lazy("build_gtos_cmd", "GtoBuildProcessor"),
                  "build GTOs from PATRIC data and annotation update files"),
}


def show_commands() -> None:
    print("Valid commands are:", file=sys.stderr)
    width = max(len(name) for name in COMMANDS)
    for name, (_, desc) in COMMANDS.items():
        print(f"  {name:<{width}}  {desc}", file=sys.stderr)


def main(argv: Sequence[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        show_commands()
        return 0
    command, rest = argv[0], argv[1:]
    entry = COMMANDS.get(command)
    if entry is None:
        print(f"Invalid command {command}.", file=sys.stderr)
        show_commands()
        return 2
    processor = entry[0]()
    processor.parse(f"{PROG} {command}", rest)
    return processor.run()
