"""Command dispatcher of the port (App.java:29-85): the first argument
selects the subcommand, the rest go to its processor.

The table lists every command of the reference; only the ported ones have
a processor, and the others answer "not yet ported".
"""

from __future__ import annotations

import sys
from typing import Callable, Sequence

from ..host import REFERENCE_COMMANDS

PROG = "kmers_anno_tpu_torch"


def _lazy(module: str, cls: str) -> Callable:
    def factory():
        mod = __import__(f"{__package__}.{module}", fromlist=[cls])
        return getattr(mod, cls)()
    return factory


_PORTED = {
    "kmers": _lazy("kmers_cmd", "GenomeKmerProcessor"),
    "batch": _lazy("kmers_cmd", "BatchKmerProcessor"),
}

# command name → (factory or None when not yet ported, description)
COMMANDS: dict[str, tuple[Callable | None, str]] = {
    name: (_PORTED.get(name), desc)
    for name, (_, desc) in REFERENCE_COMMANDS.items()
}


def show_commands() -> None:
    print("Valid commands are:", file=sys.stderr)
    width = max(len(name) for name in COMMANDS)
    for name, (factory, desc) in COMMANDS.items():
        note = "" if factory else " (not yet ported)"
        print(f"  {name:<{width}}  {desc}{note}", file=sys.stderr)


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
    if entry[0] is None:
        print(f"Command {command} is not yet ported to {PROG}; "
              "run it with python -m kmers_anno_tpu.", file=sys.stderr)
        return 2
    processor = entry[0]()
    processor.parse(f"{PROG} {command}", rest)
    return processor.run()
