"""Milliseconds a genome launching its step and reading back its roles and
hits, as the program's ``apply.run`` spans time it (the reads wait for
the device)."""

from kanbench import inside

SPANS = ()
COUNTS = ()


def read(trace):
    return inside.ms_per_genome(trace, ("apply.run",))
