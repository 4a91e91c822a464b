"""Milliseconds a genome turning its roles and hits into the
``(feature, role, hits)`` calls, as the program's ``apply.decode`` spans
time it."""

from kanbench import inside

SPANS = ()
COUNTS = ()


def read(trace):
    return inside.ms_per_genome(trace, ("apply.decode",))
