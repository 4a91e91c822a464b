"""Milliseconds a genome in the close set's per-genome tables, as the
program's ``proj.close_set.close_tables`` spans time them: the padded
keys' uploads, the device builds, the one read of their ``bad`` flags,
host fallbacks and the per-peg threshold uploads."""

from kanbench import inside

SPANS = ()
COUNTS = ()


def read(trace):
    return inside.ms_per_genome(trace, ("proj.close_set.close_tables",))
