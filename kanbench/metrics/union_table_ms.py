"""Milliseconds a genome in the close set's union table, as the program's
``proj.close_set.union_table`` spans time them: its host
``build_wide_table`` and its upload."""

from kanbench import inside

SPANS = ()
COUNTS = ()


def read(trace):
    return inside.ms_per_genome(trace, ("proj.close_set.union_table",))
