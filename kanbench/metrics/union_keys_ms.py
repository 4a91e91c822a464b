"""Milliseconds a genome in the close set's union keys, as the program's
``proj.close_set.union_keys`` spans time them: the live close genomes'
singleton keys concatenated, ``np.unique`` and the lo/hi split."""

from kanbench import inside

SPANS = ()
COUNTS = ()


def read(trace):
    return inside.ms_per_genome(trace, ("proj.close_set.union_keys",))
