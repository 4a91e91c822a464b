"""Milliseconds a genome in hashAnno's index build, as the program's
``hash.index`` spans time it: the batch's distinct protein kmers, the
owner matrix and the 8-slot table, built on the host and uploaded."""

from kanbench import hash_spans

SPANS = ()
COUNTS = ()


def read(trace):
    return hash_spans.ms_per_genome(trace, ("hash.index",))
