"""Milliseconds a genome in hashAnno's scoring, as the program's
``hash.score`` and ``hash.pull`` spans time it: the chunk launches (the
host route's chunk loop there), then the pull of the best proposals, which
waits for the device."""

from kanbench import hash_spans

SPANS = ()
COUNTS = ()


def read(trace):
    return hash_spans.ms_per_genome(trace, ("hash.score", "hash.pull"))
