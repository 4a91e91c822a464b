"""Milliseconds a genome in hashAnno's rows on the host, as the program's
``hash.register`` and ``hash.emit`` spans time them: the proteins
registered by MD5, then each feature's row."""

from kanbench import hash_spans

SPANS = ()
COUNTS = ()


def read(trace):
    return hash_spans.ms_per_genome(trace, ("hash.register", "hash.emit"))
