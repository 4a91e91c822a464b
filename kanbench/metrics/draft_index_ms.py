"""Milliseconds a genome indexing the draft, as the program's spans time
it: the stream index (``proj.stream_index``), the union probe and its
compaction (``proj.union_probe``) and the ORF state (``proj.orf_state``)."""

from kanbench import inside

SPANS = ()
COUNTS = ()


def read(trace):
    return inside.ms_per_genome(
        trace, ("proj.stream_index", "proj.union_probe", "proj.orf_state"))
