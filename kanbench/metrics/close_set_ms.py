"""Milliseconds a genome in the annotator's close set (the union and the
close genomes' tables, built or found cached)."""

SPANS = (("cell.annot", "_close_set", "close_set", True),)
COUNTS = ()


def read(trace):
    return trace.span_ms_per_genome("close_set")
