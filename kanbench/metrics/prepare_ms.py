"""Milliseconds a genome in ``KmerApplyEngine.prepare`` (peg selection and
the FlatBatch), in the prefetch workers: host work, so its span ends
without a device synchronise, which would wait for the main thread's
kernels."""

SPANS = (("cell.engine", "prepare", "prepare", False),)
COUNTS = ()


def read(trace):
    return trace.span_ms_per_genome("prepare")
