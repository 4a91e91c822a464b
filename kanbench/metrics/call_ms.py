"""Milliseconds a genome in ``KmerApplyEngine.call_prepared``: upload,
step, download and decode."""

SPANS = (("cell.engine", "call_prepared", "call", True),)
COUNTS = ()


def read(trace):
    return trace.span_ms_per_genome("call")
