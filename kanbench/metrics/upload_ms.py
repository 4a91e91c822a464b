"""Milliseconds a genome copying its batch to the device, as the
program's ``apply.upload`` spans time it (host time of the copies from
pageable memory)."""

from kanbench import inside

SPANS = ()
COUNTS = ()


def read(trace):
    return inside.ms_per_genome(trace, ("apply.upload",))
