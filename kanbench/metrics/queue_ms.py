"""Milliseconds a prepared genome waits for the main thread: the mean, over
the window's genomes, of ``apply.call``'s start less the end of the
``apply.prepare`` of the same request (the time it sits in the
prefetcher)."""

from kanbench import inside

SPANS = ()
COUNTS = ()


def read(trace):
    return inside.queue_ms(trace)
