"""MiB a genome copied to the device: the ``bytes`` of the program's
``apply.upload`` spans (codes 1 B, segment ids 4 B and flags 1 B a token
of a ``FlatBatch``)."""

from kanbench import inside

SPANS = ()
COUNTS = ()


def read(trace):
    got = inside.attr_per_genome(trace, "apply.upload", "bytes")
    return None if got is None else got / 2**20
