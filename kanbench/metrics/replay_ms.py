"""Milliseconds a genome on the host after the scan, as the program's
spans time it: the replay of the stored events with its trace logging
(``proj.replay``) and the features made from the proposals
(``proj.features``)."""

from kanbench import inside

SPANS = ()
COUNTS = ()


def read(trace):
    return inside.ms_per_genome(trace, ("proj.replay", "proj.features"))
