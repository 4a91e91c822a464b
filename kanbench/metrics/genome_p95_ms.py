"""The 95th percentile (nearest rank), over every genome of the traced
window, of the time from a prefetch worker starting a genome's ``prepare``
to ``call_prepared`` returning its calls: the wait an ``apply`` user sees
for each genome's report.  A per-layer reading, not an end-to-end metric:
on a shared host its runs spread wider than the largest bound allows."""

SPANS = ()
COUNTS = ()


def read(trace):
    return trace.window.get("genome_p95_ms")
