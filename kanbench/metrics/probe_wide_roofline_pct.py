"""``kan_probe_wide``'s share of its roofline over the window's launches:
the union probe and the close tables' probes of the fused scan."""

SPANS = ()
COUNTS = ("kan_probe_wide",)


def read(trace):
    return trace.roofline_pct("kan_probe_wide")
