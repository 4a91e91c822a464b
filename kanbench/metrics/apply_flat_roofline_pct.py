"""``kan_flat_unanimous``'s share of its roofline over the window's
launches, one a genome."""

SPANS = ()
COUNTS = ("kan_flat_unanimous",)


def read(trace):
    return trace.roofline_pct("kan_flat_unanimous")
