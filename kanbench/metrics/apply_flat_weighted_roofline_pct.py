"""``kan_flat_weighted``'s share of the one-walk roofline over the window's
launches, one a genome."""

SPANS = ()
COUNTS = ("kan_flat_weighted",)


def read(trace):
    return trace.roofline_pct("kan_flat_weighted")
