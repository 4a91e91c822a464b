"""``kan_hash_commons``'s share of its roofline over the window's
launches, one a prototype chunk."""

SPANS = ()
COUNTS = ("kan_hash_commons",)


def read(trace):
    return trace.roofline_pct("kan_hash_commons")
