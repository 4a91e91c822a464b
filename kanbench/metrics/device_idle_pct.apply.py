"""The share of the window in which no kernel or copy ran on the device,
in the apply cells."""

SPANS = (("cell.engine", "call_prepared", "call", True),)
COUNTS = ()


def read(trace):
    return trace.idle_pct()
