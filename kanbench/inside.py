"""Readers of the program's own spans (``kmers_anno_tpu_torch.utils.spans``)
for the per-layer metrics of a traced run.

Importing this module turns the program's tracer on.  A metric module is
loaded only in a ``--trace 1`` run, after the cell's set-up, so a timed
run leaves the tracer off.  Where the program has no tracer, every reader
returns None.

A reader takes the records whose end falls inside the window.  It returns
None when no span of its layer (``proj.annotate`` for the ``proj.*``
spans, ``apply.call`` for the ``apply.*`` spans) ended in the window, or
when the tracer dropped records past its cap; and 0 when the layer ran
without the span it reads, as the close set's steps when the set was
found cached.
"""

from __future__ import annotations

from collections import defaultdict

from .trace import _innermost

try:
    from kmers_anno_tpu_torch.utils import spans
except ImportError:             # a program without spans
    spans = None
else:
    spans.enable()

LAYERS = {"proj": "proj.annotate", "apply": "apply.call"}


def _in_window(trace, layer: str) -> list | None:
    """The window's records, or None where the layer's spans give
    nothing to read."""
    if spans is None or spans.dropped() or not trace.n_done:
        return None
    got = [r for r in spans.records() if trace.t0 <= r.end <= trace.t1]
    if not any(r.name == LAYERS[layer] for r in got):
        return None
    return got


def ms_per_genome(trace, names) -> float | None:
    """The spans named ``names`` (of one layer), summed, in milliseconds
    over the window's genomes."""
    got = _in_window(trace, names[0].split(".")[0])
    if got is None:
        return None
    s = sum(r.end - r.start for r in got if r.name in names)
    return 1e3 * s / trace.n_done


def attr_per_genome(trace, name: str, attr: str) -> float | None:
    """Attribute ``attr`` of the spans named ``name``, summed, over the
    window's genomes."""
    got = _in_window(trace, name.split(".")[0])
    if got is None:
        return None
    return sum(r.attrs.get(attr, 0) for r in got
               if r.name == name) / trace.n_done


def queue_ms(trace) -> float | None:
    """The mean wait, in milliseconds, of a prepared genome for the main
    thread: ``apply.call``'s start less the end of the ``apply.prepare`` of
    its request, over the requests with both spans in the window (None
    where there are none)."""
    got = _in_window(trace, "apply")
    if got is None:
        return None
    prepared = {r.request: r.end for r in got if r.name == "apply.prepare"}
    waits = [r.start - prepared[r.request] for r in got
             if r.name == "apply.call" and r.request in prepared]
    return 1e3 * sum(waits) / len(waits) if waits else None


def idle_by_span(trace) -> dict:
    """The window's device-idle seconds, each idle stretch put down to the
    innermost program span open on the main thread across its middle
    (``outside the traced spans`` where none is), largest first.  Not a
    metric: a reading for ``PERF.md``."""
    if spans is None or not trace.events:
        return {}
    gaps, cursor = [], trace.t0
    for s, e in sorted((s, e) for _, s, e in trace.events):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < trace.t1:
        gaps.append((cursor, trace.t1))
    open_spans = [(r.start, r.end, r.name) for r in spans.records()
                  if r.thread == trace.main and r.end > trace.t0
                  and r.start < trace.t1]
    by_span: dict = defaultdict(float)
    for name, g0, g1 in _innermost(gaps, open_spans):
        by_span[name] += g1 - g0
    return dict(sorted(by_span.items(), key=lambda kv: -kv[1]))
