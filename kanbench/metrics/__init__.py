"""One per-layer metric a file, named as in ``BENCHMARK.json``: ``SPANS``,
the calls to wrap in host-clock spans in a traced run, each (target, attribute,
span name, synchronise at its end), with target ``cell.<attr>`` for an object
the cell holds or a module of the program; ``COUNTS``, the kernels whose
launches it counts (files of ``kanbench/counts``); ``read(trace)``, the
value, or None when the run gave nothing to read."""
