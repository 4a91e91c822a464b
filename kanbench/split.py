"""A traced run of one cell, with what its result line leaves out: the
device's idle seconds by the program span open across them
(``inside.idle_by_span``), and each program span's milliseconds, count and
attributes a genome, over the window.

    python3 -m kanbench.split --workload proj_rotating --seed 7 --seconds 51

Prints the run's result line (as ``kanbench.run --trace 1`` prints it),
then one JSON line of these readings and the traced window's own rate.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from . import run, trace


def readings(tt) -> dict:
    from . import inside

    ms: dict = defaultdict(float)
    count: dict = defaultdict(int)
    attrs: dict = defaultdict(lambda: defaultdict(int))
    for r in inside.spans.records():
        if tt.t0 <= r.end <= tt.t1:
            ms[r.name] += 1e3 * (r.end - r.start)
            count[r.name] += 1
            for key, value in r.attrs.items():
                attrs[r.name][key] += value
    n = tt.n_done
    return {"window": tt.window,
            "idle_by_span": inside.idle_by_span(tt),
            "spans": {name: {"ms": ms[name] / n, "count": count[name] / n,
                             **{k: v / n for k, v in attrs[name].items()}}
                      for name in sorted(ms)},
            "dropped": inside.spans.dropped()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    run._cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("kanbench.split: no CUDA device", file=sys.stderr)
        return 2
    kept = []

    class Kept(trace.Trace):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.append(self)

    trace.Trace = Kept
    result = run.run_cell(bench, args.workload, args.seed, args.seconds,
                          True, torch.device("cuda:0"))
    print(json.dumps(result), flush=True)
    print(json.dumps(readings(kept[0])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
