"""Run one cell of the benchmark of ``kmers_anno_tpu_torch`` on this machine's
card, and print its result as the last line of standard output.

    python3 -m kanbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration and its traffic mix are found by name through
``BENCHMARK.json``; the configuration's ``system`` names the module of
``kanbench/systems`` that makes its data from the seed, warms it up, drives
the window and checks what the window produced against the plain reference.
``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` installs
the spans, launch samples and profiler that its per-layer metrics read
(``kanbench/metrics``) and reports those.
"""

from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started, from /proc (0 where absent)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kmers_anno_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def cell_spec(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """The cell, its configuration and its traffic mix."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def _for_cell(entries: list, name: str) -> list:
    return [m for m in entries if name in m.get("workloads", [name])]


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = ROOT / ".kanbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float = T_START) -> dict:
    """Set the cell up, run its window and check it; the result line's
    fields (with ``checks`` last)."""
    import torch

    from . import trace as tr

    cell_def, config, traffic = cell_spec(bench, workload)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    system = importlib.import_module(f"kanbench.systems.{config['system']}")
    cell = system.Cell(config, traffic, seed, device)
    cell.warm_up(sync)
    per_layer = _for_cell(bench["per_layer"], workload) if trace else []
    recorder = tr.Recorder(sync)
    readers = {}
    for m in per_layer:
        reader = tr.load_module("metrics", m["name"])
        readers[m["name"]] = reader
        for target, attr, name, do_sync in reader.SPANS:
            if name not in recorder.spans:
                recorder.spans[name] = []
                recorder.span(tr.resolve(cell, target), attr, name, do_sync)
        for count_name in reader.COUNTS:
            if count_name not in recorder.calls:
                recorder.calls[count_name] = 0
                count = tr.load_module("counts", count_name)
                for module, attr in count.WRAPPERS:
                    recorder.launches(tr.resolve(cell, module), attr,
                                      count_name)
    profile = tr.Profile(torch, sync) if trace and cuda else None
    before = cell.route_counters()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    w = cell.window(seconds, sync)
    t1 = time.perf_counter()
    route = {k: (v - before[k]) / w["n_done"]
             for k, v in cell.route_counters().items()}
    route.update(cell.facts())
    recorder.restore()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    events = profile.stop() if profile else []
    metrics = {}
    if trace:
        tt = tr.Trace(recorder, events, t0, t1, w, tr.peaks())
        for m in per_layer:
            v = readers[m["name"]].read(tt)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_extra = {"busy_s": tt.busy_s, "window_s": tt.window_s}
        breakdown = tt.breakdown()
        del tt
    else:
        values = dict(w, setup_s=setup_s, peak_device_gib=peak / 2**30)
        for m in _for_cell(bench["end_to_end"], workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        device_extra, breakdown = {}, None
    del recorder, events
    cell.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = cell.check(traffic["limits"])
    correct = all(v <= lim for v, lim in checks.values() if lim is not None)
    result = {
        "correct": correct, "attempted": w["n_done"],
        "failed": cell.failed,
        "metrics": metrics,
        "device": dict({
            "platform": "gpu" if cuda else "cpu",
            "kind": (torch.cuda.get_device_name(device) if cuda
                     else "cpu"),
            "count": cell_def["chips"], "memory_peak_bytes": peak},
            **device_extra)}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["route"] = route
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell_def, _, _ = cell_spec(bench, args.workload)
    _cache_dirs()
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell_def["chips"]):
        print(f"kanbench: {args.workload} needs {cell_def['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda:0"))
    bad = forbidden_modules()
    if bad:
        print(f"kanbench: modules loaded that the benchmark must not load: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
