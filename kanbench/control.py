"""The readings a cell's limits are set from, on the card at the cell's own
size: for each seed, the numbers the check compares for the program's own
run (the lower readings) and for the control, the reference put in the
program's place with the guarantee the configuration states broken (the
upper readings).  The benchmark's own runs never run the control.

    python3 -m kanbench.control --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...]

Prints one JSON line a seed.  The controls: projection takes one close
genome fewer than the configuration's ``n_genomes``; unweighted apply looks
kmers up by a 32-bit hash of the key; weighted apply sums each role's
weights in bfloat16.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time

from . import run


def readings(workload: str, seed: int, seconds: float, device) -> dict:
    import torch

    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    _, config, traffic = run.cell_spec(bench, workload)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    system = importlib.import_module(f"kanbench.systems.{config['system']}")
    cell = system.Cell(config, traffic, seed, device)
    cell.warm_up(sync)
    w = cell.window(seconds, sync)
    cell.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    program = cell.check(traffic["limits"])
    t1 = time.perf_counter()
    control = cell.check(traffic["limits"], control=True)
    return {"workload": workload, "seed": seed, "n_done": w["n_done"],
            "program": {k: v for k, (v, _) in program.items()},
            "control": {k: v for k, (v, _) in control.items()},
            "limits": traffic["limits"], "reference_s": t1 - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    run._cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("kanbench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  torch.device("cuda:0"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
