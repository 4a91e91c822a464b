"""Cells of the benchmark at sizes a CPU test run holds, and a helper that
runs ``kanbench.run.run_cell`` on them in place of the files' sizes.

``WEIGHTED`` names the apply stream called with weights: the apply system's
weighted vote, which no cell of ``BENCHMARK.json`` drives yet.  ``WARM``
names the projection loop over one cached close set
(``traffic/fixed_close_set.json``), which no cell drives now: its host-bound
rate spreads between runs on a shared host by more than any bound allows.
``bench`` adds it back as a cell beside ``proj_rotating``, with that cell's
metrics."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROJ_SMALL = dict(n_genes=240, contigs=12, pool_genomes=5, n_genomes=3)
APPLY_SMALL = dict(table_keys=120_000, roles=150, pegs_min=150,
                   pegs_max=400, pool_genomes=4)
WEIGHTED = "apply10m_stream.weighted"
WEIGHTED_TRAFFIC = {"weighted": True,
                    "limits": {"role_mismatches": 0, "tally_gap": 0.01}}
WARM = "proj_warm"


def bench() -> dict:
    """``BENCHMARK.json`` with ``WARM`` as a cell of ``proj_rotating``'s
    configuration, reporting what that cell reports."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    rot = next(w for w in b["workloads"] if w["name"] == "proj_rotating")
    b["workloads"].append(dict(rot, name=WARM, traffic="fixed_close_set"))
    for m in b["end_to_end"] + b["per_layer"]:
        if "proj_rotating" in m.get("workloads", []):
            m["workloads"].append(WARM)
    return b


def small_spec(real_spec):
    """``cell_spec`` with the configuration and traffic cut to test size."""

    def spec(b, workload):
        weighted = workload == WEIGHTED
        cell, config, traffic = real_spec(
            b, "apply10m_stream" if weighted else workload)
        if config["system"] == "projection":
            config = dict(config, **PROJ_SMALL)
        else:
            config = dict(config, **APPLY_SMALL)
        return cell, config, WEIGHTED_TRAFFIC if weighted else traffic

    return spec


def run_small(monkeypatch, workload: str, seed: int = 2**33 + 17,
              seconds: float = 1.0, trace: bool = False) -> dict:
    import torch

    from kanbench import run
    from kanbench.systems import apply

    torch.set_num_threads(2)
    monkeypatch.setattr(run, "cell_spec", small_spec(run.cell_spec))
    monkeypatch.setattr(apply, "CHECK_SHARE", 0.5)
    return run.run_cell(bench(), workload, seed, seconds, trace,
                        torch.device("cpu"))
