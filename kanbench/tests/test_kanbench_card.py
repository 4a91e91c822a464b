"""Traced runs on the card at test size: every per-layer metric of the cell
read, a breakdown by kernel name, and ``correct`` true.  Marked ``cuda``:
skips where no card is found (decided in the fixture)."""

from __future__ import annotations

import pytest

from kanbench.tests.small import WARM, bench, small_spec

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda:0")


@pytest.mark.parametrize("workload", [WARM, "apply10m_stream"])
def test_traced_run_reads_every_metric(monkeypatch, card, workload):
    from kmers_anno_tpu_torch.engine import signature

    from kanbench import run

    monkeypatch.setattr(run, "cell_spec", small_spec(run.cell_spec))
    # the cells' tables take the flat route; so does the small one
    monkeypatch.setattr(signature, "fits_wide", lambda n: False)
    res = run.run_cell(bench(), workload, 2**33 + 5, 2.0, True, card)
    want = {m["name"] for m in bench()["per_layer"]
            if workload in m["workloads"]}
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == want, res["metrics"]
    assert res["device"]["busy_s"] > 0
    assert res["breakdown"]["device_ops"]
