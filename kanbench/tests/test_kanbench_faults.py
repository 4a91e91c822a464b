"""The check decides ``correct``: a sound run passes it; a run whose timed
path is broken underneath fails it, for each fault a cell can have; the
control (the reference in the program's place, with the guarantee the
configuration states broken) fails it at a size a test run holds.

A fault is planted in the program's entry the window drives, where the
answer is produced: an answer altered, half the batch left out, the state
returned unchanged.  (One card: no exchange between cards to leave out.)
"""

from __future__ import annotations

import pytest

from kanbench.tests.small import WARM, WEIGHTED, run_small

PROJ = ("proj_rotating", WARM)
APPLY = ("apply10m_stream", WEIGHTED)


@pytest.mark.parametrize("workload", PROJ + APPLY)
def test_sound_run_is_correct(monkeypatch, workload):
    res = run_small(monkeypatch, workload)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0
    assert res["checks"]["genomes_checked"]["value"] >= 1
    assert list(res)[-1] == "checks"


def _altered_feature(monkeypatch):
    from kmers_anno_tpu_torch.engine.projection import ProjectionAnnotator

    make = ProjectionAnnotator._make_feature

    def altered(proposal, genome, peg_num, xlator):
        if peg_num == 1:
            proposal.function = proposal.function + " (altered)"
        return make(proposal, genome, peg_num, xlator)

    monkeypatch.setattr(ProjectionAnnotator, "_make_feature",
                        staticmethod(altered))


def _half_proposals(monkeypatch):
    from kmers_anno_tpu_torch.engine.proposals import PegProposalList

    it = PegProposalList.__iter__

    def half(self):
        props = list(it(self))
        return iter(props[: len(props) // 2])

    monkeypatch.setattr(PegProposalList, "__iter__", half)


def _unchanged_genome(monkeypatch):
    from kmers_anno_tpu_torch.engine.projection import ProjectionAnnotator

    monkeypatch.setattr(ProjectionAnnotator, "annotate_genome",
                        lambda self, genome, loader: {})


def _altered_call(monkeypatch):
    from kmers_anno_tpu_torch.engine.apply_engine import KmerApplyEngine

    call = KmerApplyEngine.call_prepared

    def altered(self, pegs, prepared):
        got = call(self, pegs, prepared)
        if got:
            feat, role, hits = got[0]
            got[0] = (feat, role, hits + 1)
        return got

    monkeypatch.setattr(KmerApplyEngine, "call_prepared", altered)


def _half_calls(monkeypatch):
    from kmers_anno_tpu_torch.engine.apply_engine import KmerApplyEngine

    call = KmerApplyEngine.call_prepared

    def half(self, pegs, prepared):
        got = call(self, pegs, prepared)
        keep = {id(f) for f in pegs[: len(pegs) // 2]}
        return [c for c in got if id(c[0]) in keep]

    monkeypatch.setattr(KmerApplyEngine, "call_prepared", half)


def _unchanged_calls(monkeypatch):
    from kmers_anno_tpu_torch.engine.apply_engine import KmerApplyEngine

    monkeypatch.setattr(KmerApplyEngine, "call_prepared",
                        lambda self, pegs, prepared: [])


FAULTS = {"answer_altered": (_altered_feature, _altered_call),
          "half_the_batch": (_half_proposals, _half_calls),
          "state_unchanged": (_unchanged_genome, _unchanged_calls)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", PROJ + APPLY)
def test_fault_is_not_correct(monkeypatch, workload, fault):
    plant = FAULTS[fault][0 if workload in PROJ else 1]
    plant(monkeypatch)
    res = run_small(monkeypatch, workload)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] >= 1


@pytest.mark.parametrize("workload", PROJ + APPLY)
def test_control_is_not_correct(monkeypatch, workload):
    """The control's readings pass a limit of the cell."""
    import torch

    from kanbench import run
    from kanbench.tests.small import bench, small_spec

    torch.set_num_threads(2)
    _, config, traffic = small_spec(run.cell_spec)(bench(), workload)
    system = __import__(f"kanbench.systems.{config['system']}",
                        fromlist=["Cell"])
    cell = system.Cell(config, traffic, 2**34 + 3, torch.device("cpu"))
    cell.warm_up(lambda: None)
    cell.window(1.0, lambda: None)
    cell.free()
    checks = cell.check(traffic["limits"], control=True)
    assert any(lim is not None and v > lim for v, lim in checks.values()), \
        checks
