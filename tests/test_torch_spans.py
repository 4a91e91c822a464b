"""The port's spans (``kmers_anno_tpu_torch.utils.spans``): the tracer off
and on, the trees the annotator and the apply engine record, outputs the
same with the tracer on and off, and the benchmark's readers of the
spans (``kanbench/inside.py``) on hand-made records and traces.

The data are the benchmark's own generators at a small size.  The file
imports no jax; its last test needs a card (``cuda``) and skips here.
``kanbench.inside`` turns the tracer on when imported, so it is imported
inside the tests, and every test leaves the tracer off and empty.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kmers_anno_tpu_torch.utils import spans

ROOT = Path(__file__).resolve().parents[1]
PROJ_TINY = dict(n_genes=48, contigs=4, pool_genomes=3, n_genomes=3)
APPLY_TINY = dict(table_keys=20_000, roles=60, pegs_min=40, pegs_max=90,
                  pool_genomes=3)
SEED = 2**33 + 19
PROJ_NAMES = {"proj.annotate", "proj.stream_index", "proj.close_set",
              "proj.close_set.union_keys", "proj.close_set.union_table",
              "proj.close_set.close_tables", "proj.union_probe",
              "proj.orf_state", "proj.scan", "proj.replay", "proj.features"}
CLOSE_STEPS = {"proj.close_set.union_keys", "proj.close_set.union_table",
               "proj.close_set.close_tables"}


@pytest.fixture(autouse=True)
def tracer_off():
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()
    # importing kanbench.inside turns the tracer on: forget the module, so
    # that the next import in this process (a traced run's metric files)
    # turns it on again
    sys.modules.pop("kanbench.inside", None)
    if "kanbench" in sys.modules:
        vars(sys.modules["kanbench"]).pop("inside", None)


def _config(name: str, **small) -> dict:
    conf = json.loads((ROOT / "kanbench" / "configs" / f"{name}.json")
                      .read_text())
    return dict(conf, **small)


def _projection_cell():
    from kanbench.systems import projection

    traffic = {"close_sets": "rotating"}
    return projection.Cell(_config("proj_k8_close10", **PROJ_TINY), traffic,
                           SEED, torch.device("cpu"))


def _apply_cell(monkeypatch, route: str):
    from kanbench.systems import apply
    from kmers_anno_tpu_torch.engine import signature

    if route == "flat":
        monkeypatch.setattr(signature, "fits_wide", lambda n: False)
    cell = apply.Cell(_config("apply_k8_10m", **APPLY_TINY),
                      {"weighted": False}, SEED, torch.device("cpu"))
    assert cell.engine.mode == ("flat" if route == "flat" else "wide")
    return cell


def _by_name(records) -> dict:
    out: dict = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


# ----- the tracer -----

def test_off_records_nothing():
    a, b = spans.span("a"), spans.span("b", request=spans.request())
    assert a is b                       # one shared object
    with a as sp:
        sp.set(n=3)
        with b:
            pass
    assert spans.records() == [] and spans.dropped() == 0


def test_nesting_and_parent_ids():
    spans.enable()
    with spans.span("outer") as outer:
        with spans.span("mid") as mid:
            with spans.span("inner"):
                pass
        with spans.span("sibling"):
            pass
    with spans.span("next"):
        pass
    got = _by_name(spans.records())
    assert [r.name for r in spans.records()] == ["inner", "mid", "sibling",
                                                  "outer", "next"]
    o, m, i, s, n = (got[k][0] for k in ("outer", "mid", "inner", "sibling",
                                         "next"))
    assert o.id == outer.id and m.id == mid.id
    assert o.parent is None and n.parent is None
    assert m.parent == o.id and s.parent == o.id and i.parent == m.id
    assert len({r.id for r in spans.records()}) == 5
    for child, parent in ((m, o), (i, m), (s, o)):
        assert parent.start <= child.start <= child.end <= parent.end
    assert m.end <= s.start and o.end <= n.start


def test_threads_keep_their_own_stacks():
    spans.enable()
    idents = {}
    both = threading.Barrier(2, timeout=10)     # alive at once

    def work(tag):
        idents[tag] = threading.get_ident()
        with spans.span(f"t.{tag}"):
            both.wait()
            with spans.span(f"t.{tag}.child"):
                time.sleep(0.001)

    with spans.span("main"):
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    got = _by_name(spans.records())
    assert got["main"][0].thread == threading.get_ident()
    for tag in "ab":
        outer, child = got[f"t.{tag}"][0], got[f"t.{tag}.child"][0]
        assert outer.thread == child.thread == idents[tag]
        assert outer.parent is None           # not the main thread's span
        assert child.parent == outer.id
    assert idents["a"] != idents["b"]


def test_request_ids():
    spans.enable()
    r1, r2 = spans.request(), spans.request()
    assert r1 != r2
    with spans.span("req", r1):
        with spans.span("inherits"):
            pass
        with spans.span("own", r2):
            pass
    with spans.span("none"):
        pass
    got = {r.name: r.request for r in spans.records()}
    assert got == {"req": r1, "inherits": r1, "own": r2, "none": None}


def test_attributes():
    spans.enable()
    with spans.span("a") as sp:
        sp.set(keys_in=5, keys_out=np.int64(3))
        sp.set(keys_out=4, cached=True)
    (rec,) = spans.records()
    assert rec.attrs == {"keys_in": 5, "keys_out": 4, "cached": 1}
    assert all(type(v) is int for v in rec.attrs.values())


def test_cap_and_dropped(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    spans.enable()
    for i in range(5):
        with spans.span(f"s{i}"):
            pass
    assert [r.name for r in spans.records()] == ["s0", "s1", "s2"]
    assert spans.dropped() == 2
    spans.clear()
    assert spans.records() == [] and spans.dropped() == 0


def test_many_threads_lose_no_span(monkeypatch):
    """More threads than cores, switching often: every span is kept or
    counted as dropped, once, with its own id."""
    monkeypatch.setattr(spans, "CAP", 20_000)
    n_threads, n_spans = 24, 1_000
    spans.enable()

    def work():
        for _ in range(n_spans):
            with spans.span("outer"):
                with spans.span("inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    recs = spans.records()
    assert len(recs) == 20_000
    assert len(recs) + spans.dropped() == 2 * n_threads * n_spans
    assert len({r.id for r in recs}) == len(recs)
    outer = {r.id: r.thread for r in recs if r.name == "outer"}
    for r in recs:
        if r.name == "inner" and r.parent in outer:
            assert outer[r.parent] == r.thread


def test_a_raising_block_is_recorded_and_closed():
    spans.enable()
    with pytest.raises(ValueError):
        with spans.span("outer"):
            with spans.span("raises"):
                raise ValueError
    with spans.span("after"):
        pass
    got = _by_name(spans.records())
    assert got["raises"][0].parent == got["outer"][0].id
    assert got["after"][0].parent is None


def test_clock_is_perf_counter(monkeypatch):
    spans.enable()
    before = time.perf_counter()
    with spans.span("real"):
        pass
    after = time.perf_counter()
    ticks = iter([10.0, 12.5])
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    with spans.span("fake"):
        pass
    real, fake = spans.records()
    assert before <= real.start <= real.end <= after
    assert (fake.start, fake.end) == (10.0, 12.5)


# ----- the program's spans -----

def test_annotate_genome_records_the_fused_tree():
    cell = _projection_cell()
    ids = cell.sets.next()
    spans.enable()
    stats = cell.annot.annotate_genome(cell.request(ids), cell.pool.get)
    recs = spans.records()
    got = _by_name(recs)
    assert set(got) == PROJ_NAMES
    # the union table's host build, then (after the close tables) its upload
    build, upload = got.pop("proj.close_set.union_table")
    assert build.end <= got["proj.close_set.close_tables"][0].start
    assert got["proj.close_set.close_tables"][0].end <= upload.start
    assert build.attrs == {} and upload.attrs["bytes"] > 0
    assert all(len(v) == 1 for v in got.values())
    one = {name: v[0] for name, v in got.items()}
    by_id = {r.id: r for r in recs}
    root = one["proj.annotate"]
    assert root.parent is None and root.request is not None
    for r in recs:
        assert r.request == root.request
        if r is not root:
            parent = by_id[r.parent]
            assert parent.start <= r.start <= r.end <= parent.end
            want = ("proj.close_set" if r.name in CLOSE_STEPS
                    else "proj.annotate")
            assert parent.name == want, r.name
    a = {name: r.attrs for name, r in one.items()}
    n_live = len(ids)
    assert a["proj.close_set"] == {"cached": 0}
    keys = a["proj.close_set.union_keys"]
    assert keys["keys_in"] >= keys["keys_out"] > 0
    assert a["proj.close_set.close_tables"] == {"tables": n_live,
                                                "fallbacks": 0}
    assert a["proj.stream_index"]["windows"] > 0
    assert a["proj.union_probe"]["hits"] > 0
    assert a["proj.replay"]["stored"] > 0
    assert a["proj.features"] == {"pegs": stats["pegs"]} and stats["pegs"]
    # the same set again: found cached, its steps not run
    spans.clear()
    cell.annot.annotate_genome(cell.request(ids), cell.pool.get)
    got = _by_name(spans.records())
    assert set(got) == PROJ_NAMES - CLOSE_STEPS
    assert got["proj.close_set"][0].attrs == {"cached": 1}


@pytest.mark.parametrize("route", ["flat", "rows"])
def test_prepare_in_a_worker_shares_the_call_request(monkeypatch, route):
    from kmers_anno_tpu_torch.utils.prefetch import prefetch_map

    cell = _apply_cell(monkeypatch, route)
    engine = cell.engine
    spans.enable()
    main = threading.get_ident()
    n = 0
    for prepared in prefetch_map(cell.genomes, engine.prepare):
        engine.call_prepared(*prepared)
        n += 1
    got = _by_name(spans.records())
    assert len(got["apply.prepare"]) == len(got["apply.call"]) == n == 3
    prep = {r.request: r for r in got["apply.prepare"]}
    calls = {r.request: r for r in got["apply.call"]}
    assert prep.keys() == calls.keys() and None not in calls
    by_id = {r.id: r for r in spans.records()}
    for req, call in calls.items():
        assert prep[req].thread != main and call.thread == main
        assert prep[req].end <= call.start
        assert prep[req].attrs["proteins"] > 0
    for name in ("apply.upload", "apply.run", "apply.decode"):
        for r in got[name]:
            assert by_id[r.parent].name == "apply.call"
            assert r.request == by_id[r.parent].request


@pytest.mark.parametrize("route", ["flat", "rows"])
def test_upload_bytes_are_the_batches_nbytes(monkeypatch, route):
    from kmers_anno_tpu_torch.engine.apply_engine import FlatBatch

    cell = _apply_cell(monkeypatch, route)
    engine = cell.engine
    pegs, prepared = engine.prepare(cell.genomes[0])
    spans.enable()
    engine.call_prepared(pegs, prepared)
    ups = [r for r in spans.records() if r.name == "apply.upload"]
    if isinstance(prepared, FlatBatch):
        want = [prepared.codes.nbytes + prepared.seg_ids.nbytes
                + prepared.valid.nbytes]
    else:
        want = [b.codes.nbytes + b.valid.nbytes for b in prepared]
    assert [r.attrs["bytes"] for r in ups] == want


def _features(genome) -> list:
    return [(f.id, f.function, f.location.contig_id, f.location.strand,
             f.location.left, f.location.right) for f in genome.features]


def test_projection_same_on_and_off():
    out = []
    for on in (False, True, False):
        (spans.enable if on else spans.disable)()
        cell = _projection_cell()
        ids = cell.sets.next()
        got = []
        for _ in range(2):              # the close set cold, then cached
            genome = cell.request(ids)
            stats = cell.annot.annotate_genome(genome, cell.pool.get)
            got.append((stats, _features(genome)))
        out.append(got)
    assert out[0] == out[1] == out[2]
    assert out[0][0][0]["pegs"] > 0


@pytest.mark.parametrize("route", ["flat", "rows"])
def test_apply_same_on_and_off(monkeypatch, route):
    cell = _apply_cell(monkeypatch, route)
    out = []
    for on in (False, True):
        (spans.enable if on else spans.disable)()
        out.append([[(f.id, role, hits) for f, role, hits
                     in cell.engine.call_prepared(*cell.engine.prepare(g))]
                    for g in cell.genomes])
    assert out[0] == out[1] and any(out[0])
    assert spans.records()


# ----- kanbench's readers -----

def _rec(name, start, end, *, request=None, thread=1, attrs=None, rid=0,
         parent=None):
    return spans.Record(name, start, end, thread, rid, parent, request,
                        attrs or {})


def _trace(t0, t1, n_done, events=(), main=1):
    from kanbench import trace as tr

    rec = tr.Recorder(lambda: None)
    rec.main = main
    return tr.Trace(rec, list(events), t0, t1, {"n_done": n_done}, {})


def _reading_from(monkeypatch, records, dropped=0):
    from kanbench import inside

    monkeypatch.setattr(inside, "spans", SimpleNamespace(
        records=lambda: list(records), dropped=lambda: dropped))
    return inside


PROJ_WINDOW = [
    _rec("proj.annotate", 9.0, 10.5),              # ends in the window
    _rec("proj.close_set.union_keys", 9.5, 10.2),  # started before t0
    _rec("proj.annotate", 11.0, 13.0),
    _rec("proj.close_set.union_keys", 11.0, 11.4),
    _rec("proj.stream_index", 12.0, 12.1),
    _rec("proj.close_set.union_keys", 20.0, 20.5),  # ends past t1
    _rec("proj.close_set.union_keys", 1.0, 2.0),    # before the window
]


def test_inside_sums_the_spans_that_end_in_the_window(monkeypatch):
    inside = _reading_from(monkeypatch, PROJ_WINDOW)
    tt = _trace(10.0, 14.0, 2)
    assert inside.ms_per_genome(tt, ("proj.close_set.union_keys",)) == \
        pytest.approx(1e3 * (0.7 + 0.4) / 2)
    assert inside.ms_per_genome(
        tt, ("proj.stream_index", "proj.close_set.union_keys")) == \
        pytest.approx(1e3 * (0.7 + 0.4 + 0.1) / 2)


@pytest.mark.parametrize("case, want", [
    ("layer ran, span absent", 0.0),
    ("no layer span in the window", None),
    ("records dropped", None),
    ("no tracer in the program", None),
    ("no genome done", None),
])
def test_inside_reads_zero_or_none(monkeypatch, case, want):
    records = PROJ_WINDOW
    t1, n_done, dropped = 14.0, 2, 0
    if case == "no layer span in the window":
        t1 = 10.4
    elif case == "records dropped":
        dropped = 1
    elif case == "no genome done":
        n_done = 0
    inside = _reading_from(monkeypatch, records, dropped)
    if case == "no tracer in the program":
        monkeypatch.setattr(inside, "spans", None)
    tt = _trace(10.0, t1, n_done)
    assert inside.ms_per_genome(tt, ("proj.replay",)) == want
    assert inside.attr_per_genome(tt, "proj.replay", "stored") == want


def test_inside_attr_and_queue(monkeypatch):
    records = [
        _rec("apply.prepare", 0.5, 0.9, request=1, thread=2),  # before t0
        _rec("apply.call", 1.0, 1.1, request=1),
        _rec("apply.prepare", 1.0, 1.2, request=2, thread=3),
        _rec("apply.call", 1.5, 1.6, request=2),
        _rec("apply.upload", 1.5, 1.52, request=2, attrs={"bytes": 3 << 20}),
        _rec("apply.prepare", 1.1, 1.3, request=3, thread=2),
        _rec("apply.call", 1.7, 1.9, request=3),
        _rec("apply.upload", 1.7, 1.71, request=3, attrs={"bytes": 1 << 20}),
        _rec("apply.prepare", 1.8, 1.95, request=4, thread=3),  # no call
    ]
    inside = _reading_from(monkeypatch, records)
    tt = _trace(1.0, 2.0, 3)
    # requests 2 and 3 have both spans in the window: waits 0.3 and 0.4 s
    assert inside.queue_ms(tt) == pytest.approx(350.0)
    assert inside.attr_per_genome(tt, "apply.upload", "bytes") == \
        pytest.approx((4 << 20) / 3)
    only_calls = _reading_from(monkeypatch, [r for r in records
                                             if r.name == "apply.call"])
    assert only_calls.queue_ms(tt) is None


def test_inside_idle_by_span(monkeypatch):
    records = [
        _rec("apply.call", 1.0, 3.0),
        _rec("apply.run", 1.5, 2.5),
        _rec("apply.prepare", 0.0, 10.0, thread=7),    # another thread
        _rec("apply.call", 6.0, 7.0),
    ]
    events = [("k", 0.0, 1.2), ("k", 1.6, 1.8), ("k", 5.0, 6.5),
              ("k", 9.5, 12.0)]
    inside = _reading_from(monkeypatch, records)
    tt = _trace(0.5, 10.0, 2, events)
    # idle: 1.2-1.6 (mid 1.4, in call), 1.8-5.0 (mid 3.4, outside),
    # 6.5-9.5 (mid 8.0, outside)
    got = inside.idle_by_span(tt)
    assert got == pytest.approx({"outside the traced spans": 3.2 + 3.0,
                                 "apply.call": 0.4})
    assert list(got)[0] == "outside the traced spans"
    nested = _reading_from(monkeypatch, records + [
        _rec("apply.decode", 2.6, 2.9)])
    tt = _trace(0.5, 10.0, 2, [("k", 0.0, 2.6), ("k", 2.8, 10.0)])
    # idle 2.6-2.8, mid 2.7: inside apply.decode, inside apply.call
    assert nested.idle_by_span(tt) == pytest.approx({"apply.decode": 0.2})
    assert _reading_from(monkeypatch, records).idle_by_span(
        _trace(0.5, 10.0, 2)) == {}


def test_inside_turns_the_tracer_on():
    assert spans.span("x") is spans.span("x")
    from kanbench import inside

    assert inside.spans is spans
    assert spans.span("x") is not spans.span("x")


# ----- one clock with the device -----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda:0")


CLOCK_SCRIPT = """
import json, time, torch
from kanbench.trace import Profile
from kmers_anno_tpu_torch.utils import spans

card = torch.device("cuda:0")

def sync():
    torch.cuda.synchronize(card)

spans.enable()
profile = Profile(torch, sync)
with spans.span("test.kernel"):
    time.sleep(0.001)
    torch.cuda._sleep(20_000_000)
    sync()
    time.sleep(0.001)
events = profile.stop()
(rec,) = [r for r in spans.records() if r.name == "test.kernel"]
print(json.dumps({"span": [rec.start, rec.end],
                  "spins": [e[1:] for e in events if "spin_kernel" in e[0]]}))
"""


@pytest.mark.cuda
def test_span_holds_its_kernel_on_the_host_clock(card):
    """A kernel launched inside a span, the span closed after a
    synchronise, lies inside the span as ``kanbench.trace.Profile`` maps
    the device's clock onto the host's.  Run in a process of its own, so
    that its profiler session is that process's only one."""
    import subprocess

    out = subprocess.run([sys.executable, "-c", CLOCK_SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    (start, end), spins = got["span"], got["spins"]
    assert len(spins) == 1, got
    k_start, k_end = spins[0]
    assert start < k_start < k_end < end
    assert k_end - k_start > 0.5 * (end - start - 0.002)
