"""hashAnno's spans (``kmers_anno_tpu_torch.engine.hashanno`` under
``kmers_anno_tpu_torch.utils.spans``): the seven ``hash.*`` names, their
nesting under ``hash.batch`` and their attributes, the rows the same with
the tracer on and off, one launch of each chunk kernel a chunk, and the
benchmark's readers of the spans (``kanbench/hash_spans.py``) on made-up
records.

The data are the benchmark's hashAnno generator at a small size.  The
file imports no jax; its last test needs a card (``cuda``) and skips here.
``kanbench.hash_spans`` turns the tracer on when imported, so it is
imported inside the tests, and every test leaves the tracer off and empty.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from kanbench.systems import hashanno as cell_mod
from kmers_anno_tpu_torch.engine import hashanno
from kmers_anno_tpu_torch.genome.gto import Genome
from kmers_anno_tpu_torch.utils import spans

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(pegs_per_genome=40, prototypes=512, pool_genomes=4,
             annotations=64)
SEED = 2**33 + 29
NAMES = {"hash.batch", "hash.register", "hash.index", "hash.protos",
         "hash.score", "hash.pull", "hash.emit"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module's tests run: the suite runs
    several workers, and their threads would outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def tracer_off():
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()
    # importing kanbench.hash_spans (and with it kanbench.inside) turns
    # the tracer on: forget both modules, so that the next import in this
    # process turns it on again
    for name in ("hash_spans", "inside"):
        sys.modules.pop(f"kanbench.{name}", None)
        if "kanbench" in sys.modules:
            vars(sys.modules["kanbench"]).pop(name, None)


@pytest.fixture(scope="module")
def small():
    conf = json.loads((ROOT / "kanbench" / "configs"
                       / "hashanno_k8_p32k.json").read_text())
    config = dict(conf, **SMALL)
    return config, cell_mod.make_data(config, SEED)


def _protoset(config, data):
    return hashanno.PrototypeSet(
        [hashanno.Prototype(p, a) for p, a in data["prototypes"]],
        config["k"])


def _run(config, data, pset, device="cpu"):
    genomes = [Genome(cell_mod.genome_raw(f)) for f in data["batches"][0]]
    return hashanno.annotate_genomes_batched(
        genomes, pset, config["k"], config["min_sim"], device=device)


def _by_name(records) -> dict:
    out: dict = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_a_batch_records_the_hash_tree(small):
    config, data = small
    pset = _protoset(config, data)
    spans.enable()
    out = _run(config, data, pset)
    recs = spans.records()
    got = _by_name(recs)
    assert set(got) == NAMES
    assert all(len(v) == 1 for v in got.values())
    one = {name: v[0] for name, v in got.items()}
    root = one["hash.batch"]
    assert root.parent is None and root.request is not None
    for r in recs:
        assert r.request == root.request
        if r is not root:
            assert r.parent == root.id, r.name
            assert root.start <= r.start <= r.end <= root.end
    order = ["hash.register", "hash.index", "hash.protos", "hash.score",
             "hash.pull", "hash.emit"]
    for a, b in zip(order, order[1:]):
        assert one[a].end <= one[b].start, (a, b)
    (chunks,) = pset._cache.values()
    n_dist = len({p for g in data["batches"][0] for _, _, p in g
                  if p and "*" not in p})
    attrs = {name: r.attrs for name, r in one.items()}
    assert attrs["hash.batch"] == {"genomes": 4, "proteins": n_dist}
    idx = attrs["hash.index"]
    assert idx["kmers"] > 0 and idx["heavy"] == 0
    assert idx["buckets"] > 0 and idx["buckets"] & (idx["buckets"] - 1) == 0
    assert attrs["hash.score"] == {"chunks": len(chunks)}
    assert attrs["hash.protos"] == {
        "chunks": len(chunks), "kmers": sum(int(c[4].sum()) for c in chunks)}
    assert attrs["hash.register"] == attrs["hash.pull"] == \
        attrs["hash.emit"] == {}
    assert sum(s["features"] for _, _, s in out) == 4 * 40
    # the prototypes packed: a second batch finds them cached
    spans.clear()
    _run(config, data, pset)
    assert set(_by_name(spans.records())) == NAMES - {"hash.protos"}


def test_the_host_route_records_its_chunk_loop(small, monkeypatch):
    config, data = small
    pset = _protoset(config, data)
    _run(config, data, pset)                    # the prototypes packed
    monkeypatch.setattr(hashanno, "MAX_DEVICE_LEN", 10)
    before = hashanno.GenomeProteinKmers.host_route
    spans.enable()
    _run(config, data, pset)
    got = _by_name(spans.records())
    assert set(got) == NAMES - {"hash.protos", "hash.pull"}
    assert got["hash.score"][0].attrs["chunks"] >= 1
    assert hashanno.GenomeProteinKmers.host_route == before + 1


def test_rows_the_same_on_and_off(small):
    config, data = small
    out = []
    for on in (False, True, False):
        (spans.enable if on else spans.disable)()
        out.append(_run(config, data, _protoset(config, data)))
    assert out[0] == out[1] == out[2]
    assert any(rows for rows, _, _ in out[0])


def test_one_launch_of_each_kernel_a_chunk(small, monkeypatch):
    """Each chunk calls each chunk step once (on the CPU their plain
    versions, which count no launch)."""
    config, data = small
    calls = {"hash_commons": 0, "hash_best": 0}
    for name in calls:
        real = getattr(hashanno, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(hashanno, name, spy)
    pset = _protoset(config, data)
    spans.enable()
    for _ in range(2):
        _run(config, data, pset)
    scores = [r for r in spans.records() if r.name == "hash.score"]
    n_chunks = sum(r.attrs["chunks"] for r in scores)
    assert len(scores) == 2 and n_chunks == 2 * len(
        next(iter(pset._cache.values())))
    assert calls == {"hash_commons": n_chunks, "hash_best": n_chunks}


# ----- kanbench's readers -----

def _rec(name, start, end, attrs=None):
    return spans.Record(name, start, end, 1, 0, None, None, attrs or {})


def _trace(t0, t1, n_done):
    from kanbench import trace as tr

    return tr.Trace(tr.Recorder(lambda: None), [], t0, t1,
                    {"n_done": n_done}, {})


def _reader(monkeypatch, records, dropped=0):
    from kanbench import hash_spans

    monkeypatch.setattr(hash_spans.inside, "spans", SimpleNamespace(
        records=lambda: list(records), dropped=lambda: dropped))
    return hash_spans


WINDOW = [
    _rec("hash.index", 8.0, 9.0),              # before the window
    _rec("hash.batch", 9.0, 10.5),              # ends in the window
    _rec("hash.index", 9.2, 10.1),              # started before t0
    _rec("hash.batch", 11.0, 13.0),
    _rec("hash.register", 11.0, 11.1),
    _rec("hash.index", 11.1, 11.6),
    _rec("hash.score", 11.6, 11.7),
    _rec("hash.pull", 11.7, 11.9),
    _rec("hash.emit", 11.9, 12.2),
    _rec("hash.index", 20.0, 20.5),             # ends past t1
]


def test_hash_spans_sum_what_ends_in_the_window(monkeypatch):
    from kanbench import trace as tr

    hs = _reader(monkeypatch, WINDOW)
    tt = _trace(10.0, 14.0, 8)
    assert hs.ms_per_genome(tt, ("hash.index",)) == \
        pytest.approx(1e3 * (0.9 + 0.5) / 8)
    assert hs.ms_per_genome(tt, ("hash.score", "hash.pull")) == \
        pytest.approx(1e3 * 0.3 / 8)
    for name, want in (("hash_index_ms", 1.4), ("hash_score_ms", 0.3),
                       ("hash_rows_ms", 0.4)):
        metric = tr.load_module("metrics", name)
        monkeypatch.setattr(metric, "hash_spans", hs)
        assert metric.read(tt) == pytest.approx(1e3 * want / 8)


@pytest.mark.parametrize("case, want", [
    ("layer ran, span absent", 0.0),
    ("no batch in the window", None),
    ("records dropped", None),
    ("no tracer in the program", None),
    ("no genome done", None),
])
def test_hash_spans_read_zero_or_none(monkeypatch, case, want):
    t1, n_done, dropped = 14.0, 8, 0
    if case == "no batch in the window":
        t1 = 10.4
    elif case == "records dropped":
        dropped = 1
    elif case == "no genome done":
        n_done = 0
    hs = _reader(monkeypatch, [r for r in WINDOW if r.name != "hash.pull"],
                 dropped)
    if case == "no tracer in the program":
        monkeypatch.setattr(hs.inside, "spans", None)
    assert hs.ms_per_genome(_trace(10.0, t1, n_done), ("hash.pull",)) == want


def test_hash_spans_turn_the_tracer_on():
    assert spans.span("x") is spans.span("x")
    from kanbench import hash_spans

    assert hash_spans.inside.spans is spans
    assert hash_spans.inside.LAYERS["hash"] == "hash.batch"
    assert spans.span("x") is not spans.span("x")


# ----- the launch counters on the card -----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_launch_counters_count_the_chunks_on_the_card(small, card):
    from kmers_anno_tpu_torch.ops.hash_chunk import hash_best, hash_commons

    config, data = small
    pset = _protoset(config, data)
    _run(config, data, pset, card)
    before = (hash_commons.launches, hash_best.launches)
    spans.enable()
    got = _run(config, data, pset, card)
    (score,) = [r for r in spans.records() if r.name == "hash.score"]
    n = score.attrs["chunks"]
    assert (hash_commons.launches, hash_best.launches) == \
        (before[0] + n, before[1] + n)
    spans.disable()
    assert got == _run(config, data, pset, "cpu")
