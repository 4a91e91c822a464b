"""What a traced run records, and the arithmetic its metrics share.

A traced run wraps calls into the program's layers in host-clock spans
(each ending in a device synchronise unless the layer is host work run in
another thread), counts and samples the calls that launch each kernel a
per-layer metric counts, and records the device's activity with
``torch.profiler``.  An untraced run installs none of it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import threading
import time
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
SAMPLED_CALLS = 48              # launches a kernel whose inputs are counted
MARK_CYCLES = 2_000_000         # the alignment kernel's spin


def resolve(cell, target: str):
    """``cell.<attr>`` names an attribute of the cell; anything else a
    module of the program."""
    if target.startswith("cell."):
        obj = cell
        for part in target.split(".")[1:]:
            obj = getattr(obj, part)
        return obj
    return importlib.import_module(target)


def load_module(kind: str, name: str):
    """``kanbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"kanbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = f"kanbench.{kind}"
    spec.loader.exec_module(mod)
    return mod


class Recorder:
    """Spans and sampled launches, installed by wrapping attributes and
    undone by ``restore``."""

    def __init__(self, sync, clock=time.perf_counter):
        self.sync, self.clock = sync, clock
        self.spans: dict = defaultdict(list)    # name -> [(t0, t1, thread)]
        self.calls: dict = defaultdict(int)     # count name -> calls
        self.sampled: dict = defaultdict(list)  # count name -> [(a, kw)]
        self.main = threading.get_ident()
        self._undo: list = []

    def _patch(self, obj, attr, fn) -> None:
        had = attr in vars(obj)
        self._undo.append((obj, attr, getattr(obj, attr), had))
        setattr(obj, attr, fn)

    def span(self, obj, attr: str, name: str, sync: bool) -> None:
        orig = getattr(obj, attr)

        def wrapper(*a, **kw):
            t0 = self.clock()
            try:
                return orig(*a, **kw)
            finally:
                if sync:
                    self.sync()
                self.spans[name].append((t0, self.clock(),
                                         threading.get_ident()))

        self._patch(obj, attr, wrapper)

    def launches(self, obj, attr: str, name: str) -> None:
        orig = getattr(obj, attr)

        def wrapper(*a, **kw):
            # a call that launches nothing (no input) is not counted: the
            # program's wrappers count their launches in ``launches``
            before = getattr(orig, "launches", None)
            out = orig(*a, **kw)
            if before is None or getattr(orig, "launches") > before:
                if self.calls[name] < SAMPLED_CALLS:
                    self.sampled[name].append((a, kw))
                self.calls[name] += 1
            return out

        self._patch(obj, attr, wrapper)

    def restore(self) -> None:
        for obj, attr, orig, had in reversed(self._undo):
            if had:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
        self._undo = []


class Profile:
    """The device's activity over the window, from ``torch.profiler``, and
    the offset that puts its clock on the host's (a spin kernel timed from
    the host just before the window)."""

    def __init__(self, torch, sync, clock=time.perf_counter):
        from torch.profiler import ProfilerActivity, profile

        self.torch, self.sync, self.clock = torch, sync, clock
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        sync()
        self.torch.cuda._sleep(MARK_CYCLES)
        self.sync()
        self.mark_end = clock()

    def stop(self) -> list:
        """Device events as (name, start s, end s) on the host clock."""
        from torch.autograd import DeviceType

        self.sync()
        self.prof.stop()
        raw = [(e.name(), e.start_ns(), e.end_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        spins = [r for r in raw if "spin_kernel" in r[0]]
        if not spins:
            return []
        end = spins[0][2]
        events = [(_short(n), self.mark_end + (s - end) / 1e9,
                   self.mark_end + (e - end) / 1e9) for n, s, e in raw]
        return [ev for ev in events if ev[1] >= self.mark_end]


def _short(name: str) -> str:
    """A kernel's name without its namespace's '(anonymous namespace)::'
    and its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return name[:cut] if cut > 0 else name


def union_length(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


class Trace:
    """What the per-layer metrics read: the spans, the sampled launches,
    the device's events inside the window, and what the window returned
    (its genomes completed and its host-clock readings)."""

    def __init__(self, recorder: Recorder, events: list, t0: float,
                 t1: float, window: dict, peaks: dict):
        self.spans = recorder.spans
        self.calls = recorder.calls
        self.sampled = recorder.sampled
        self.main = recorder.main
        self.t0, self.t1 = t0, t1
        self.window_s = t1 - t0
        self.window = window            # what the cell's window returned
        self.n_done = window["n_done"]
        self.peaks = peaks
        self.events = [(n, max(s, t0), min(e, t1)) for n, s, e in events
                       if e > t0 and s < t1]
        self.busy_s = union_length((s, e) for _, s, e in self.events)

    # ----- spans -----

    def span_s(self, name: str) -> float | None:
        got = self.spans.get(name)
        return None if not got else sum(t1 - t0 for t0, t1, _ in got)

    def span_ms_per_genome(self, name: str) -> float | None:
        s = self.span_s(name)
        return None if s is None or not self.n_done else 1e3 * s / self.n_done

    def self_ms_per_genome(self, name: str, children) -> float | None:
        """A span's time less the part of it its child spans cover."""
        outer = self.spans.get(name)
        if not outer or not self.n_done:
            return None
        inner = [(t0, t1) for c in children
                 for t0, t1, _ in self.spans.get(c, ())]
        total = 0.0
        for t0, t1, _ in outer:
            covered = union_length((max(a, t0), min(b, t1))
                                   for a, b in inner if b > t0 and a < t1)
            total += (t1 - t0) - covered
        return 1e3 * total / self.n_done

    # ----- the device -----

    def idle_pct(self) -> float | None:
        if not self.events:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_times(self, kernels) -> dict:
        """Each kernel's event durations in launch order."""
        out = {k: [] for k in kernels}
        for n, s, e in sorted(self.events, key=lambda ev: ev[1]):
            if n in out:
                out[n].append(e - s)
        return out

    def roofline_pct(self, count_name: str) -> float | None:
        """The counted launches' least time over their measured time: the
        bound of each sampled call's inputs (bytes over the memory rate or
        operations over the integer rate, the larger) against the time of
        the kernels that call launched."""
        count = load_module("counts", count_name)
        n_calls = self.calls.get(count_name, 0)
        times = self.kernel_times(count.KERNELS)
        if not n_calls or any(len(t) != n_calls for t in times.values()):
            return None
        bound = spent = 0.0
        for i, (a, kw) in enumerate(self.sampled[count_name]):
            n_bytes, n_ops = count.count(*a, **kw)
            bound += max(n_bytes / self.peaks["hbm_bytes_per_s"],
                         n_ops / self.peaks["int32_ops_per_s"])
            spent += sum(t[i] for t in times.values())
        return 100.0 * bound / spent if spent > 0 else None

    def breakdown(self) -> dict:
        """The device operations that took the most time, and the longest
        idle stretches by the innermost main-thread span open across
        them."""
        by_op: dict = defaultdict(float)
        for n, s, e in self.events:
            by_op[n] += e - s
        busy = sorted((s, e) for _, s, e in self.events)
        gaps, cursor = [], self.t0
        for s, e in busy:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if cursor < self.t1:
            gaps.append((cursor, self.t1))
        by_span: dict = defaultdict(float)
        for name, g0, g1 in _innermost(gaps, [
                (t0, t1, n) for n, got in self.spans.items()
                for t0, t1, th in got if th == self.main]):
            by_span[name] += g1 - g0
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in idle]}


def _innermost(gaps, spans):
    """Each gap with the innermost span open at its middle (spans of one
    thread nest or are disjoint): a sweep over span ends and gap
    middles."""
    marks = []
    for t0, t1, n in spans:
        marks.append((t0, 1, n))
        marks.append((t1, 0, n))
    for g0, g1 in gaps:
        marks.append((0.5 * (g0 + g1), 2, (g0, g1)))
    stack: list = []
    for _, kind, what in sorted(marks, key=lambda m: (m[0], m[1])):
        if kind == 1:
            stack.append(what)
        elif kind == 0:
            if what in stack:
                stack.reverse()
                stack.remove(what)
                stack.reverse()
        else:
            yield (stack[-1] if stack else "outside the traced spans",
                   *what)


def peaks() -> dict:
    return json.loads((HERE / "peaks.json").read_text())
