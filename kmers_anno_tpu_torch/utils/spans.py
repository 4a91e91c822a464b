"""Spans of the program's own steps, on the host's clock.

    with spans.span("apply.call", request=batch.request) as sp:
        ...
        sp.set(bytes=n)

Off by default: ``span`` then returns one shared object that records
nothing, so a span site costs a flag test and a call.  ``enable()`` turns
recording on for the whole process, ``disable()`` off again.

Each record holds the span's name, its start and end on
``time.perf_counter`` (the clock onto which a benchmark maps the device's
events), the thread it ran on, its own id and its parent's (the span open
on the same thread when it opened), a request id (given, or else the
parent's; ``request()`` makes a fresh one) and the small integer
attributes set while it was open.  Records are kept in memory only, in
one append-only list of at most ``CAP``; past the cap a span is counted
in ``dropped()`` and not kept.  A span never waits for the device: it
measures host time, and the device's side comes from a device trace.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

CAP = 1 << 20               # records kept; later spans are only counted


class Record(NamedTuple):
    name: str
    start: float            # time.perf_counter seconds
    end: float
    thread: int             # threading.get_ident() of the span's thread
    id: int
    parent: int | None      # id of the span open around it on its thread
    request: int | None
    attrs: dict             # attribute name -> int


_on = False
_records: list = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()


class _Off:
    """What ``span`` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "request", "attrs", "id", "parent", "start")

    def __init__(self, name: str, request: int | None):
        self.name, self.request, self.attrs = name, request, {}

    def set(self, **attrs) -> None:
        for key, value in attrs.items():
            self.attrs[key] = int(value)

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer is not None else None
        if self.request is None and outer is not None:
            self.request = outer.request
        self.id = next(_ids)
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter()
        _stack().pop()
        _keep(Record(self.name, self.start, end, threading.get_ident(),
                     self.id, self.parent, self.request, self.attrs))
        return False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _keep(record: Record) -> None:
    global _dropped
    with _lock:
        if len(_records) < CAP:
            _records.append(record)
        else:
            _dropped += 1


def span(name: str, request: int | None = None):
    """A context manager timing the block it encloses (see the module's
    docstring); ``set(**ints)`` on it records attributes."""
    if not _on:
        return _OFF
    return _Span(name, request)


def request() -> int:
    """A fresh request id."""
    return next(_requests)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def records() -> list[Record]:
    """The records kept so far, in the order their spans ended."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Spans that ended past the cap and were not kept."""
    return _dropped


def clear() -> None:
    """Forget every record and the dropped count."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
