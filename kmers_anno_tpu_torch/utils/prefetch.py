"""Background prefetching over host-side loaders (a copy of the reference
package's ``utils/prefetch.py``).

Wrapping a genome iterator in a Prefetcher overlaps the next genome's host
work (GTO JSON parse, batch encode) with the current genome's device
step.  The native C++ loader releases the GIL during encoding, so worker
threads give real parallelism.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")


class Prefetcher:
    """Iterate ``items``, applying ``load`` in background threads.

    Results are yielded strictly in input order; at most ``depth`` loaded
    items are held ahead of the consumer.  Exceptions in workers propagate
    to the consuming thread at the failing item's position.
    """

    def __init__(self, items: Iterable[T], load: Callable[[T], U],
                 depth: int = 4, workers: int = 2):
        self._items = list(items)
        self._load = load
        self._depth = max(1, depth)
        self._workers = max(1, min(workers, len(self._items) or 1))

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator:
        n = len(self._items)
        if n == 0:
            return
        slots: dict[int, object] = {}
        cond = threading.Condition()
        next_idx = [0]          # next index a worker should claim
        done_upto = [0]         # next index the consumer will take
        errors: dict[int, BaseException] = {}

        def worker():
            while True:
                with cond:
                    # claim the next item, but never run more than `depth`
                    # ahead of the consumer
                    while (next_idx[0] < n
                           and next_idx[0] - done_upto[0] > self._depth):
                        cond.wait()
                    i = next_idx[0]
                    if i >= n:
                        return
                    next_idx[0] = i + 1
                try:
                    res = self._load(self._items[i])
                except BaseException as exc:  # propagated to the consumer
                    with cond:
                        errors[i] = exc
                        cond.notify_all()
                else:
                    with cond:
                        slots[i] = res
                        cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self._workers)]
        for t in threads:
            t.start()
        try:
            for i in range(n):
                with cond:
                    while i not in slots and i not in errors:
                        cond.wait()
                    if i in errors:
                        raise errors.pop(i)
                    res = slots.pop(i)
                    done_upto[0] = i + 1
                    cond.notify_all()
                yield res
        finally:
            with cond:
                next_idx[0] = n     # stop workers claiming more
                done_upto[0] = n
                cond.notify_all()
            for t in threads:
                t.join(timeout=5)


def prefetch_map(items: Iterable[T], load: Callable[[T], U],
                 depth: int = 4, workers: int = 2) -> Iterator[U]:
    """Convenience: ordered background map over items."""
    return iter(Prefetcher(items, load, depth=depth, workers=workers))
