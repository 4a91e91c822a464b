"""Counting map (contract of the reference tool's external CountMap:
count/getCount/size/counts/sortedCounts/deleteAll/getSingletons).  A copy
of the reference package's ``utils/counters.py``, holding what the port
uses."""

from __future__ import annotations

from collections import Counter
from typing import Generic, Hashable, Iterable, TypeVar

K = TypeVar("K", bound=Hashable)


class CountMap(Generic[K]):
    """A hash of keys to occurrence counts."""

    def __init__(self) -> None:
        self._counts: Counter = Counter()

    def count(self, key: K, n: int = 1) -> int:
        self._counts[key] += n
        return self._counts[key]

    def get_count(self, key: K) -> int:
        return self._counts.get(key, 0)

    def size(self) -> int:
        return len(self._counts)

    def __len__(self) -> int:
        return len(self._counts)

    def keys(self) -> Iterable[K]:
        return self._counts.keys()

    def counts(self) -> list[tuple[K, int]]:
        return list(self._counts.items())

    def sorted_counts(self) -> list[tuple[K, int]]:
        """Entries sorted by descending count."""
        return sorted(self._counts.items(), key=lambda kv: -kv[1])

    def singletons(self) -> set[K]:
        """Keys whose count is exactly 1 (CountMap.getSingletons —
        KmerProcessor.java:322-324)."""
        return {k for k, v in self._counts.items() if v == 1}

    def delete_all(self) -> None:
        self._counts.clear()
