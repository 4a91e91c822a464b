"""Counting maps (contract of the reference tool's external CountMap /
QualityCountMap: count/getCount/size/counts/sortedCounts/deleteAll/
getSingletons; setGood/setBad/good/bad).  A copy of the reference
package's ``utils/counters.py``."""

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


class QualityCountMap(Generic[K]):
    """Tracks good and bad occurrence counts per key
    (CompareFunctions.java:59-64)."""

    def __init__(self) -> None:
        self._good: Counter = Counter()
        self._bad: Counter = Counter()

    def set_good(self, key: K) -> None:
        self._good[key] += 1

    def set_bad(self, key: K) -> None:
        self._bad[key] += 1

    def good(self, key: K) -> int:
        return self._good.get(key, 0)

    def bad(self, key: K) -> int:
        return self._bad.get(key, 0)

    def all_keys(self) -> set[K]:
        return set(self._good) | set(self._bad)

    def best_keys(self) -> list[K]:
        """Keys sorted by descending good count."""
        return sorted(self.all_keys(), key=lambda k: -self.good(k))
