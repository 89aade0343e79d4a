"""Top-n accumulator: the n largest (score, item) pairs seen."""

from __future__ import annotations

import heapq
from typing import Any, Iterable, List, Tuple


class TopN:
    """Keeps the n largest (score, item) pairs seen."""

    def __init__(self, n: int):
        self.n = n
        self._heap: List[Tuple[float, int, Any]] = []
        self._tie = 0

    def add(self, score, item) -> None:
        self._tie += 1
        entry = (score, self._tie, item)
        if len(self._heap) < self.n:
            heapq.heappush(self._heap, entry)
        elif entry > self._heap[0]:
            heapq.heapreplace(self._heap, entry)

    def items(self) -> List[Tuple[Any, Any]]:
        """(score, item) pairs, largest first."""
        return [(s, it) for s, _, it in
                sorted(self._heap, reverse=True)]


def top_n(pairs: Iterable[Tuple[Any, Any]], n: int):
    t = TopN(n)
    for score, item in pairs:
        t.add(score, item)
    return t.items()
