"""The framework's own counters (rows read and written, tasks run,
spills), named and polled into the status display and the Prometheus
export. User metrics live in ``utils/metrics.py``."""

from __future__ import annotations

import threading
from typing import Dict


class Map:
    """A set of named counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values: Dict[str, int] = {}

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._values[name] = self._values.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._values.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._values)

    def __repr__(self):
        parts = ", ".join(
            f"{k}={v}" for k, v in sorted(self.snapshot().items())
        )
        return f"stats({parts})"


# Process-wide executor stats.
DEFAULT = Map()
