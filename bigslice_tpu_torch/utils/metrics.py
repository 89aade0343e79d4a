"""User metrics: counters aggregated task → session.

Users create named counters in a process-wide registry; each task
carries a ``Scope`` of counter values, incremented from inside user
functions, and a session result's scope merges its tasks' scopes. A
lock guards each scope; values are plain ints.

A counter incremented inside a device-tier function would run once per
trace, not once per row, so the tier trace (``ops/mapops.py``) runs
user functions under a ``TraceProbe``: a function that touches a
counter runs on the host tier, where each increment is real.
"""

from __future__ import annotations

import contextvars
import threading
from typing import Dict, Optional

_registry_lock = threading.Lock()
_counters: list = []


class Counter:
    """A named user counter."""

    def __init__(self, name: str):
        self.name = name
        with _registry_lock:
            self.index = len(_counters)
            _counters.append(self)

    def incr(self, n: int = 1) -> None:
        scope = current_scope()
        if scope is not None:
            scope.incr(self, n)

    def value(self, scope: "Scope") -> int:
        return scope.value(self)

    def __repr__(self):
        return f"Counter({self.name})"


def new_counter(name: str) -> Counter:
    return Counter(name)


class Scope:
    """A set of counter values, mergeable."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values: Dict[int, int] = {}

    def incr(self, counter: Counter, n: int = 1) -> None:
        with self._lock:
            self._values[counter.index] = (
                self._values.get(counter.index, 0) + n
            )

    def value(self, counter: Counter) -> int:
        with self._lock:
            return self._values.get(counter.index, 0)

    def merge(self, other: "Scope") -> None:
        with other._lock:
            items = list(other._values.items())
        with self._lock:
            for k, v in items:
                self._values[k] = self._values.get(k, 0) + v

    def reset(self) -> None:
        with self._lock:
            self._values.clear()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                _counters[i].name: v for i, v in self._values.items()
            }


# The running task's scope, installed by the executors around each task
# body (and by the tier trace around its probe call).
_current: contextvars.ContextVar[Optional[Scope]] = contextvars.ContextVar(
    "bigslice_tpu_torch_metrics_scope", default=None
)


def current_scope() -> Optional[Scope]:
    return _current.get()


class TraceProbe(Scope):
    """The scope installed while the tier trace runs a user function
    over meta tensors: it records that the function touched a counter
    (and counts nothing), so the combinator refuses the device tier."""

    def __init__(self):
        super().__init__()
        self.touched = False

    def incr(self, counter: Counter, n: int = 1) -> None:
        self.touched = True


class scope_context:
    """Context manager installing a scope for user-function calls."""

    def __init__(self, scope: Scope):
        self.scope = scope
        self._token = None

    def __enter__(self):
        self._token = _current.set(self.scope)
        return self.scope

    def __exit__(self, *exc):
        _current.reset(self._token)
        return False
