"""Chrome-trace-format session tracing.

Task lifecycles are collected as Chrome trace "X" (complete) events:
executors are "processes", concurrent tasks take virtual thread lanes,
and session events are instants. ``Session(trace_path=...)`` writes one
JSON file at shutdown, which ``chrome://tracing`` and Perfetto load.
Kernel-level timing comes from ``torch.profiler`` (``utils/xprof.py``);
this file shows task-level scheduling.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List


class Tracer:
    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._open: Dict[str, dict] = {}
        self._tids: Dict[str, int] = {}
        self._free_tids: List[int] = []
        # Fresh lanes come from a monotonic allocator: deriving one from
        # len(_tids) + 1 collides with a live lane once a re-begun key
        # has overwritten its _tids entry (its old lane is never freed).
        self._next_tid = 1
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def begin(self, key: str, name: str, pid: str = "executor",
              **args) -> None:
        with self._lock:
            if self._free_tids:
                tid = self._free_tids.pop()
            else:
                tid = self._next_tid
                self._next_tid += 1
            self._tids[key] = tid
            self._open[key] = {
                "name": name,
                "pid": pid,
                "tid": tid,
                "ts": self._now_us(),
                "args": args,
            }

    def end(self, key: str, **args) -> None:
        with self._lock:
            ev = self._open.pop(key, None)
            if ev is None:
                return
            tid = self._tids.pop(key, 1)
            self._free_tids.append(tid)
            ev["args"].update(args)
            # Begin and end coalesce into one complete event.
            self._events.append({
                "name": ev["name"],
                "ph": "X",
                "pid": ev["pid"],
                "tid": ev["tid"],
                "ts": ev["ts"],
                "dur": self._now_us() - ev["ts"],
                "args": ev["args"],
            })

    def instant(self, name: str, pid: str = "session", **args) -> None:
        with self._lock:
            self._events.append({
                "name": name,
                "ph": "i",
                "pid": pid,
                "tid": 0,
                "ts": self._now_us(),
                "s": "g",
                "args": args,
            })

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def save(self, path: str) -> None:
        with open(path, "w") as fp:
            json.dump({"traceEvents": self.events()}, fp, default=str)


class TaskTraceMonitor:
    """An evaluator monitor recording task state transitions as trace
    events (chained by the session when ``trace_path`` is set)."""

    def __init__(self, tracer: Tracer):
        self.tracer = tracer

    def __call__(self, task, state) -> None:
        from bigslice_tpu_torch.exec.task import TaskState

        key = str(task.name)
        if state == TaskState.RUNNING:
            self.tracer.begin(key, task.name.op, pid="tasks",
                              shard=task.name.shard,
                              shards=task.name.num_shard,
                              inv=task.name.inv_index)
        elif state in (TaskState.OK, TaskState.ERR, TaskState.LOST):
            self.tracer.end(key, state=state.name)
