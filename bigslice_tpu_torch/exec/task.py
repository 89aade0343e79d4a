"""The task model: compiled units of work with observable runtime state.

A Task is a named node in the compiled DAG with a ``do`` closure
(composed slice readers), dependencies on other tasks' partitioned
outputs, and a lock + condition runtime state that the evaluator and
executors coordinate through. State magnitudes order task progression:
INIT < WAITING < RUNNING < OK < ERR < LOST.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from bigslice_tpu_torch.utils import metrics as metrics_mod


class TaskState(enum.IntEnum):
    INIT = 0
    WAITING = 1
    RUNNING = 2
    OK = 3
    ERR = 4
    LOST = 5


class TaskError(Exception):
    """A task failed fatally; ``cause`` is the error it failed with."""

    def __init__(self, task: "Task", cause: BaseException):
        self.task = task
        self.cause = cause
        super().__init__(f"task {task.name}: {cause!r}")


@dataclasses.dataclass(frozen=True)
class TaskName:
    """Unique task identity."""

    inv_index: int
    op: str
    shard: int
    num_shard: int

    def __str__(self) -> str:
        return f"inv{self.inv_index}/{self.op}@{self.num_shard}:{self.shard}"


@dataclasses.dataclass(frozen=True)
class TaskDep:
    """A consumer's view of producer tasks' outputs: this task reads
    partition ``partition`` from every task in ``tasks``.

    expand:      merge partition streams by key instead of concatenating
                 (Reduce semantics).
    combine_key: nonempty when the producers share one machine-level
                 combiner buffer (``Session(machine_combiners=True)``).
    """

    tasks: Tuple["Task", ...]
    partition: int
    expand: bool = False
    combine_key: str = ""


class Partitioner:
    """Output partition configuration for a task: how many partitions,
    the partition function, an optional map-side combiner, and the
    machine combiner's key."""

    def __init__(self, num_partition: int = 1, partition_fn=None,
                 combiner=None, combine_key: str = ""):
        self.num_partition = num_partition
        self.partition_fn = partition_fn
        self.combiner = combiner  # FrameCombiner
        self.combine_key = combine_key

    def partition_ids(self, frame, nparts: int):
        """Each row's output partition: a per-row device partitioner
        (``RowPartitioner``) runs over the key columns on their device;
        a frame-level host partitioner ``fn(frame, nparts) ->
        int32[n]`` gets the frame's host copy; with none, the routing
        hash (``Frame.partition_ids``)."""
        from bigslice_tpu_torch.ops.reshuffle import RowPartitioner

        fn = self.partition_fn
        if fn is None:
            return frame.partition_ids(nparts)
        if isinstance(fn, RowPartitioner):
            return fn(frame, nparts)
        return fn(frame.to_host(), nparts)


class Task:
    """A compiled, runnable node of the task graph."""

    def __init__(
        self,
        name: TaskName,
        do: Callable,  # fn(dep_reader_factories) -> Reader
        deps: Sequence[TaskDep],
        partitioner: Partitioner,
        schema,
        procs: int = 1,
        exclusive: bool = False,
    ):
        self.name = name
        self.do = do
        self.deps = tuple(deps)
        self.partitioner = partitioner
        self.schema = schema
        # The local executor's permits: ``procs`` of them, or all of
        # them when ``exclusive`` (the slice's pragmas).
        self.procs = procs
        self.exclusive = exclusive
        # Structural metadata set by the compiler: the fused slice chain
        # (outermost first) and an op-group key shared by all shards of
        # the same compiled op (the executor runs a group as waves).
        self.chain = None
        self.group_key = None

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._state = TaskState.INIT
        self.error: Optional[BaseException] = None
        self._subs: List[Callable] = []
        self.consecutive_lost = 0
        # User counters incremented by this task's functions (merged
        # into its Result's scope).
        self.scope = metrics_mod.Scope()
        # Monotonic stamp of each state's latest entry, taken inside
        # the transition before subscribers run: the telemetry hub's
        # task durations.
        self.state_times: Dict[TaskState, float] = {}

    @property
    def num_partition(self) -> int:
        return self.partitioner.num_partition

    @property
    def combiner(self):
        return self.partitioner.combiner

    # -- state protocol ---------------------------------------------------

    @property
    def state(self) -> TaskState:
        with self._lock:
            return self._state

    def set_state(self, state: TaskState,
                  error: Optional[BaseException] = None) -> None:
        with self._lock:
            self._state = state
            self.state_times[state] = time.monotonic()
            if error is not None:
                self.error = error
            if state == TaskState.OK:
                self.error = None
            subs = list(self._subs)
            self._cond.notify_all()
        for fn in subs:
            fn(self, state)

    def transition_if(self, frm: TaskState, to: TaskState) -> bool:
        """Atomically advance frm→to; returns False if state changed."""
        with self._lock:
            if self._state != frm:
                return False
            self._state = to
            self.state_times[to] = time.monotonic()
            self._cond.notify_all()
            subs = list(self._subs)
        for fn in subs:
            fn(self, to)
        return True

    def mark_ok(self) -> None:
        with self._lock:
            self.consecutive_lost = 0
        self.set_state(TaskState.OK)

    def mark_lost(self, error: Optional[BaseException] = None) -> None:
        """Record a loss (missing output); the evaluator resubmits lost
        tasks up to a consecutive-loss cap."""
        with self._lock:
            self.consecutive_lost += 1
        self.set_state(TaskState.LOST, error)

    def subscribe(self, fn: Callable) -> None:
        """fn(task, state) on every transition."""
        with self._lock:
            self._subs.append(fn)

    def unsubscribe(self, fn: Callable) -> None:
        with self._lock:
            try:
                self._subs.remove(fn)
            except ValueError:
                pass

    def __repr__(self) -> str:
        return f"Task({self.name}, {self.state.name})"


def iter_tasks(roots: Sequence[Task]) -> List[Task]:
    """Post-order DFS over the task graph, each task once (iterative, so
    deep pipelines do not hit the recursion limit)."""
    seen = set()
    out: List[Task] = []
    for r in roots:
        if id(r) in seen:
            continue
        stack: List[Tuple[Task, bool]] = [(r, False)]
        while stack:
            t, expanded = stack.pop()
            if expanded:
                out.append(t)
                continue
            if id(t) in seen:
                continue
            seen.add(id(t))
            stack.append((t, True))
            # Reversed so the first dep is visited first in post-order.
            for dep in reversed(t.deps):
                for d in reversed(dep.tasks):
                    if id(d) not in seen:
                        stack.append((d, False))
    return out
