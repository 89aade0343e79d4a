"""The evaluator: a concurrency-safe task DAG state machine.

Given root tasks and an executor, drive every reachable task to OK:

- tasks become runnable when all their dependencies are OK;
- LOST tasks (missing output) are resubmitted, re-running their
  producers;
- ``MAX_CONSECUTIVE_LOST`` consecutive losses turn a task fatal;
- concurrent evaluations of overlapping graphs coordinate purely
  through task state.

Scheduling is event-driven with dependency counting: each task carries
a pending-dependency count maintained from state-transition events; a
task whose count reaches zero while INIT/LOST is submitted. A coarse
safety sweep fails loudly on a stall instead of hanging.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence

from bigslice_tpu_torch.exec.task import (
    Task,
    TaskError,
    TaskState,
    iter_tasks,
)

MAX_CONSECUTIVE_LOST = 5

# Phase markers of the device executor's wave pipeline: a wave's inputs
# finished staging on the prefetcher, and its program was dispatched. A
# waved task stays RUNNING through every phase, so they ride their own
# monitor channel (notify_phase), not the (task, state) callback.
PHASE_WAVE_PREFETCH = "wavePrefetch"
PHASE_WAVE_COMPUTE = "waveCompute"


def notify_phase(monitor, task, phase: str, wave: int) -> None:
    """Deliver an executor phase event to a monitor that opts in with an
    ``on_phase(task, phase, wave)`` attribute (``utils/status.
    chain_monitors`` forwards to every member that has one); monitors
    of (task, state) alone are untouched. Exception-isolated: phase
    events fire from the prefetcher thread, where a raising monitor
    would otherwise poison the group's staging."""
    fn = getattr(monitor, "on_phase", None)
    if fn is not None:
        from bigslice_tpu_torch.utils.status import safe_monitor_call

        safe_monitor_call(fn, task, phase, wave, key=id(monitor))

# Safety-net sweep interval: the loop needs no polling, but a lost
# wakeup must fail loudly rather than hang.
SWEEP_SECS = 5.0

# How long a failed evaluation waits for its in-flight tasks to settle
# before it raises (and reports the ones that did not).
DRAIN_SECS = 30.0

_RESUBMITTABLE = (TaskState.INIT, TaskState.LOST)


def evaluate(executor, roots: Sequence[Task], monitor=None) -> None:
    """Evaluate the graph rooted at ``roots`` to completion.

    ``executor`` implements ``submit(task)`` (async: eventually moves the
    task from WAITING to a terminal state). ``monitor``, if given, hears
    ``monitor(task, state)`` on every transition of a task of the graph;
    an exception it raises is logged once (``safe_monitor_call``) and
    never fails the task."""
    _Evaluation(executor, roots, monitor).run()


class _Evaluation:
    def __init__(self, executor, roots, monitor=None):
        self.executor = executor
        self.monitor = monitor
        self.roots = list(roots)
        self.tasks = iter_tasks(roots)
        self.cond = threading.Condition()
        self.events: collections.deque = collections.deque()
        self.consumers: Dict[int, List[Task]] = {
            id(t): [] for t in self.tasks
        }
        self.dep_counts: Dict[int, int] = {}
        self.ok_seen: set = set()  # dep ids currently credited as OK

    def _wake(self, task: Task, state: TaskState) -> None:
        if self.monitor is not None:
            # It runs inside the transition, on the thread that made it:
            # a raising monitor must not fail the task or lose the wake.
            from bigslice_tpu_torch.utils.status import safe_monitor_call

            safe_monitor_call(self.monitor, task, state)
        with self.cond:
            self.events.append((task, state))
            self.cond.notify_all()

    def run(self) -> None:
        for t in self.tasks:
            t.subscribe(self._wake)
        try:
            self._run()
        finally:
            for t in self.tasks:
                t.unsubscribe(self._wake)

    def _build(self) -> List[Task]:
        """Initial pending counts from a one-read-per-task state
        snapshot taken AFTER subscribing; returns the initially
        submittable set."""
        snapshot = {id(t): t.state for t in self.tasks}
        for t in self.tasks:
            if snapshot[id(t)] == TaskState.OK:
                self.ok_seen.add(id(t))
        ready = []
        for t in self.tasks:
            pending = 0
            for dep in t.deps:
                for d in dep.tasks:
                    self.consumers[id(d)].append(t)
                    if snapshot[id(d)] != TaskState.OK:
                        pending += 1
            self.dep_counts[id(t)] = pending
            if pending == 0 and snapshot[id(t)] in _RESUBMITTABLE:
                ready.append(t)
        return ready

    def _on_event(self, task: Task, state: TaskState,
                  ready: List[Task]) -> Optional[Task]:
        """Update counts for one transition; append newly submittable
        tasks to ``ready``. Returns an ERR task if one surfaced."""
        if state == TaskState.ERR:
            return task
        tid = id(task)
        if state == TaskState.OK:
            if tid not in self.ok_seen:
                self.ok_seen.add(tid)
                for c in self.consumers.get(tid, ()):
                    cid = id(c)
                    self.dep_counts[cid] -= 1
                    if self.dep_counts[cid] == 0 and \
                            c.state in _RESUBMITTABLE:
                        ready.append(c)
        elif state == TaskState.LOST:
            if tid in self.ok_seen:
                # A previously-OK dep was lost: re-charge consumers.
                self.ok_seen.discard(tid)
                for c in self.consumers.get(tid, ()):
                    self.dep_counts[id(c)] += 1
            if self.dep_counts.get(tid, 1) == 0:
                ready.append(task)
        return None

    def _submit(self, task: Task) -> bool:
        """Submit if still runnable; enforce the consecutive-loss cap."""
        st = task.state
        if st not in _RESUBMITTABLE:
            return False
        if task.consecutive_lost >= MAX_CONSECUTIVE_LOST:
            task.set_state(
                TaskState.ERR,
                RuntimeError(
                    f"task {task.name} lost {task.consecutive_lost} "
                    f"consecutive times"
                ),
            )
            return False
        if task.transition_if(st, TaskState.WAITING):
            self.executor.submit(task)
            return True
        return False

    def _run(self) -> None:
        with self.cond:
            ready = self._build()
        # A task already fatal when evaluation starts surfaces at once:
        # no transition event will ever fire for it.
        err_task = next(
            (t for t in self.tasks if t.state == TaskState.ERR), None
        )
        while True:
            # Submit outside the lock (executors may call back inline).
            for t in ready:
                self._submit(t)
            ready = []
            with self.cond:
                while not self.events:
                    if all(r.state == TaskState.OK for r in self.roots):
                        return
                    if err_task is not None:
                        break
                    if not self.cond.wait(timeout=SWEEP_SECS):
                        self._sweep(ready)
                        if ready:
                            break
                while self.events:
                    task, state = self.events.popleft()
                    bad = self._on_event(task, state, ready)
                    if bad is not None and err_task is None:
                        err_task = bad
            if err_task is not None:
                self._drain()
                raise TaskError(
                    err_task, err_task.error or RuntimeError("task error")
                )

    def _sweep(self, ready: List[Task]) -> None:
        """Safety net: after a quiet interval, re-derive submittable
        tasks from scratch and fail loudly on a true stall."""
        for t in self.tasks:
            if t.state in _RESUBMITTABLE and all(
                d.state == TaskState.OK
                for dep in t.deps for d in dep.tasks
            ):
                ready.append(t)
        if ready:
            return
        if any(t.state in (TaskState.WAITING, TaskState.RUNNING)
               for t in self.tasks):
            return
        if all(r.state == TaskState.OK for r in self.roots):
            return
        if any(t.state == TaskState.ERR for t in self.tasks):
            return  # the event loop will surface it
        states: Dict[str, int] = {}
        for t in self.tasks:
            states[t.state.name] = states.get(t.state.name, 0) + 1
        raise RuntimeError(
            f"evaluation stalled: no runnable or running tasks "
            f"(task states: {states})"
        )

    def _drain(self, timeout: Optional[float] = None) -> None:
        """Wait (bounded) for in-flight tasks to settle before raising.
        When the wait expires with tasks still in flight, name them: in
        the log, and to a monitor that opts in with
        ``on_drain_timeout(wedged)`` (the telemetry hub)."""
        if timeout is None:
            timeout = DRAIN_SECS
        deadline = time.time() + timeout
        while time.time() < deadline:
            if not any(
                t.state in (TaskState.WAITING, TaskState.RUNNING)
                for t in self.tasks
            ):
                return
            with self.cond:
                self.cond.wait(timeout=0.2)
        wedged = [
            {"task": str(t.name), "state": t.state.name}
            for t in self.tasks
            if t.state in (TaskState.WAITING, TaskState.RUNNING)
        ]
        if not wedged:
            return
        import logging

        head = ", ".join(
            f"{w['task']}={w['state']}" for w in wedged[:16]
        )
        if len(wedged) > 16:
            head += f", ... ({len(wedged) - 16} more)"
        logging.getLogger("bigslice.evaluate").warning(
            "drain timeout (%.0fs): %d task(s) still in flight: %s",
            timeout, len(wedged), head,
        )
        fn = getattr(self.monitor, "on_drain_timeout", None)
        if fn is not None:
            from bigslice_tpu_torch.utils.status import safe_monitor_call

            safe_monitor_call(fn, wedged, key=id(self.monitor))
