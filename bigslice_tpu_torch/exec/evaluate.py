"""The evaluator: a concurrency-safe task DAG state machine.

Given root tasks and an executor, drive every reachable task to OK:

- tasks become runnable when all their dependencies are OK;
- LOST tasks (missing output) are resubmitted, re-running their
  producers;
- ``MAX_CONSECUTIVE_LOST`` consecutive losses turn a task fatal;
- concurrent evaluations of overlapping graphs coordinate purely
  through task state;
- a coded coverage group (``exec/codedplan.py``) settles its consumers
  when any k of its n members cover every unit, not when all n are OK;
- a deadline cancels what is in flight, drains it (bounded) and raises
  ``DeadlineExceeded``.

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
from bigslice_tpu_torch.utils import faultinject

MAX_CONSECUTIVE_LOST = 5


class DeadlineExceeded(Exception):
    """The evaluation's deadline expired before the roots settled. The
    tasks in flight were cooperatively cancelled and drained (bounded)
    before this raised, so the executor's slots are already free."""

    def __init__(self, deadline_s: float, pending: int):
        self.deadline_s = deadline_s
        self.pending = pending
        super().__init__(
            f"evaluation deadline ({deadline_s:.3f}s) exceeded with "
            f"{pending} task(s) unfinished"
        )

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

# States a task may be (re)submitted from. A cooperatively cancelled
# task is not fatal: it reruns when it is needed again. (A coded member
# whose group is already covered is not needed: ``_wanted``.)
_RESUBMITTABLE = (TaskState.INIT, TaskState.LOST, TaskState.CANCELLED)

# The bounded drain after a deadline expires: cancellation is
# cooperative, so bodies get this long to reach a seam.
DEADLINE_DRAIN_SECS = 10.0


def evaluate(executor, roots: Sequence[Task], monitor=None,
             deadline: Optional[float] = None) -> None:
    """Evaluate the graph rooted at ``roots`` to completion.

    ``executor`` implements ``submit(task)`` (async: eventually moves the
    task from WAITING to a terminal state). ``monitor``, if given, hears
    ``monitor(task, state)`` on every transition of a task of the graph;
    an exception it raises is logged once (``safe_monitor_call``) and
    never fails the task.

    ``deadline``, if given, is an absolute ``time.monotonic()`` stamp:
    when it passes before the roots settle, every task in flight is
    cooperatively cancelled (flag and event; executors stop at their
    frame, unit and wave seams), the cancellations are drained (at most
    ``DEADLINE_DRAIN_SECS``) and ``DeadlineExceeded`` raises. Cancelled
    tasks stay resubmittable.

    With an adaptive planner on the executor (``exec/adaptive.py``,
    attached by the Session under ``BIGSLICE_ADAPTIVE``), the spec
    policy's straggler watcher runs for the evaluation's duration."""
    ev = _Evaluation(executor, roots, monitor, deadline=deadline)
    planner = getattr(executor, "adaptive", None)
    watcher = None
    if planner is not None:
        try:
            watcher = planner.watch(ev.tasks, executor)
        except Exception:  # noqa: BLE001 — the watcher is advisory
            watcher = None
    try:
        ev.run()
    finally:
        if watcher is not None:
            watcher.stop()


class _Evaluation:
    def __init__(self, executor, roots, monitor=None, deadline=None):
        self.executor = executor
        self.monitor = monitor
        self.deadline = deadline
        self.roots = list(roots)
        self.tasks = iter_tasks(roots)
        self.cond = threading.Condition()
        self.events: collections.deque = collections.deque()
        self.consumers: Dict[int, List[Task]] = {
            id(t): [] for t in self.tasks
        }
        self.dep_counts: Dict[int, int] = {}
        self.ok_seen: set = set()  # dep ids currently credited as OK
        # Coded coverage groups: a coded dep is one pending credit per
        # group, released when every unit has an OK owner. All empty
        # with BIGSLICE_CODED unset.
        self.groups: Dict[int, object] = {}          # gid -> group
        self.group_consumers: Dict[int, List[Task]] = {}
        self.group_covered: Dict[int, bool] = {}

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
                grp = getattr(dep, "coded", None)
                if grp is not None:
                    # One credit per coverage group, released by the
                    # k-of-n settle (_on_coded_event).
                    gid = id(grp)
                    if gid not in self.groups:
                        self.groups[gid] = grp
                        self.group_covered[gid] = self._covered(grp)
                    self.group_consumers.setdefault(gid, []).append(t)
                    if not self.group_covered[gid]:
                        pending += 1
                    continue
                for d in dep.tasks:
                    self.consumers[id(d)].append(t)
                    if snapshot[id(d)] != TaskState.OK:
                        pending += 1
            self.dep_counts[id(t)] = pending
            if pending == 0 and snapshot[id(t)] in _RESUBMITTABLE:
                if self._wanted(t):
                    ready.append(t)
        return ready

    # -- coded coverage groups (exec/codedplan.py) --------------------------

    @staticmethod
    def _covered(grp) -> bool:
        """Does a covering k-subset of the group hold OK partials for
        every unit now?"""
        tasks = grp.tasks
        return all(
            any(tasks[oi].state == TaskState.OK for oi in grp.owners(u))
            for u in range(grp.k)
        )

    @staticmethod
    def _coverable(grp) -> bool:
        """Can coverage still come without a resubmission: has every
        unit an owner that is OK or on its way? Losses within the r
        budget keep this true (the silent case); only a unit whose every
        owner is dead fires the loud recompute."""
        live = (TaskState.OK, TaskState.INIT, TaskState.WAITING,
                TaskState.RUNNING)
        tasks = grp.tasks
        return all(
            any(tasks[oi].state in live for oi in grp.owners(u))
            for u in range(grp.k)
        )

    def _wanted(self, task: Task) -> bool:
        """False only for a coded member whose group is already covered:
        rerunning it would undo the cancellation coverage bought."""
        grp = getattr(task, "coded_group", None)
        if grp is None:
            return True
        return not self.group_covered.get(id(grp), False)

    def _coded_stats(self):
        planner = getattr(self.executor, "coded", None)
        return getattr(planner, "stats", None)

    def _cancel_redundant(self, grp) -> None:
        """Coverage settled: cancel the members still in flight. WAITING
        ones flip straight to CANCELLED (the executor's RUNNING claim
        then fails and drops them); RUNNING ones stop at their next
        seam. RUNNING → OK against RUNNING → CANCELLED is settled by
        ``transition_if``: first wins, and both are correct."""
        stats = self._coded_stats()
        for m in grp.tasks:
            st = m.state
            if st not in (TaskState.WAITING, TaskState.RUNNING):
                continue
            m.request_cancel()
            if m.transition_if(TaskState.WAITING, TaskState.CANCELLED):
                st = TaskState.CANCELLED
            if stats is not None:
                stats.record("cancelled", task=str(m.name),
                             op=grp.op, state=st.name)

    def _on_coded_event(self, grp, task: Task, state: TaskState,
                        ready: List[Task]) -> None:
        """A coverage member's transition, settled at the group level."""
        gid = id(grp)
        if state == TaskState.OK:
            if not self.group_covered.get(gid, False) \
                    and self._covered(grp):
                self.group_covered[gid] = True
                stats = self._coded_stats()
                if stats is not None:
                    stats.record("covered", op=grp.op, k=grp.k,
                                 r=grp.r, inv=grp.inv_index)
                for c in self.group_consumers.get(gid, ()):
                    cid = id(c)
                    self.dep_counts[cid] -= 1
                    if self.dep_counts[cid] == 0 and \
                            c.state in _RESUBMITTABLE:
                        ready.append(c)
                self._cancel_redundant(grp)
        elif state == TaskState.LOST:
            if self.group_covered.get(gid, False) \
                    and not self._covered(grp):
                # A covering member was lost: charge the consumers again
                # (cancelled siblings become needed).
                self.group_covered[gid] = False
                for c in self.group_consumers.get(gid, ()):
                    self.dep_counts[id(c)] += 1
                stats = self._coded_stats()
                if stats is not None:
                    stats.record("coverage_lost", op=grp.op,
                                 task=str(task.name))
            if not self.group_covered.get(gid, False) \
                    and not self._coverable(grp):
                # More than r losses: a unit has no live owner. Resubmit
                # the dead members, loudly.
                stats = self._coded_stats()
                for m in grp.tasks:
                    if m.state in _RESUBMITTABLE and \
                            self.dep_counts.get(id(m), 1) == 0:
                        ready.append(m)
                        if stats is not None:
                            stats.record("recovered", op=grp.op,
                                         task=str(m.name))

    def _on_event(self, task: Task, state: TaskState,
                  ready: List[Task]) -> Optional[Task]:
        """Update counts for one transition; append newly submittable
        tasks to ``ready``. Returns an ERR task if one surfaced."""
        if state == TaskState.ERR:
            return task
        grp = getattr(task, "coded_group", None)
        if grp is not None and id(grp) in self.groups:
            self._on_coded_event(grp, task, state, ready)
            return None
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
        if not self._wanted(task):
            return False
        if task.consecutive_lost >= MAX_CONSECUTIVE_LOST:
            # The last loss's cause goes with the verdict: it is what a
            # failing run can say about why.
            task.set_state(
                TaskState.ERR,
                RuntimeError(
                    f"task {task.name} lost {task.consecutive_lost} "
                    f"consecutive times; the last: {task.error!r}"
                ),
            )
            return False
        if faultinject.ENABLED:
            # Chaos seam (reference exec/evaluate.py:390-397): the
            # submission is lost in flight. mark_lost re-enters this
            # ladder, still bounded by the consecutive-loss cap.
            fault = faultinject.fire("eval.resubmit")
            if fault is not None:
                task.mark_lost(faultinject.injected_error(fault))
                return False
        if task.transition_if(st, TaskState.WAITING):
            if st == TaskState.CANCELLED:
                # A fresh attempt: the stale request must not stop it at
                # its first seam.
                task.clear_cancel()
            self.executor.submit(task)
            return True
        return False

    def _remaining(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def _expire(self) -> None:
        """The deadline passed: cancel everything in flight (WAITING
        flips straight to CANCELLED), drain (bounded), and raise
        DeadlineExceeded with the pending census. The slots are free by
        the time it raises."""
        for t in self.tasks:
            if t.state in (TaskState.WAITING, TaskState.RUNNING):
                t.request_cancel()
                t.transition_if(TaskState.WAITING, TaskState.CANCELLED)
        self._drain(timeout=DEADLINE_DRAIN_SECS)
        pending = sum(1 for t in self.tasks if t.state != TaskState.OK)
        raise DeadlineExceeded(
            deadline_s=max(0.0, self.deadline - self._t0), pending=pending)

    def _run(self) -> None:
        self._t0 = time.monotonic()
        with self.cond:
            ready = self._build()
        # A task already fatal when evaluation starts surfaces at once:
        # no transition event will ever fire for it.
        err_task = next(
            (t for t in self.tasks if t.state == TaskState.ERR), None
        )
        while True:
            remaining = self._remaining()
            if remaining is not None and remaining <= 0:
                self._expire()
            # Submit outside the lock (executors may call back inline).
            for t in ready:
                self._submit(t)
            ready = []
            expired = False
            with self.cond:
                while not self.events:
                    if all(r.state == TaskState.OK for r in self.roots):
                        return
                    if err_task is not None:
                        break
                    timeout = SWEEP_SECS
                    remaining = self._remaining()
                    if remaining is not None:
                        if remaining <= 0:
                            expired = True
                            break
                        timeout = min(SWEEP_SECS, remaining)
                    if not self.cond.wait(timeout=timeout):
                        remaining = self._remaining()
                        if remaining is not None and remaining <= 0:
                            expired = True
                            break
                        self._sweep(ready)
                        if ready:
                            break
                while self.events:
                    task, state = self.events.popleft()
                    bad = self._on_event(task, state, ready)
                    if bad is not None and err_task is None:
                        err_task = bad
            if expired:
                self._expire()
            if err_task is not None:
                self._drain()
                raise TaskError(
                    err_task, err_task.error or RuntimeError("task error")
                )

    def _deps_satisfied(self, task: Task) -> bool:
        """From live state: a coded dep by coverage (any k of n), every
        other dep by all of its producers being OK."""
        for dep in task.deps:
            grp = getattr(dep, "coded", None)
            if grp is not None:
                if not self._covered(grp):
                    return False
                continue
            if any(d.state != TaskState.OK for d in dep.tasks):
                return False
        return True

    def _sweep(self, ready: List[Task]) -> None:
        """Safety net: after a quiet interval, re-derive submittable
        tasks from scratch and fail loudly on a true stall."""
        for t in self.tasks:
            if t.state in _RESUBMITTABLE and self._wanted(t) \
                    and self._deps_satisfied(t):
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
