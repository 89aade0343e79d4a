"""Live session status: per-op task-state aggregation.

Task state transitions aggregate into per-op counts (INIT, WAITING,
RUNNING, OK, ERR, LOST) that render as status lines on a terminal and
are queryable as a dict. With a telemetry hub and an executor's
``resource_stats`` wired in, the lines carry skew, straggler, HBM and
host-memory annotations. Monitors are chained with ``chain_monitors``,
and every member call goes through ``safe_monitor_call``.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, Optional

from bigslice_tpu_torch.exec.task import TaskState

# Monitors whose callback already raised once (and were logged): further
# exceptions from the same monitor are muted so a broken status display
# can't flood stderr at one line per task transition. id-keyed, with a
# strong reference to the callback held so a recycled object id can
# never silently mute a NEW monitor's first exception; bounded — past
# the cap we fail open to logging (noisy beats silent).
_monitor_warned: dict = {}  # key -> callback (the ref pins the id)
_monitor_warned_lock = threading.Lock()
_MONITOR_WARNED_MAX = 256


def safe_monitor_call(fn, *args, key=None) -> None:
    """Invoke a monitor/phase callback, swallowing (and logging once per
    callback) any exception: observability hooks run inside the
    evaluator's transition path and the wave pipeline's prefetcher
    thread, where a raising monitor would otherwise kill the evaluation
    or wedge staging (chain_monitors / exec/evaluate.notify_phase).

    ``key`` identifies the callback for the log-once bookkeeping; pass
    it when ``fn`` is a transient bound-method object (a fresh object —
    and id — per attribute access)."""
    try:
        fn(*args)
    except Exception:
        key = id(fn) if key is None else key
        with _monitor_warned_lock:
            first = key not in _monitor_warned
            if first and len(_monitor_warned) < _MONITOR_WARNED_MAX:
                _monitor_warned[key] = fn
        if first:
            import traceback

            print(
                f"bigslice: monitor {fn!r} raised (suppressed; further "
                f"errors from it are muted):", file=sys.stderr,
            )
            traceback.print_exc(file=sys.stderr)


class Status:
    """Aggregated task counts per op group."""

    def __init__(self):
        self._lock = threading.Lock()
        self._task_state: Dict[str, TaskState] = {}
        self._op_of: Dict[str, str] = {}
        # Per-op wall clock for the live view: first submission to last
        # terminal transition (it keeps ticking while any task of the
        # op is non-terminal, tracked by the live count below).
        self._op_start: Dict[str, float] = {}
        self._op_end: Dict[str, float] = {}
        self._op_live: Dict[str, int] = {}
        # Executor-provided resource telemetry (utils/resources.py):
        # the session wires executor.resource_stats here so render()
        # carries HBM, RSS and executor gauges next to the task counts.
        self._resources_provider = None
        # Telemetry hub (utils/telemetry.py): when wired, render()
        # carries live skew / straggler annotations next to the counts.
        self._telemetry = None

    def set_resources_provider(self, provider) -> None:
        self._resources_provider = provider

    def set_telemetry(self, hub) -> None:
        self._telemetry = hub

    _TERMINAL = (TaskState.OK, TaskState.ERR, TaskState.LOST)

    def __call__(self, task, state) -> None:
        with self._lock:
            key = str(task.name)
            prev = self._task_state.get(key)
            self._task_state[key] = state
            self._op_of[key] = task.name.op
            op = task.name.op
            now = time.monotonic()
            self._op_start.setdefault(op, now)
            was_live = prev is not None and prev not in self._TERMINAL
            is_live = state not in self._TERMINAL
            live = (self._op_live.get(op, 0)
                    + int(is_live) - int(was_live))
            self._op_live[op] = live
            if live > 0:
                self._op_end.pop(op, None)  # still ticking / resumed
            elif state in self._TERMINAL:
                self._op_end[op] = now  # last live task settled

    def counts(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            out: Dict[str, Dict[str, int]] = {}
            for key, state in self._task_state.items():
                op = self._op_of[key]
                d = out.setdefault(op, {})
                d[state.name] = d.get(state.name, 0) + 1
            return out

    def elapsed(self, op: str) -> float:
        """Seconds from the op's first submission to its last terminal
        transition — still ticking while any task is live."""
        with self._lock:
            start = self._op_start.get(op)
            if start is None:
                return 0.0
            return self._op_end.get(op, time.monotonic()) - start

    def render(self) -> str:
        lines = []
        for op, states in sorted(self.counts().items()):
            total = sum(states.values())
            ok = states.get("OK", 0)
            running = states.get("RUNNING", 0)
            err = states.get("ERR", 0) + states.get("LOST", 0)
            line = f"  {op}: {ok}/{total} done"
            if running:
                line += f", {running} running"
            if err:
                line += f", {err} failed/lost"
            line += f" [{self.elapsed(op):.1f}s]"
            lines.append(line)
        hub = self._telemetry
        if hub is not None:
            try:
                lines.extend(hub.status_lines())
            except Exception:
                pass  # best-effort; never break the status line
        provider = self._resources_provider
        if provider is not None:
            try:
                from bigslice_tpu_torch.utils import resources as res_mod

                lines.extend(res_mod.render_stats(provider()))
            except Exception:  # pragma: no cover - telemetry is
                pass  # best-effort; never break the status line
        return "\n".join(lines)


class StatusPrinter:
    """Background printer of the status lines."""

    def __init__(self, status: Status, interval: float = 1.0,
                 stream=None):
        self.status = status
        self.interval = interval
        self.stream = stream or sys.stderr
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_key = ""
        self._last_render = ""

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @staticmethod
    def _dedup_key(rendered: str) -> str:
        # Dedup modulo the ticking elapsed field: a long-running op
        # must not reprint an otherwise-identical block every
        # interval (non-TTY logs would fill with timestamp-only
        # changes).
        import re

        return re.sub(r"\[\d+\.\d+s\]", "[]", rendered)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self._print_once()

    def _print_once(self) -> None:
        cur = self.status.render()
        key = self._dedup_key(cur)
        if cur and key != self._last_key:
            print(cur, file=self.stream, flush=True)
            self._last_key = key
            self._last_render = cur

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        # One final snapshot: a session shorter than the print interval
        # (or one whose last transitions landed after the final tick)
        # must not exit with a stale — or empty — last status block.
        try:
            cur = self.status.render()
            if cur and cur != self._last_render:
                print(cur, file=self.stream, flush=True)
                self._last_key = self._dedup_key(cur)
                self._last_render = cur
        except Exception:
            pass  # never let a final render break shutdown


def chain_monitors(*monitors):
    """Compose monitors (evaluator accepts a single callable).

    Members exposing ``on_phase`` (the wave-pipeline phase channel,
    exec/evaluate.notify_phase) get a composed forwarder on the chained
    monitor; state-only members are untouched by phase events.

    Every member call is isolated through ``safe_monitor_call``: one
    raising monitor must neither starve the members after it nor
    propagate into the evaluator's transition path or the wave
    pipeline's prefetcher thread."""
    mons = [m for m in monitors if m is not None]

    def monitor(task, state):
        for m in mons:
            safe_monitor_call(m, task, state)

    phase_mons = [m for m in mons
                  if getattr(m, "on_phase", None) is not None]
    if phase_mons:
        def on_phase(task, phase, wave):
            for m in phase_mons:
                safe_monitor_call(m.on_phase, task, phase, wave,
                                  key=id(m))

        monitor.on_phase = on_phase
    # Drain-timeout channel (exec/evaluate._drain): members opting in
    # via on_drain_timeout receive the wedged-task census when an
    # aborted evaluation's drain expires.
    drain_mons = [m for m in mons
                  if getattr(m, "on_drain_timeout", None) is not None]
    if drain_mons:
        def on_drain_timeout(wedged):
            for m in drain_mons:
                safe_monitor_call(m.on_drain_timeout, wedged,
                                  key=id(m))

        monitor.on_drain_timeout = on_drain_timeout
    return monitor
