"""Session: compile and evaluate slices, and read their results.

``Session()`` runs on the device executor over ``cuda`` (its host tier,
an inner local executor, runs what the device path cannot lower);
``Session(parallelism=N)`` on the local executor with N task threads,
also over ``cuda``. ``Session(executor=MeshExecutor(device="cpu"))`` or
``Session(executor=LocalExecutor(device="cpu"))`` runs the same paths
on the CPU through the kernels' plain versions, as the tests do.

Each session carries the observability plane: a telemetry hub
(``utils/telemetry.py``, off with ``BIGSLICE_TELEMETRY=0``), the task
status (``utils/status.py``), an optional Chrome trace and eventer, and
a profiler gate (``utils/xprof.py``); the executors report into the hub
through their seams. It attaches the robustness plane's planners from
their knobs (``BIGSLICE_ADAPTIVE``, ``BIGSLICE_CODED``) and the
kernel selector from ``BIGSLICE_KERNEL_SELECT``
(``parallel/kernelselect.py``), and ``run`` takes a deadline. With
``debug_port`` it serves the debug HTTP endpoints.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

from bigslice_tpu_torch import sliceio, typecheck
from bigslice_tpu_torch.exec import compile as compile_mod
from bigslice_tpu_torch.exec import shuffleplan
from bigslice_tpu_torch.exec.evaluate import (MAX_CONSECUTIVE_LOST,
                                              DeadlineExceeded, evaluate)
from bigslice_tpu_torch.exec.store import Missing
from bigslice_tpu_torch.exec.task import Task, TaskState, iter_tasks
from bigslice_tpu_torch.frame.frame import Frame
from bigslice_tpu_torch.ops.base import Slice, make_name
from bigslice_tpu_torch.ops.func import Func, invocation_counter
from bigslice_tpu_torch.utils import metrics as metrics_mod


class ObservabilityNotPorted(NotImplementedError):
    """A part of the observability plane that has no port yet: the fleet
    merge (``telemetry_summary(scope="fleet")``, the debug server's
    ``/debug/fleet`` and ``obsdump --fleet``)."""


class _InvocationGate:
    """Reader-writer isolation of runs: plain runs share the session
    (readers); an exclusive Func's run takes it alone (the writer),
    its own shards still running in parallel."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False

    def acquire(self, exclusive: bool) -> None:
        with self._cond:
            if exclusive:
                self._cond.wait_for(
                    lambda: not self._writer and self._readers == 0)
                self._writer = True
            else:
                self._cond.wait_for(lambda: not self._writer)
                self._readers += 1

    def release(self, exclusive: bool) -> None:
        with self._cond:
            if exclusive:
                self._writer = False
            else:
                self._readers -= 1
            self._cond.notify_all()


class Result(Slice):
    """A computed slice: the output of a session run, one task per
    shard. Reading re-evaluates lost tasks first. ``scope`` merges the
    user counters of its tasks; ``corr`` is the run's correlation id."""

    def __init__(self, session: "Session", slice_: Slice,
                 tasks: Sequence[Task]):
        super().__init__(slice_.schema, len(tasks), make_name("result"))
        self.session = session
        self.tasks = list(tasks)
        self.scope = metrics_mod.Scope()
        for t in self.tasks:
            self.scope.merge(t.scope)
        self.corr: Optional[str] = None

    def reader(self, shard: int, deps) -> sliceio.Reader:
        task = self.tasks[shard]

        def read():
            # Re-evaluate-before-read with retry: an output that vanished
            # between evaluation and the scan re-runs its producers. The
            # frames stream as the store yields them; a Missing in the
            # middle of the stream (a corrupt frame) restarts the shard
            # only if nothing was yielded yet, and re-raises otherwise.
            last = None
            for _ in range(MAX_CONSECUTIVE_LOST):
                if task.state != TaskState.OK:
                    evaluate(self.session.executor, [task])
                try:
                    r = self.session.executor.reader(task, 0)
                except Missing as e:
                    last = e
                    task.mark_lost(e)
                    continue
                emitted = False
                try:
                    for f in r:
                        emitted = True
                        yield f
                except Missing as e:
                    task.mark_lost(e)
                    if emitted:
                        raise
                    last = e
                    continue
                return
            raise last

        return read()

    def frames(self) -> sliceio.Reader:
        for shard in range(self.num_shards):
            yield from self.reader(shard, ())

    def rows(self) -> List[Tuple]:
        out: List[Tuple] = []
        for f in self.frames():
            out.extend(f.rows())
        return out

    def _merged(self, frames) -> Frame:
        frames = list(frames)
        return Frame.concat(frames) if frames else Frame.empty(self.schema)

    def to_arrow(self, names=None):
        """All result rows as one ``pyarrow.Table`` (``frame/arrow.py``'s
        mapping: vector columns as FixedSizeList, ragged lists as List,
        strings as String)."""
        from bigslice_tpu_torch.frame import arrow

        return arrow.to_arrow(self._merged(self.frames()), names=names)

    def to_pandas(self, names=None):
        """All result rows as a ``pandas.DataFrame``."""
        return self.to_arrow(names=names).to_pandas()

    def write_parquet(self, url_prefix: str, names=None) -> None:
        """Write one Parquet file a shard, named
        ``{url_prefix}-NNNN-of-MMMM.parquet`` (a local path or any fsspec
        URL). An empty shard writes an empty file, so the set is
        complete."""
        from bigslice_tpu_torch.frame import arrow

        m = self.num_shards
        for shard in range(m):
            arrow.write_parquet(
                self._merged(self.reader(shard, ())),
                f"{url_prefix}-{shard:04d}-of-{m:04d}.parquet", names=names)

    def discard(self) -> None:
        """Drop stored task outputs."""
        for t in self.tasks:
            self.session.executor.discard(t)


def _telemetry_on() -> bool:
    return os.environ.get("BIGSLICE_TELEMETRY", "1").lower() not in (
        "0", "false", "off")


class Session:
    """Compiles and evaluates slices on one executor.

    - ``executor``: with none, ``MeshExecutor()``, or with
      ``parallelism`` set, ``LocalExecutor(procs=parallelism)``; both
      run on ``cuda`` and raise at construction when there is no GPU.
      (The JAX package's default is the local executor.)
    - ``parallelism``: the local executor's task threads.
    - ``monitor``: ``monitor(task, state)`` on every task transition.
    - ``trace_path``: write a Chrome trace of the task schedule (one
      complete event a task run, and the session's instants) at
      ``shutdown()``.
    - ``status``: print the per-op task counts on stderr as they change
      (``utils/status.py``); ``session.status`` holds them either way.
    - ``eventer``: ``eventer(name, **fields)`` hears the session's events
      (sessionStart, the invocations, taskComplete, the hub's records).
    - ``machine_combiners``: the producer tasks of a combining shuffle
      share one combiner buffer a partition, combined once when the
      last lands: fewer, larger combines, at the cost of retrying the
      whole producer group when one of its outputs is lost.
    - ``debug_port``: start the debug HTTP server
      (``utils/debughttp.py``) on this port of 127.0.0.1, 0 for a free
      one; ``session.debug`` is the server (None without the option)
      and ``shutdown()`` closes it.

    A ``ServeServer`` (``serve/server.py``) built over the session sets
    itself as ``session.serve``; ``shutdown()`` drains it first.

    From the environment, as in the JAX package: ``BIGSLICE_ADAPTIVE``
    attaches an adaptive planner (``session.adaptive``,
    ``exec/adaptive.py``) and ``BIGSLICE_CODED`` a coded planner
    (``session.coded``, ``exec/codedplan.py``); unset, both are None and
    nothing of them runs. ``BIGSLICE_CHAOS`` installs a fault plan for
    the process (``utils/faultinject.py``). The JAX package's ``elastic``
    and ``mesh_provider`` (elastic mesh recovery) are not ported.

    ``session.profiler.window(seconds)`` profiles the process with
    ``torch.profiler`` on demand.

    The telemetry hub (``session.telemetry``, None with
    ``BIGSLICE_TELEMETRY=0``) hears every transition and the executors'
    seams; ``telemetry_summary()`` returns what it holds.
    """

    def __init__(self, executor=None, parallelism: Optional[int] = None,
                 monitor=None, trace_path: Optional[str] = None,
                 status: bool = False, eventer=None,
                 machine_combiners: bool = False,
                 debug_port: Optional[int] = None):
        from bigslice_tpu_torch.utils import status as status_mod
        from bigslice_tpu_torch.utils import trace as trace_mod
        from bigslice_tpu_torch.utils import xprof as xprof_mod

        if executor is None:
            if parallelism is not None:
                from bigslice_tpu_torch.exec.local import LocalExecutor

                executor = LocalExecutor(procs=parallelism)
            else:
                from bigslice_tpu_torch.exec.meshexec import MeshExecutor

                executor = MeshExecutor()
        self.executor = executor
        self.eventer = eventer
        self.trace_path = trace_path
        self.tracer = trace_mod.Tracer() if trace_path else None
        # The hub hears the monitor chain and the phase channel below
        # and the executors' seams; its instants ride _event into the
        # eventer and the trace. BIGSLICE_TELEMETRY=0 builds none, and
        # every seam then does nothing.
        self.telemetry = None
        if _telemetry_on():
            from bigslice_tpu_torch.utils import telemetry as telemetry_mod

            self.telemetry = telemetry_mod.TelemetryHub(eventer=self._event)
            self.telemetry.device.set_device(
                getattr(executor, "device", None))
        self.status = status_mod.Status()
        self.status.set_telemetry(self.telemetry)
        stats_fn = getattr(self.executor, "resource_stats", None)
        if stats_fn is not None:
            self.status.set_resources_provider(stats_fn)
        self._printer = None
        if status:
            self._printer = status_mod.StatusPrinter(self.status)
            self._printer.start()
        monitors = [monitor, self.status, self.telemetry]
        if self.tracer is not None:
            monitors.append(trace_mod.TaskTraceMonitor(self.tracer))
        if eventer is not None:
            monitors.append(self._event_monitor)
        self.monitor = status_mod.chain_monitors(*monitors)
        self.machine_combiners = machine_combiners
        self.profiler = xprof_mod.Profiler(
            device=getattr(executor, "device", None))
        self._gate = _InvocationGate()
        # The planners (reference exec/session.py:382-423): attached only
        # when their knob engages; with it unset nothing of them exists.
        from bigslice_tpu_torch.exec import adaptive as adaptive_mod
        from bigslice_tpu_torch.exec import codedplan as codedplan_mod

        self.adaptive = adaptive_mod.planner_from_env(self.telemetry)
        if self.adaptive is not None:
            if self.telemetry is not None:
                self.telemetry.adaptive = self.adaptive.stats
            executor.adaptive = self.adaptive
        # The kernel selector (reference exec/session.py:397-413): with
        # BIGSLICE_KERNEL_SELECT unset none exists, and the executor's
        # lowerings are today's.
        from bigslice_tpu_torch.parallel import kernelselect as kselect_mod

        self.kernel_select = kselect_mod.selector_from_env(
            self.telemetry, device=getattr(executor, "device", None))
        if self.kernel_select is not None:
            if self.telemetry is not None:
                self.telemetry.kernel_select = self.kernel_select.stats
            if hasattr(executor, "kernel_select"):
                executor.kernel_select = self.kernel_select
        self.coded = codedplan_mod.planner_from_env(self.telemetry)
        if self.coded is not None:
            if self.telemetry is not None:
                self.telemetry.coded = self.coded.stats
            executor.coded = self.coded
        # The serving plane (serve/server.py): a ServeServer attached to
        # this session sets itself here, so that shutdown() drains its
        # invocations before the executor goes (reference :343-346).
        self.serve = None
        # The debug server (reference exec/session.py:347-351), last, so
        # that a knob the planners refuse leaves no listener behind.
        self.debug = None
        if debug_port is not None:
            from bigslice_tpu_torch.utils.debughttp import DebugServer

            self.debug = DebugServer(self, debug_port)
        start = getattr(executor, "start", None)
        if start is not None:
            start(self)
        self._event("bigslice:sessionStart", executor=executor.name)

    def _event(self, name: str, **fields) -> None:
        if self.eventer is not None:
            self.eventer(name, **fields)
        if self.tracer is not None:
            self.tracer.instant(name, **fields)

    def _event_monitor(self, task, state) -> None:
        if state == TaskState.OK:
            self.eventer("bigslice:taskComplete", task=str(task.name))

    def shutdown(self) -> None:
        """Drain an attached serving server (its invocations run on this
        session's executor; its close() also prints the final snapshot),
        release the executor's resources (its private spill directory),
        stop the status printer, and write the trace."""
        if self.serve is not None:
            try:
                self.serve.close()
            except Exception:  # noqa: BLE001 — shutdown must finish
                pass
        close = getattr(self.executor, "close", None)
        if close is not None:
            close()
        if self._printer is not None:
            self._printer.stop()
        if self.debug is not None:
            self.debug.close()
        if self.tracer is not None and self.trace_path:
            self.tracer.save(self.trace_path)
            self._event("bigslice:traceSaved", path=self.trace_path)

    def run(self, func: Any, *args, corr: Optional[str] = None,
            deadline_s: Optional[float] = None) -> Result:
        """Compile and evaluate ``func(*args)``: ``func`` is a registered
        ``Func`` (invoked; an exclusive one's run takes the session
        alone), a Slice, or a callable returning one. ``corr`` is the
        run's correlation id in the trace and the eventer's invocation
        event (default ``inv<index>``); the result carries it.

        ``deadline_s`` bounds this run's wall time, counted from the
        call: when it expires, the tasks in flight are cooperatively
        cancelled at their next seam (a frame, a coverage unit, a wave
        boundary), drained, and ``DeadlineExceeded``
        (``exec/evaluate.py``) raises. The tasks stay resubmittable."""
        deadline = None
        if deadline_s is not None:
            if deadline_s <= 0:
                raise typecheck.errorf(
                    "run: deadline_s must be > 0, got %r", deadline_s)
            deadline = time.monotonic() + float(deadline_s)
        exclusive = False
        if isinstance(func, Func):
            inv = func.invocation(*args)
            slice_ = inv.invoke()
            inv_index = inv.index
            exclusive = func.exclusive
        elif isinstance(func, Slice):
            typecheck.check(not args, "run: args given with a literal slice")
            slice_ = func
            inv_index = next(invocation_counter)
        elif callable(func):
            slice_ = func(*args)
            typecheck.check(
                isinstance(slice_, Slice),
                "run: callable returned %s, expected a Slice",
                type(slice_).__name__,
            )
            inv_index = next(invocation_counter)
        else:
            raise typecheck.errorf(
                "run: expected Func, Slice or callable, got %s",
                type(func).__name__,
            )
        corr = corr or f"inv{inv_index}"
        if self.eventer is not None or self.tracer is not None:
            import reprlib

            loc = typecheck.caller_location()
            self._event(
                f"bigslice:invocation:{inv_index}",
                inv=inv_index,
                corr=corr,
                location=f"{loc[0]}:{loc[1]}" if loc else "?",
                args=", ".join(reprlib.repr(a) for a in args),
            )
        tasks = compile_mod.Compiler(
            inv_index, shuffle_mode=shuffleplan.plan_mode() or "",
            machine_combiners=self.machine_combiners, coded=self.coded,
            mesh_signature=self._mesh_signature(),
            kernel_select_mode=(self.kernel_select.mode
                                if self.kernel_select is not None
                                else None),
        ).compile(slice_)
        if self.debug is not None:
            self.debug.register_roots(tasks)
        self._gate.acquire(exclusive)
        try:
            token = self._plan_run(tasks)
            failed = True
            try:
                evaluate(self.executor, tasks, monitor=self.monitor,
                         deadline=deadline)
                failed = False
            except DeadlineExceeded:
                self._record_deadline("expired", deadline_s)
                raise
            except Exception as e:
                self._dump_flight(inv_index, e)
                raise
            finally:
                if token is not None:
                    self.executor.finish_run(token, failed=failed)
            if deadline_s is not None:
                self._record_deadline("met", deadline_s)
        finally:
            self._gate.release(exclusive)
        res = Result(self, slice_, tasks)
        res.corr = corr
        return res

    def _plan_run(self, tasks):
        """Register this evaluation's group launch order with an
        ordered-dispatch executor (reference exec/session.py:683-712):
        the post-order DFS of the task graph, the same on every rank of
        one driver, groups whose members are all OK left out; the gather
        marks first. Returns the run's token (None without planning)."""
        if not getattr(self.executor, "ordered_dispatch", False):
            return None
        groups: dict = {}
        order = []
        for t in iter_tasks(tasks):
            if t.group_key is None:
                continue
            if t.group_key not in groups:
                groups[t.group_key] = []
                order.append(t.group_key)
            groups[t.group_key].append(t)
        token = object()
        self.executor.plan_gather(tasks, token=token)
        self.executor.plan_groups(((k, groups[k]) for k in order
                     if not all(m.state == TaskState.OK for m in groups[k])),
                    token=token)
        return token

    def _mesh_signature(self):
        """The executor's repr-stable device signature for the
        compiler's partition_config (reference :668-681): the device
        executor's one-axis layout of ``nmesh`` device slots, as the JAX
        package's ``MeshTopology(mesh).signature()`` names a one-axis
        mesh; None for the local executor."""
        nmesh = getattr(self.executor, "nmesh", None)
        if nmesh is None:
            return None
        return (("shards",), (int(nmesh),))

    def _record_deadline(self, outcome: str, deadline_s) -> None:
        """A ``run(deadline_s=)`` outcome into the hub's deadline plane
        (reference exec/session.py:655-666)."""
        if self.telemetry is None:
            return
        try:
            self.telemetry.record_deadline(outcome, deadline_s=deadline_s,
                                           source="session")
        except Exception:  # noqa: BLE001 — telemetry never fails a run
            pass

    def _dump_flight(self, inv_index, err) -> None:
        """Write the hub's flight recorder beside a fatal run (only with
        ``BIGSLICE_FLIGHTREC_DIR`` set)."""
        if self.telemetry is None:
            return
        try:
            path = self.telemetry.dump_flight_record(
                inv=inv_index, reason=repr(err))
            if path:
                self._event("bigslice:flightRecorder", inv=inv_index,
                            path=path)
        except Exception:  # noqa: BLE001 — telemetry never fails a run
            pass

    def telemetry_summary(self, scope: str = "session") -> dict:
        """The telemetry hub's signals (``utils/telemetry.py``): per-op
        task-duration quantiles and stragglers, shuffle skew (rows and
        bytes a partition, ratio, hot partition), wave overlap, the
        combine's input cardinality, and the ``device`` plane (kernel
        launches with their declared bytes and operations, builds, HBM
        watermarks, donation). ``{}`` with the
        hub off (``BIGSLICE_TELEMETRY=0``). ``scope="fleet"``, the
        cross-process merge, is not ported yet and raises."""
        if scope == "fleet":
            raise ObservabilityNotPorted(
                "telemetry_summary(scope='fleet'): the fleet merge "
                "(utils/fleettelemetry.py) is not ported yet")
        if scope != "session":
            raise ValueError(f"telemetry_summary: unknown scope {scope!r}")
        if self.telemetry is None:
            return {}
        return self.telemetry.summary()
