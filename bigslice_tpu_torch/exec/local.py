"""The local executor: in-process task execution, one task a shard.

Tasks run on a bounded pool of at most ``procs`` worker threads, one
task a worker, and each holds permits of ``procs`` while it runs: its
``Procs`` pragma's count, or all of them when ``Exclusive``. Outputs
land in a partitioned store (``MemoryStore`` by default); map-side
combiners run as each producer frame is routed and drain at task end.

Each task body is its chain's readers (``exec/compile._make_do``), run
with this executor's placement rule: a frame's device columns move to
the executor's device (``Frame.to``) where a device consumer reads
them (a device stage, a device combine or group, a device router),
and nowhere else; host columns stay on the host. So on ``cuda`` a
device stage's functions, the routing of every frame with device keys
(``Frame.partition_ids``: the ``hash_partition`` kernel), the stable
split into partitions (``partition_frame``) and the device combine (the
sort and segmented scan, ``segment.cached_reduce_kernel``) run on the
card; host functions, host keys and the host combine run on the host,
and a host chain's frames never visit the card.

The robustness plane (the JAX package's): the ``task.run`` chaos seam
after each RUNNING claim, cooperative cancellation between frames (a
``TaskCancelled`` settles CANCELLED), a coded coverage member run unit
by unit (``_execute_coded``) and read back through the masked k-of-n
view (``_coded_dep_factory``), and speculative duplicates of
stragglers on free permits (``speculate``).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import List, Optional

import torch

from bigslice_tpu_torch import sliceio, sortio
from bigslice_tpu_torch.exec import store as store_mod
from bigslice_tpu_torch.exec.task import Task, TaskCancelled, TaskState
from bigslice_tpu_torch.frame.frame import Frame
from bigslice_tpu_torch.utils import faultinject
from bigslice_tpu_torch.utils import metrics as metrics_mod

# Rows a partition buffer holds before an incremental pre-combine
# collapses it (associativity lets the combine run early, bounding the
# working set of high-cardinality streams).
COMBINE_FLUSH_ROWS = 1 << 20

# Rows a combiner-less partition buffer holds before it spills to disk,
# when the store streams (a pure shuffle cannot collapse in place).
SHUFFLE_SPILL_ROWS = 1 << 21


class DepLost(Exception):
    """A dependency's stored output is gone; carries the producer
    task(s) to mark LOST for re-evaluation. A machine-combined dep loses
    its whole producer group (contributions are freed at commit, so
    recovery needs every shard to contribute again)."""

    def __init__(self, producer, all_producers=None):
        self.producer = producer
        self.producers = tuple(all_producers) if all_producers else (
            producer,)
        super().__init__(f"lost output of {producer.name}")


def partition_frame(frame: Frame, ids, nparts: int) -> List[Frame]:
    """Split a frame into per-partition frames by partition id: one
    stable sort of the ids and a boundary search on the ids' device,
    the bounds read back once, so each partition keeps its rows' input
    order."""
    ids = torch.as_tensor(ids)
    n = int(ids.shape[0])
    sorted_ids, order = torch.sort(ids.to(torch.int32), stable=True)
    probes = torch.arange(nparts + 1, dtype=torch.int32,
                          device=ids.device)
    bounds = torch.searchsorted(sorted_ids, probes).tolist()
    if n and (bounds[0] != 0 or bounds[nparts] != n):
        raise ValueError(
            f"partitioner returned id outside [0, {nparts}): "
            f"[{int(ids.min())}, {int(ids.max())}]")
    sorted_frame = frame.take(order)
    return [sorted_frame.slice(bounds[p], bounds[p + 1])
            for p in range(nparts)]


def _frame_nbytes(frame: Frame) -> int:
    """The bytes of a frame's tensor and numpy columns (metadata only,
    no device sync); object columns count 0."""
    return sum(int(getattr(c, "nbytes", 0) or 0) for c in frame.cols)


class _Limiter:
    """Counting permits; a request for more than the capacity takes the
    whole capacity."""

    def __init__(self, n: int):
        self.capacity = n
        self._avail = n
        self._cond = threading.Condition()

    def acquire(self, n: int) -> None:
        n = min(n, self.capacity)
        with self._cond:
            self._cond.wait_for(lambda: self._avail >= n)
            self._avail -= n

    def try_acquire(self, n: int) -> bool:
        """Permits only if they are free now: a speculative duplicate
        never takes capacity from a first run."""
        n = min(n, self.capacity)
        with self._cond:
            if self._avail < n:
                return False
            self._avail -= n
            return True

    def release(self, n: int) -> None:
        n = min(n, self.capacity)
        with self._cond:
            self._avail += n
            self._cond.notify_all()


class LocalExecutor:
    """Runs tasks on worker threads of this process. ``device`` defaults
    to ``cuda``: construction raises when there is no GPU, and otherwise
    builds the kernel library and runs its probe kernel (once per
    process). ``device="cpu"`` runs the same readers through the
    kernels' plain versions. ``procs`` bounds the tasks running at once
    (default: the CPU count); ``store`` holds the outputs (default a
    ``MemoryStore``; a ``FileStore`` streams them to disk)."""

    name = "local"

    # Workers exit after this long idle: bursty sessions reuse threads,
    # quiet executors shed them.
    WORKER_IDLE_SECS = 10.0

    def __init__(self, procs: Optional[int] = None,
                 store: Optional[store_mod.Store] = None, device=None):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "LocalExecutor: no CUDA device is available; pass "
                    "device='cpu' to run on the CPU")
            from bigslice_tpu_torch.parallel import cuda_kernels

            if not cuda_kernels.kernels_available():
                raise RuntimeError(
                    "LocalExecutor: the CUDA kernels are not available "
                    "(nvcc not found, or the probe kernel returned wrong "
                    "values)")
        self.device = device
        self.procs = procs or os.cpu_count() or 4
        self._limiter = _Limiter(self.procs)
        self.store = store or store_mod.MemoryStore()
        # The bounded worker pool: at most ``procs`` workers, made on
        # demand, reaped when idle. A task body must not evaluate other
        # slices synchronously.
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._pool_lock = threading.Lock()
        self._workers = 0
        self._idle = 0
        # Machine combiners: per combine key, each producer shard's
        # partitioned contributions; combined once when the last shard
        # lands, then committed per partition.
        self._mc_lock = threading.Lock()
        self._mc_contrib: dict = {}        # ck -> {shard: [parts]}
        self._mc_committed: dict = {}      # (ck, p) -> Frame
        self._mc_keys_committed: set = set()
        # Speculative duplicates (exec/adaptive.py): at most one racing
        # duplicate a task name.
        self._spec_lock = threading.Lock()
        self._spec_inflight: set = set()

    def _place(self, frame: Frame) -> Frame:
        return frame.to(self.device)

    def start(self, session) -> None:
        """Bind the session whose telemetry hub this executor reports
        into (``Session`` calls it)."""
        self.session = session

    def resource_stats(self) -> dict:
        """Host memory, the card's allocator stats on ``cuda``, and the
        task-thread bound (the status display's resource lines)."""
        from bigslice_tpu_torch.utils import resources as resources_mod

        return {
            "host_rss_bytes": resources_mod.host_rss_bytes(),
            "devices": resources_mod.device_memory(
                [self.device] if self.device.type == "cuda" else []),
            "gauges": {"procs": self.procs},
        }

    # -- telemetry seams (utils/telemetry.py): best-effort, never fail a
    # task -------------------------------------------------------------------

    def _telemetry_hub(self):
        return getattr(getattr(self, "session", None), "telemetry", None)

    def _launch_sink(self, task: Task):
        """The kernel-launch listener of ``task``'s op (None without a
        hub): each counted launch adds its declared cost to the op."""
        hub = self._telemetry_hub()
        if hub is None:
            return None
        op, inv = task.name.op, task.name.inv_index
        dev = hub.device

        def sink(name, cost):
            dev.record_launch(op, inv, name, cost)

        return sink

    def _record_shuffle(self, task: Task, rows: List[int],
                        nbytes: List[int]) -> None:
        """This producer's rows and bytes routed to each partition,
        before its combine: the hub sums producers elementwise."""
        hub = self._telemetry_hub()
        if hub is None:
            return
        try:
            hub.record_shuffle(task.name.op, task.name.inv_index, rows,
                               nbytes)
        except Exception:  # noqa: BLE001
            pass

    def _record_combine_input(self, op: str, inv: int, in_rows: int,
                              out_rows: int) -> None:
        """This producer's map-side combine: rows in and rows out."""
        hub = self._telemetry_hub()
        if hub is None:
            return
        try:
            hub.record_combine_input(op, inv, in_rows, out_rows)
        except Exception:  # noqa: BLE001
            pass

    # -- the executor interface (submit, reader, discard) -------------------

    def submit(self, task: Task) -> None:
        # Only a task that runs on this pool may be speculated.
        task._local_tier = True
        self._queue.put(task)
        with self._pool_lock:
            if self._idle == 0 and self._workers < self.procs:
                self._workers += 1
                threading.Thread(target=self._worker_loop,
                                 daemon=True).start()

    def _worker_loop(self) -> None:
        while True:
            with self._pool_lock:
                self._idle += 1
            try:
                task = self._queue.get(timeout=self.WORKER_IDLE_SECS)
            except queue.Empty:
                # A task queued after the timeout fired, while this
                # worker still counted as idle (so submit made no new
                # one), must not strand: look again under the lock.
                with self._pool_lock:
                    self._idle -= 1
                    try:
                        task = self._queue.get_nowait()
                    except queue.Empty:
                        self._workers -= 1
                        return
                self._run(task)
                continue
            with self._pool_lock:
                self._idle -= 1
            self._run(task)

    def reader(self, task: Task, partition: int) -> sliceio.Reader:
        return self.store.read(task.name, partition)

    def discard(self, task: Task) -> None:
        self.store.discard(task.name)
        # A coverage member's units live under cover names.
        grp = getattr(task, "coded_group", None)
        if grp is not None:
            for u, _do, _lo, _hi in getattr(task, "coded_units", ()):
                self.store.discard(grp.cover_name(u, task.name.shard))
        # Free the machine-combiner buffers this task consumed.
        with self._mc_lock:
            for dep in task.deps:
                if dep.combine_key:
                    self._mc_contrib.pop(dep.combine_key, None)
                    self._mc_keys_committed.discard(dep.combine_key)
                    for p in range(len(dep.tasks)):
                        self._mc_committed.pop((dep.combine_key, p), None)
        task.set_state(TaskState.LOST, RuntimeError("task discarded"))

    # -- task execution -----------------------------------------------------

    def _dep_factory(self, dep):
        grp = getattr(dep, "coded", None)
        if grp is not None:
            return self._coded_dep_factory(dep, grp)
        if dep.combine_key:
            # One shared, already-combined buffer a partition. No commit
            # means the producer group's buffers are gone: a lost dep,
            # never a silently empty input.
            def mc_factory():
                with self._mc_lock:
                    committed = dep.combine_key in self._mc_keys_committed
                    frame = self._mc_committed.get(
                        (dep.combine_key, dep.partition))
                if not committed:
                    # No shared buffers. Under a device executor the
                    # producer group may have run on the device path
                    # (machine-combined groups do, with a device
                    # combiner): its outputs then read through the store
                    # bridge, as its device residency confirms (a host
                    # group's own entries are empty by design). Anything
                    # else is a lost dep.
                    owner = getattr(self.store, "owner", None)
                    if owner is not None and all(
                            owner._has_device_output(t.name)
                            for t in dep.tasks):
                        return bridged()
                    raise DepLost(dep.tasks[0], all_producers=dep.tasks)
                if frame is None or not len(frame):
                    return sliceio.empty_reader()
                return iter([frame])

            def bridged():
                for t in dep.tasks:
                    try:
                        yield from self.store.read(t.name, dep.partition)
                    except store_mod.Missing as e:
                        raise DepLost(t, all_producers=dep.tasks) from e

            return mc_factory

        def lost(t, e):
            # A spilled shuffle partition holds every producer shard's
            # rows: the whole group reruns.
            if getattr(e, "spilled_group", False):
                return DepLost(t, dep.tasks)
            return DepLost(t)

        def factory():
            def gen():
                for t in dep.tasks:
                    # Missing may surface mid-stream too (a FileStore
                    # read that meets a corrupt frame): the producer is
                    # lost either way, not the consumer failed.
                    try:
                        yield from self.store.read(t.name, dep.partition)
                    except store_mod.Missing as e:
                        raise lost(t, e) from e

            return gen()

        return factory

    def _coded_stats(self):
        return getattr(getattr(self, "coded", None), "stats", None)

    def _coded_dep_factory(self, dep, grp):
        """The masked k-of-n read of a coverage group (reference
        exec/local.py:311-365): for each unit, exactly one owner's copy,
        the first owner in the group's order whose entry exists, so the
        consumer sees the frames the uncoded plan would give. A unit
        with no copy left is a lost dep: its owners rerun."""

        def factory():
            stats = self._coded_stats()

            def gen():
                for u in range(grp.k):
                    owners = grp.owners(u)
                    served = None
                    for oi in owners:
                        try:
                            reader = self.store.read(
                                grp.cover_name(u, oi), dep.partition)
                        except store_mod.Missing:
                            continue
                        served = oi
                        try:
                            yield from reader
                        except store_mod.Missing as e:
                            # Rows were yielded already: another owner's
                            # copy would duplicate them. Rerun the unit.
                            raise DepLost(grp.tasks[oi], all_producers=[
                                grp.tasks[j] for j in owners]) from e
                        break
                    if served is None:
                        raise DepLost(grp.tasks[owners[0]], all_producers=[
                            grp.tasks[j] for j in owners])
                    if stats is not None:
                        dup = sum(1 for oj in owners if oj != served
                                  and grp.tasks[oj].state == TaskState.OK)
                        if dup:
                            stats.record("masked", op=grp.op, unit=u,
                                         extra_copies=dup)

            return gen()

        return factory

    def _run(self, task: Task) -> None:
        permits = self._limiter.capacity if task.exclusive else task.procs
        self._limiter.acquire(permits)
        try:
            if not task.transition_if(TaskState.WAITING, TaskState.RUNNING):
                return  # another evaluation claimed it
            if faultinject.ENABLED:
                # Chaos seam after the RUNNING claim (reference
                # exec/local.py:373-382): 'slow' delays the body, 'stuck'
                # parks until cancelled, 'lose' drops the run to LOST.
                fault = faultinject.fire("task.run")
                fault = faultinject.absorb_slow_or_stuck(fault, task)
                if fault is not None:
                    raise faultinject.injected_error(fault)
            from bigslice_tpu_torch.parallel import cuda_kernels

            with metrics_mod.scope_context(task.scope), \
                    cuda_kernels.launch_sink(self._launch_sink(task)):
                self._execute(task)
            task.mark_ok()
        except TaskCancelled:
            # CANCELLED only if still RUNNING: losing the CAS means
            # another path settled the task (a duplicate won).
            task.transition_if(TaskState.RUNNING, TaskState.CANCELLED)
        except faultinject.InjectedLoss as e:
            task.mark_lost(e)
        except DepLost as e:
            # A dependency's output vanished: this run is lost, and so
            # are its producers; the evaluator reruns them first.
            for p in e.producers:
                p.mark_lost(e)
            task.mark_lost(e)
        except Exception as e:  # noqa: BLE001 — settles as the task's error
            task.set_state(TaskState.ERR, e)
        finally:
            self._limiter.release(permits)

    # -- speculative duplicates (exec/adaptive.py) ------------------------

    def speculate(self, task: Task, on_outcome=None) -> bool:
        """Race a duplicate of a RUNNING task on a free permit (reference
        exec/local.py:408-448); True when it launched. The first to
        finish wins by the atomic RUNNING → OK transition; deterministic
        bodies make the loser's store puts idempotent. Never speculated:
        a task not run by this pool, an exclusive, machine-combined or
        coded task. ``on_outcome`` hears ``"won"`` or ``"wasted"``."""
        if not getattr(task, "_local_tier", False):
            return False
        if task.exclusive or task.partitioner.combine_key:
            return False
        if getattr(task, "coded_group", None) is not None:
            return False
        if task.state != TaskState.RUNNING:
            return False
        with self._spec_lock:
            if task.name in self._spec_inflight:
                return False
            self._spec_inflight.add(task.name)
        if not self._limiter.try_acquire(task.procs):
            with self._spec_lock:
                self._spec_inflight.discard(task.name)
            return False
        threading.Thread(target=self._run_speculative,
                         args=(task, on_outcome), daemon=True,
                         name=f"speculate-{task.name.op}").start()
        return True

    def _run_speculative(self, task: Task, on_outcome) -> None:
        won = False
        try:
            from bigslice_tpu_torch.parallel import cuda_kernels

            with metrics_mod.scope_context(task.scope), \
                    cuda_kernels.launch_sink(self._launch_sink(task)):
                self._execute(task, record_telemetry=False)
            won = task.transition_if(TaskState.RUNNING, TaskState.OK)
        except Exception:  # noqa: BLE001 — the original still runs;
            pass           # its own ladder judges the task
        finally:
            self._limiter.release(task.procs)
            with self._spec_lock:
                self._spec_inflight.discard(task.name)
        if won:
            with task._lock:
                task.consecutive_lost = 0
        if on_outcome is not None:
            try:
                on_outcome("won" if won else "wasted")
            except Exception:  # noqa: BLE001
                pass

    def _execute(self, task: Task, record_telemetry: bool = True) -> None:
        if getattr(task, "coded_units", None):
            self._execute_coded(task, record_telemetry)
            return
        spillers: List[Optional[object]] = []
        try:
            self._execute_inner(task, spillers, record_telemetry)
        finally:
            # Spill directories never outlive the task.
            for sp in spillers:
                if sp is not None:
                    sp.cleanup()

    def _execute_coded(self, task: Task,
                       record_telemetry: bool = True) -> None:
        """A coverage member (reference exec/local.py:504-593): each unit
        is one uncoded shard's work (its do closure over its dep slice),
        routed and combined as that shard's, stored under the unit's
        cover name. Cancellation seams between units and frames stop a
        member coverage made redundant."""
        grp = task.coded_group
        comb = task.combiner
        nparts = task.num_partition
        stats = self._coded_stats()
        for u, do_u, lo, hi in task.coded_units:
            task.check_cancel()
            if faultinject.ENABLED:
                # Chaos seam a unit (reference exec/local.py:520-527).
                fault = faultinject.fire("coded.cover")
                fault = faultinject.absorb_slow_or_stuck(fault, task)
                if fault is not None:
                    raise faultinject.injected_error(fault)
            factories = [self._dep_factory(d) for d in task.deps[lo:hi]]
            reader = do_u(factories, place=self._place)
            parts: List[List[Frame]] = [[] for _ in range(nparts)]
            pending_rows = [0] * nparts
            flush_at = [COMBINE_FLUSH_ROWS] * nparts
            routed_rows = [0] * nparts
            routed_bytes = [0] * nparts
            in_rows = 0
            for frame in reader:
                if not len(frame):
                    continue
                task.check_cancel()
                in_rows += len(frame)
                ids = task.partitioner.partition_ids(frame, nparts)
                for p, sub in enumerate(partition_frame(frame, ids, nparts)):
                    if not len(sub):
                        continue
                    routed_rows[p] += len(sub)
                    routed_bytes[p] += _frame_nbytes(sub)
                    parts[p].append(sub)
                    pending_rows[p] += len(sub)
                    if pending_rows[p] >= flush_at[p]:
                        combined = comb.combine_frames(parts[p])
                        parts[p] = [combined] if len(combined) else []
                        pending_rows[p] = len(combined)
                        flush_at[p] = max(COMBINE_FLUSH_ROWS,
                                          2 * len(combined))
            name = grp.cover_name(u, task.name.shard)
            out_rows = 0
            for p in range(nparts):
                out = comb.combine_frames(parts[p])
                out_rows += len(out)
                self.store.put(name, p, [out] if len(out) else [])
            if record_telemetry:
                # Under the logical op (the uncoded name): the boundary's
                # true cardinality, whichever plan computed it.
                self._record_combine_input(grp.op, task.name.inv_index,
                                           in_rows, out_rows)
                if nparts > 1:
                    hub = self._telemetry_hub()
                    if hub is not None:
                        try:
                            hub.record_shuffle(grp.op, task.name.inv_index,
                                               routed_rows, routed_bytes)
                        except Exception:  # noqa: BLE001
                            pass
            if stats is not None:
                stats.record("unit", op=grp.op, unit=u,
                             member=task.name.shard, rows=in_rows)
        # The member's own entries commit empty: consumers read the
        # per-unit cover names.
        for p in range(nparts):
            self.store.put(task.name, p, [])

    def _execute_inner(self, task: Task, spillers,
                       record_telemetry: bool = True) -> None:
        factories = [self._dep_factory(d) for d in task.deps]
        reader = task.do(factories, place=self._place)
        nparts = task.num_partition
        comb = task.combiner
        if nparts <= 1 and comb is None:
            # Streamed: a streaming store writes batch by batch without
            # holding the shard. The cancellation seam rides the stream.
            def stream():
                for f in reader:
                    task.check_cancel()
                    if len(f):
                        yield f

            self.store.put(task.name, 0, stream())
            return
        parts: List[List[Frame]] = [[] for _ in range(nparts)]
        pending_rows = [0] * nparts
        flush_at = [COMBINE_FLUSH_ROWS] * nparts
        spillers.extend([None] * nparts)
        # Rows and bytes routed to each partition, before the combine:
        # the honest skew signal of a combining shuffle, whose output
        # sizes are its distinct keys and hide a hot key. The lengths
        # are host ints already (partition_frame read its bounds back).
        routed_rows = [0] * nparts
        routed_bytes = [0] * nparts
        for frame in reader:
            if not len(frame):
                continue
            task.check_cancel()
            ids = task.partitioner.partition_ids(frame, nparts)
            for p, sub in enumerate(partition_frame(frame, ids, nparts)):
                if not len(sub):
                    continue
                routed_rows[p] += len(sub)
                routed_bytes[p] += _frame_nbytes(sub)
                parts[p].append(sub)
                pending_rows[p] += len(sub)
                if comb is not None and pending_rows[p] >= flush_at[p]:
                    # Incremental pre-combine; the doubling trigger keeps
                    # it amortized when distinct keys exceed the
                    # threshold.
                    combined = comb.combine_frames(parts[p])
                    parts[p] = [combined] if len(combined) else []
                    pending_rows[p] = len(combined)
                    flush_at[p] = max(COMBINE_FLUSH_ROWS,
                                      2 * len(combined))
                elif (comb is None and self.store.streaming
                        and pending_rows[p] >= SHUFFLE_SPILL_ROWS):
                    # A pure shuffle over a streaming store: spill the
                    # partition buffer and stream it back at store time.
                    # (Into a memory store a disk round trip buys
                    # nothing.)
                    if spillers[p] is None:
                        spillers[p] = sortio.Spiller()
                    spillers[p].spill(iter(parts[p]))
                    parts[p] = []
                    pending_rows[p] = 0
        if nparts > 1 and record_telemetry:
            # A speculative duplicate skips it: the original's routed
            # sizes are counted already.
            self._record_shuffle(task, routed_rows, routed_bytes)
        if comb is not None and task.partitioner.combine_key:
            self._machine_combine(task, parts)
            return
        combined_out_rows = 0
        for p in range(nparts):
            if comb is not None:
                out = comb.combine_frames(parts[p])
                combined_out_rows += len(out)
                frames = [out] if len(out) else []
            elif spillers[p] is not None:
                # The spilled runs, then the in-memory tail, streamed
                # into the store; the spill files go once consumed.
                sp, tail = spillers[p], parts[p]

                def rehydrate(sp=sp, tail=tail):
                    for r in sp.readers():
                        yield from r
                    yield from tail

                self.store.put(task.name, p, rehydrate())
                sp.cleanup()
                continue
            else:
                frames = parts[p]
            self.store.put(task.name, p, frames)
        if comb is not None and record_telemetry:
            self._record_combine_input(task.name.op, task.name.inv_index,
                                       sum(routed_rows), combined_out_rows)

    def _machine_combine(self, task: Task, parts: List[List[Frame]]) -> None:
        """Contribute this shard's partitioned output to the shared
        machine combiner; the last shard in combines and commits each
        partition once (a rerun's contribution replaces, never
        duplicates)."""
        ck = task.partitioner.combine_key
        nparts = task.num_partition
        with self._mc_lock:
            if ck in self._mc_keys_committed:
                # The raw contributions were freed at commit, so a
                # partial re-combine would be wrong: fail loudly.
                raise RuntimeError(
                    f"machine combiner {ck} received a contribution after "
                    f"commit (producer rerun); rerun the whole session or "
                    f"disable machine_combiners for lossy executors")
            contrib = self._mc_contrib.setdefault(ck, {})
            contrib[task.name.shard] = parts
            complete = len(contrib) == task.name.num_shard
            snapshot = dict(contrib) if complete else None
        # The task's own entries stay empty: consumers read the shared
        # committed buffers through the combine_key dep path.
        for p in range(nparts):
            self.store.put(task.name, p, [])
        if not complete:
            return
        comb = task.combiner
        committed = {}
        for p in range(nparts):
            frames: List[Frame] = []
            for shard_parts in snapshot.values():
                frames.extend(shard_parts[p])
            committed[(ck, p)] = comb.combine_frames(frames)
        with self._mc_lock:
            self._mc_committed.update(committed)
            self._mc_keys_committed.add(ck)
            self._mc_contrib.pop(ck, None)
