"""Host-tier tasks over ranks: each runs once, on an owner rank.

Over ``torch.distributed`` ranks the device groups run as one program
on every rank (``exec/meshexec.py``), but a task the device path cannot
lower (a host-tier task, ``MeshExecutor._eligible``) would otherwise run
redundantly on every rank: a host-tier Cogroup over N ranks would be one
rank's speed N times over. This module (reference exec/hostdist.py)
gives each such task a deterministic OWNER (``task.name.shard %
process_count``: every rank computes the same from the same compiled
graph), runs it only there, and exchanges its committed outputs through
the process group's key-value store (the c10d store, which the
keepalive also uses):

- the owner runs the task on its host tier and, when it settles OK,
  publishes each output partition (frame-codec bytes, chunked at
  ``CHUNK_BYTES``) into an immutable per-attempt namespace
  (``<task>/a<N>/…``), then flips the task's epoch pointer
  (``<task>/e``). An epoch's keys never change after its pointer is
  written, so a reader that saw epoch N reads a complete set even while
  the owner publishes N+1 (a re-run after output loss); the owner then
  deletes epoch N;
- a non-owner claims the task, and one poller thread resolves it when
  the owner's pointer appears (OK or ERR, mirrored). The data is NOT
  copied eagerly: a non-owner fetches a partition only when something
  on that rank reads it (``fetch``, through the executor's store);
- owner loss comes from the keepalive (``utils/distributed.Keepalive``):
  a lost owner's tasks are LOST (the evaluator's ladder, and an elastic
  session's gang-loss classification, take over). The absolute deadline
  ``STATE_TIMEOUT_SECS`` holds only for an owner with no liveness
  signal: while its beat advances, a slow but healthy owner extends it;
- the store is kept clean: an owner deletes an epoch when it publishes
  the next; ``release_run`` deletes every non-root task's namespace once
  every rank has finished the run (a barrier first: a peer may still be
  fetching); ``close`` deletes everything this rank published and
  leaves a tombstone, so that peers still waiting on it resolve. Every
  exchange publishes its generation (its ordinal among its process's
  exchanges, counted in the store) and its tombstone holds it. The
  ranks of one program build their sessions in the same order, so a
  peer waiting on an owner compares generations and checks that rule:
  a tombstone of its own generation is this session's close; an owner
  at a lower one is still in a previous session, whose tombstone must
  not fail a task of this one (its next exchange deletes it), and a task
  waits for it at most ``STATE_TIMEOUT_SECS``, beat or not; an owner at
  a higher one has left this session. The last two end the task by name
  (``_owner_verdict``) rather than wait on a close that never comes.
  ``abort_run`` publishes an abort epoch for every owned task of a dead
  run, so that waiting peers resolve to ERR; a later attempt ignores
  those (the epoch floor of ``submit``).

The c10d store differs from the JAX package's coordination KV in three
ways, handled here: its ``get`` blocks until a key exists (every read
``check``s first); it has no directory get or delete (each namespace's
keys are indexed as they are written, and deleted one by one); and the
release barrier is one over the store too (a counter each rank adds to,
polled with the reference's timeout), not one over the control group,
whose collectives the executor's dispatcher thread may be issuing at
the same time.

Machine-combined groups (``Session(machine_combiners=True)``) are
excluded: their per-process combiner buffers need every producer's
contribution in-process, so they keep the redundant model. A
side-effecting sink (``WriterFunc``) runs once under distribution.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Dict, List, Optional, Set

from bigslice_tpu_torch.exec.task import Task, TaskName, TaskState

__all__ = ["CHUNK_BYTES", "HostTaskExchange", "POLL_SECS", "PREFIX",
           "STATE_TIMEOUT_SECS"]

#: Bytes of frame-codec data a store value holds at most.
CHUNK_BYTES = 1 << 20

#: How long a non-owner waits for the owner's epoch pointer when the
#: owner has no liveness signal (keepalive inactive, or no beat seen
#: yet). A beating owner is trusted indefinitely.
STATE_TIMEOUT_SECS = float(os.environ.get("BIGSLICE_STATE_TIMEOUT_SECS",
                                          600.0))

#: The poller's cadence.
POLL_SECS = 0.1

#: How long ``release_run`` waits for its peers before it keeps the keys
#: (a missing peer means the group is about to fail anyway).
RELEASE_BARRIER_MS = 15_000

PREFIX = "bigslice/hostdist"
CLOSED_PREFIX = "bigslice/hostdist_closed"
GEN_PREFIX = "bigslice/hostdist_gen"

# Serialises a process's generation counts (its own key only: no other
# process writes it).
_GEN_LOCK = threading.Lock()


def _base_key(name: TaskName) -> str:
    return f"{name.inv_index}|{name.op}|{name.shard}|{name.num_shard}"


def _default_store():
    from torch.distributed import distributed_c10d

    return distributed_c10d._get_default_store()


class HostTaskExchange:
    """Owner-routed host-task execution over the process group's store
    (reference exec/hostdist.py:93-529). ``owned_count`` and
    ``remote_count`` count the host tasks this rank ran and the ones it
    resolved from their owners (``owned_tasks``, ``remote_tasks``: their
    names); ``fetched`` lists the (task, partition) it fetched."""

    def __init__(self, executor, keepalive=None, store=None,
                 pid: Optional[int] = None, nprocs: Optional[int] = None):
        from bigslice_tpu_torch.utils import distributed

        self.executor = executor
        if store is None and distributed.is_initialized():
            store = _default_store()
        self.client = store
        self.pid = distributed.process_index() if pid is None else pid
        self.nprocs = (distributed.process_count() if nprocs is None
                       else nprocs)
        self.keepalive = keepalive
        self.owned_tasks: List[str] = []
        self.remote_tasks: List[str] = []
        self.fetched: List[tuple] = []
        # (task, partition) -> why its last fetch found no data.
        self.miss_reason: Dict[tuple, str] = {}
        self._lock = threading.Lock()
        self._pending: Dict[str, tuple] = {}  # key -> (task, owner, t0, floor)
        self._poller: Optional[threading.Thread] = None
        # Owner-side bookkeeping for the store's hygiene.
        self._epoch: Dict[str, int] = {}      # base key -> last published
        self._published: Set[str] = set()     # base keys with live data
        self._roots: Set[str] = set()         # ever-root base keys (kept)
        self._keys: Dict[str, Set[str]] = {}  # namespace -> its keys
        self._barrier_seq: Dict[str, int] = {}
        self._closed = False
        # Owners that will never resolve a task here (why, sticky), the
        # per-owner check throttle, and since when an owner has been at
        # an earlier exchange than this one.
        self._owner_done: Dict[int, str] = {}
        self._closed_checked: Dict[int, float] = {}
        self._behind_since: Dict[int, float] = {}
        self.gen = 0
        if self.active:
            with _GEN_LOCK:
                prev = self._raw_try_get(f"{GEN_PREFIX}/{self.pid}")
                self.gen = (int(prev) if prev is not None else 0) + 1
                self.client.set(f"{GEN_PREFIX}/{self.pid}", str(self.gen))
            # A previous exchange of this process left its tombstone:
            # peers of this one would resolve every task it owns to ERR.
            self._raw_delete(f"{CLOSED_PREFIX}/{self.pid}")

    @property
    def owned_count(self) -> int:
        return len(self.owned_tasks)

    @property
    def remote_count(self) -> int:
        return len(self.remote_tasks)

    @property
    def active(self) -> bool:
        return self.client is not None and self.nprocs > 1

    def owner_of(self, task: Task) -> int:
        return task.name.shard % self.nprocs

    def distributable(self, task: Task) -> bool:
        """Machine-combined groups keep the redundant model: their
        shared in-process combiner buffers need every producer's
        contribution locally."""
        if task.partitioner.combine_key:
            return False
        return not any(d.combine_key for d in task.deps)

    # -- submission routing ------------------------------------------------

    def submit(self, task: Task) -> bool:
        """Route a host task: True when handled here (a non-owner waits
        for its owner); False when the caller runs it locally (the
        owner, or a task that is not distributable)."""
        if not self.active or not self.distributable(task):
            return False
        owner = self.owner_of(task)
        if owner == self.pid:
            with self._lock:
                self.owned_tasks.append(str(task.name))
            # A resubmission after LOST must not stack subscriptions.
            if not getattr(task, "_hostdist_pub", False):
                task._hostdist_pub = True
                self._publish_on_completion(task)
            return False
        if not task.transition_if(TaskState.WAITING, TaskState.RUNNING):
            return True  # another evaluation claimed it
        base = _base_key(task.name)
        # An abort marker of a DEAD run must not resolve this attempt: it
        # is the epoch floor; only newer epochs count.
        floor = -1
        e = self._try_get(f"{base}/e")
        if e is not None:
            st = self._try_get(f"{base}/a{int(e)}/state") or ""
            if st.startswith("err:run aborted"):
                floor = int(e)
        with self._lock:
            self.remote_tasks.append(str(task.name))
            self._pending[base] = (task, owner, time.monotonic(), floor)
            if self._poller is None:
                self._poller = threading.Thread(
                    target=self._poll_loop, name="bigslice-hostdist",
                    daemon=True)
                self._poller.start()
        return True

    # -- owner side --------------------------------------------------------

    def _publish_on_completion(self, task: Task) -> None:
        def on_state(t: Task, state: TaskState) -> None:
            if state == TaskState.OK:
                try:
                    self._publish_epoch(t, "ok")
                except Exception as e:  # noqa: BLE001
                    # Peers resolve to ERR rather than wait.
                    self._try_publish_epoch(t, f"err:publish failed: {e!r}")
                t.unsubscribe(on_state)
                t._hostdist_pub = False  # re-armed for a re-run
            elif state == TaskState.ERR:
                err = repr(t.error) if t.error else "task error"
                self._try_publish_epoch(t, f"err:{err}")
                t.unsubscribe(on_state)
                t._hostdist_pub = False
            # LOST: nothing; the evaluator resubmits it.

        task.subscribe(on_state)

    def _publish_epoch(self, task: Task, state: str) -> None:
        """Publish the outputs (``state == "ok"``) and the state marker
        into a fresh epoch namespace, flip the pointer, then delete the
        previous epoch."""
        from bigslice_tpu_torch.exec.store import Missing
        from bigslice_tpu_torch.frame import codec

        base = _base_key(task.name)
        with self._lock:
            if self._closed:
                # A straggling completion after teardown must not bring
                # deleted namespaces back.
                return
            epoch = self._epoch.get(base, -1) + 1
            self._epoch[base] = epoch
        ns = f"{base}/a{epoch}"
        if state == "ok":
            for p in range(max(1, task.num_partition)):
                try:
                    frames = list(self.executor.store.read(task.name, p))
                except (Missing, KeyError):
                    frames = []
                blob = b"".join(codec.encode_frame(f) for f in frames)
                chunks = [blob[i: i + CHUNK_BYTES]
                          for i in range(0, len(blob), CHUNK_BYTES)] or [b""]
                for i, c in enumerate(chunks):
                    self._set(f"{ns}/p{p}/c{i}", c, ns)
                self._set(f"{ns}/p{p}/n", str(len(chunks)), ns)
        self._set(f"{ns}/state", state, ns)
        # The pointer last: a reader that sees epoch N sees all of it.
        self._set(f"{base}/e", str(epoch), base)
        with self._lock:
            self._published.add(base)
        if epoch > 0:
            self._delete_ns(f"{base}/a{epoch - 1}")

    def _try_publish_epoch(self, task: Task, state: str) -> None:
        try:
            self._publish_epoch(task, state)
        except Exception:  # noqa: BLE001 — the store is going away
            pass

    # -- non-owner side ----------------------------------------------------

    def _resolve_state(self, base: str, floor: int = -1) -> Optional[str]:
        """The owner's latest state for ``base``, or None if not yet
        published (epochs at or below ``floor`` count as unpublished)."""
        e = self._try_get(f"{base}/e")
        if e is None or int(e) <= floor:
            return None
        return self._try_get(f"{base}/a{int(e)}/state")

    def _owner_beating(self, owner: int) -> bool:
        """True when the owner's keepalive beat advanced within the
        keepalive's timeout: a live, computing owner, which suspends the
        absolute deadline."""
        ka = self.keepalive
        if ka is None or not getattr(ka, "active", False):
            return False
        age = ka.age(owner)
        return age is not None and age < ka.timeout

    def _poll_loop(self) -> None:
        while True:
            with self._lock:
                items = list(self._pending.items())
            if not items:
                time.sleep(POLL_SECS)
                continue
            lost = {p for p, _ in (self.keepalive.lost_peers()
                                   if self.keepalive else [])}
            for key, (task, owner, t0, floor) in items:
                state = self._resolve_state(key, floor)
                if state is not None:
                    with self._lock:
                        self._pending.pop(key, None)
                    if state == "ok":
                        task.mark_ok()
                    else:
                        task.set_state(TaskState.ERR, RuntimeError(
                            f"remote host task failed on process {owner}: "
                            f"{state[4:]}"))
                elif (verdict := self._owner_verdict(owner)) is not None:
                    # The owner will never publish this session's state.
                    with self._lock:
                        self._pending.pop(key, None)
                    task.set_state(TaskState.ERR, RuntimeError(
                        f"host task {task.name} unresolvable: {verdict}"))
                elif owner in lost:
                    with self._lock:
                        self._pending.pop(key, None)
                    task.mark_lost(RuntimeError(
                        f"owner process {owner} of host task {task.name} "
                        f"judged lost by keepalive"))
                elif time.monotonic() - t0 > STATE_TIMEOUT_SECS:
                    if self._owner_beating(owner):
                        # Healthy but slow: extend.
                        with self._lock:
                            if key in self._pending:
                                self._pending[key] = (
                                    task, owner, time.monotonic(), floor)
                        continue
                    with self._lock:
                        self._pending.pop(key, None)
                    task.mark_lost(RuntimeError(
                        f"host task {task.name} unresolved by owner process "
                        f"{owner} after {STATE_TIMEOUT_SECS}s with no "
                        f"liveness signal"))
            time.sleep(POLL_SECS)

    # -- data fetch (the store bridge) -------------------------------------

    def fetch(self, name: TaskName, partition: int,
              timeout: float = 30.0) -> Optional[List]:
        """A remote task's partition frames, or None if the task is not
        published (not a distributed host task) or failed; why is in
        ``miss_reason[(str(name), partition)]``. By the time a consumer
        reads, the owner has published (the pointer follows the data),
        so one pass normally does. A state that cannot be read (being
        replaced, or a store read that failed) is read again until
        ``timeout``: only a published failure ends the wait early."""
        if not self.active:
            return None
        from bigslice_tpu_torch.frame import codec

        base = _base_key(name)
        deadline = time.monotonic() + timeout
        blob = None
        why = "no epoch pointer"
        while True:
            e = self._try_get(f"{base}/e")
            if e is not None:
                ns = f"{base}/a{int(e)}"
                state = self._try_get(f"{ns}/state")
                if state is not None and state != "ok":
                    if self._try_get(f"{base}/e") != e:
                        continue  # republished between the two reads
                    self.miss_reason[(str(name), partition)] = (
                        f"epoch {e} {state[:200]}")
                    return None   # failed remotely: no data coming
                why = f"epoch {e}: no state"
                n = None if state is None else self._try_get(
                    f"{ns}/p{partition}/n")
                chunks = [] if n is None else [
                    self._try_get_bytes(f"{ns}/p{partition}/c{i}")
                    for i in range(int(n))]
                # Only an assembly whose pointer is unchanged afterwards
                # is of one generation.
                if (n is not None and None not in chunks
                        and self._try_get(f"{base}/e") == e):
                    blob = b"".join(chunks)
                    break
                if state is not None:
                    why = f"epoch {e}: partition {partition} incomplete"
            if time.monotonic() > deadline:
                self.miss_reason[(str(name), partition)] = (
                    f"{why} after {timeout}s")
                return None
            time.sleep(POLL_SECS)
        frames = []
        off = 0
        while off < len(blob):
            f, off = codec.decode_frame(blob, off)
            frames.append(f)
        with self._lock:
            self.fetched.append((str(name), partition))
        return frames

    def abort_run(self, roots: List[Task], err) -> None:
        """The local evaluation died: publish an abort epoch for every
        OWNED, distributable, host-tier task of the run not OK, so that
        non-owners waiting on it resolve to ERR (the owner is alive; its
        run is what died)."""
        if not self.active:
            return
        from bigslice_tpu_torch.exec.task import iter_tasks

        eligible = getattr(self.executor, "_eligible", None)
        for t in iter_tasks(roots):
            if (self.owner_of(t) != self.pid or not self.distributable(t)
                    or t.state == TaskState.OK):
                continue
            if eligible is not None and eligible(t, count=False):
                continue  # device-tier: never owner-routed
            self._try_publish_epoch(t, f"err:run aborted on owner: {err!r}")

    # -- the store's hygiene -----------------------------------------------

    def release_run(self, roots: List[Task]) -> None:
        """After a run completes, on every rank: a barrier, then delete
        this rank's namespaces of the run's NON-root tasks. Roots stay
        (a later scan or Result reuse reads them lazily) until
        ``close``."""
        if not self.active:
            return
        from bigslice_tpu_torch.exec.task import iter_tasks

        root_keys = {_base_key(t.name) for t in roots}
        all_keys = {_base_key(t.name) for t in iter_tasks(roots)}
        with self._lock:
            self._roots |= root_keys
            doomed = sorted((all_keys - self._roots) & self._published)
        # A barrier id from the run's content: concurrent runs may end in
        # different orders on different ranks, but each run's graph is
        # the same everywhere (sequence-suffixed for repeats).
        digest = hashlib.md5("|".join(sorted(all_keys)).encode()
                             ).hexdigest()[:16]
        with self._lock:
            seq = self._barrier_seq.get(digest, 0)
            self._barrier_seq[digest] = seq + 1
        if not self._barrier(digest, seq, RELEASE_BARRIER_MS):
            return  # a peer missing or slow: keep the keys
        for base in doomed:
            self._delete_ns(base)
            with self._lock:
                self._published.discard(base)
                self._epoch.pop(base, None)

    def _barrier(self, digest: str, seq: int, timeout_ms: int) -> bool:
        """Every rank adds one to the barrier's counter, then waits until
        it reaches the rank count (False after ``timeout_ms``). The key
        of the barrier two before this one is deleted: every rank has
        left it, since every rank reached the one before this."""
        key = f"{PREFIX}_barrier/{digest}/{seq}"
        try:
            self.client.add(key, 1)
            if seq >= 2:
                self._raw_delete(f"{PREFIX}_barrier/{digest}/{seq - 2}")
            deadline = time.monotonic() + timeout_ms / 1000.0
            while self.client.add(key, 0) < self.nprocs:
                if time.monotonic() > deadline:
                    return False
                time.sleep(POLL_SECS / 10)
            return True
        except Exception:  # noqa: BLE001 — the store is going away
            return False

    def _owner_verdict(self, owner: int) -> Optional[str]:
        """Why the owner will never resolve a task of this exchange, or
        None while it still may (module docstring): it closed this
        session (its tombstone holds this generation), it is at a later
        exchange than this one, or it has stayed at an earlier one for
        ``STATE_TIMEOUT_SECS``. Sticky; read at most once every 2 s an
        owner."""
        if owner in self._owner_done:
            return self._owner_done[owner]
        now = time.monotonic()
        if now - self._closed_checked.get(owner, 0.0) < 2.0:
            return None
        self._closed_checked[owner] = now
        tomb = self._raw_try_get(f"{CLOSED_PREFIX}/{owner}")
        gen = self._raw_try_get(f"{GEN_PREFIX}/{owner}")
        gen = int(gen) if gen is not None else 0
        verdict = None
        if tomb is not None and int(tomb) == self.gen:
            verdict = f"owner process {owner} closed its session"
        elif gen > self.gen or (tomb is not None and int(tomb) > self.gen):
            verdict = (f"owner process {owner} is at host-task exchange "
                       f"{gen}, process {self.pid} at {self.gen}: the owner "
                       f"left this session, or the ranks built their "
                       f"sessions in different orders")
        elif gen < self.gen:
            since = self._behind_since.setdefault(owner, now)
            if now - since >= STATE_TIMEOUT_SECS:
                verdict = (f"owner process {owner} still at host-task "
                           f"exchange {gen} after {STATE_TIMEOUT_SECS}s, "
                           f"process {self.pid} at {self.gen}: the ranks "
                           f"built their sessions in different orders")
        else:
            self._behind_since.pop(owner, None)
        if verdict is not None:
            self._owner_done[owner] = verdict
        return verdict

    def close(self) -> None:
        """Delete everything this rank published (session teardown) and
        leave a tombstone under a separate prefix, so that peers still
        waiting on this owner resolve instead of trusting its keepalive
        forever."""
        if not self.active:
            return
        with self._lock:
            self._closed = True
            doomed = sorted(self._published)
            self._published.clear()
            self._epoch.clear()
        try:
            self.client.set(f"{CLOSED_PREFIX}/{self.pid}", str(self.gen))
        except Exception:  # noqa: BLE001 — the store is going away
            pass
        for base in doomed:
            self._delete_ns(base)

    # -- store helpers -----------------------------------------------------

    def _set(self, key: str, value, ns: str) -> None:
        """Write ``key`` and index it under its namespace ``ns`` (the
        store has no directory delete)."""
        self.client.set(f"{PREFIX}/{key}", value)
        with self._lock:
            self._keys.setdefault(ns, set()).add(key)

    def _delete_ns(self, ns: str) -> None:
        """Delete every key indexed under ``ns`` and under namespaces
        within it (``<base>`` holds its pointer, ``<base>/aN`` an
        epoch)."""
        with self._lock:
            names = [n for n in self._keys
                     if n == ns or n.startswith(ns + "/")]
            keys = [k for n in names for k in self._keys.pop(n)]
        for k in keys:
            self._raw_delete(f"{PREFIX}/{k}")

    def _raw_delete(self, key: str) -> None:
        try:
            self.client.delete_key(key)
        except Exception:  # noqa: BLE001 — absent, or the store is going
            pass

    def _raw_try_get(self, key: str) -> Optional[bytes]:
        """``get`` without its wait: ``check`` first (the store's ``get``
        blocks until a key exists)."""
        try:
            if not self.client.check([key]):
                return None
            return self.client.get(key)
        except Exception:  # noqa: BLE001 — deleted in between, or gone
            return None

    def _try_get_bytes(self, key: str) -> Optional[bytes]:
        v = self._raw_try_get(f"{PREFIX}/{key}")
        return None if v is None else bytes(v)

    def _try_get(self, key: str) -> Optional[str]:
        v = self._raw_try_get(f"{PREFIX}/{key}")
        return None if v is None else bytes(v).decode()
