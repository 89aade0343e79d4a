"""The host-task exchange (``exec/hostdist.py``) against the JAX package's.

The reference's nine units of ``tests/test_hostdist.py`` run against a
fake c10d store (the port's key-value store: ``set``, a blocking
``get``, ``check``, ``delete_key``, ``add``), pinning the mechanics that
are hard to provoke across real processes: the epoch pointer written
last, the keepalive-extended deadline, the store's hygiene. Then a
2-rank gloo world runs a host-tier word count and a host Cogroup
through ``spmd_session``: every host task runs on exactly one rank, a
rank fetches only the remote partitions it reads, and the rows equal
the JAX package's one-process rows.
"""

import concurrent.futures
import os
import pickle
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.exec.session import Session as RefSession  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.exec import hostdist as hd_mod  # noqa: E402
from bigslice_tpu_torch.exec.hostdist import (HostTaskExchange,  # noqa: E402
                                              _base_key)
from bigslice_tpu_torch.exec.task import (Partitioner, Task,  # noqa: E402
                                          TaskDep, TaskName, TaskState)
from bigslice_tpu_torch.frame.frame import Frame  # noqa: E402
from bigslice_tpu_torch.slicetype import Schema  # noqa: E402
from bigslice_tpu_torch.tools import multihost_smoke  # noqa: E402

import torch_spmd_scenarios as scen  # noqa: E402

P = "bigslice/hostdist/"


class FakeStore:
    """A dict standing in for the c10d store, with its API and a log of
    writes, deletes and barrier adds (ordering assertions)."""

    def __init__(self):
        self.kv = {}
        self.log = []
        self.lock = threading.Lock()

    def set(self, key, value):
        with self.lock:
            self.kv[key] = value.encode() if isinstance(value, str) \
                else bytes(value)
            self.log.append(("set", key))

    def get(self, key):
        with self.lock:
            if key not in self.kv:
                raise RuntimeError(f"timeout waiting for {key}")
            return self.kv[key]

    def check(self, keys):
        with self.lock:
            return all(k in self.kv for k in keys)

    def delete_key(self, key):
        with self.lock:
            self.log.append(("del", key))
            return self.kv.pop(key, None) is not None

    def add(self, key, n):
        with self.lock:
            v = int(self.kv.get(key, b"0")) + n
            self.kv[key] = str(v).encode()
            self.log.append(("add", key))
            return v

    def compare_set(self, key, expected, desired):
        """c10d's: set ``desired`` where the key holds ``expected`` (or is
        absent and ``expected`` is empty); the value after, and for an
        absent key with another ``expected``, that ``expected``."""
        expected = expected.encode() if isinstance(expected, str) \
            else bytes(expected)
        desired = desired.encode() if isinstance(desired, str) \
            else bytes(desired)
        with self.lock:
            if key not in self.kv:
                if expected:
                    return expected
                self.kv[key] = desired
            elif self.kv[key] == expected:
                self.kv[key] = desired
            return self.kv[key]


class FakeFrames:
    def __init__(self, frames=None):
        self.frames = frames or {}

    def read(self, name, partition):
        try:
            return iter(self.frames[(name, partition)])
        except KeyError:
            raise KeyError((name, partition))


class FakeExecutor:
    def __init__(self, store=None):
        self.store = store or FakeFrames()


class FakeKeepalive:
    def __init__(self, timeout=5.0):
        self.active = True
        self.timeout = timeout
        self._age = {}
        self._lost = []

    def age(self, pid):
        return self._age.get(pid)

    def lost_peers(self):
        return list(self._lost)


def make_exchange(nprocs=2, pid=0, keepalive=None, frames=None,
                  store=None):
    return HostTaskExchange(FakeExecutor(frames), keepalive=keepalive,
                            store=store or FakeStore(), pid=pid,
                            nprocs=nprocs)


def make_task(shard=0, num_shard=2, op="reduce-0", nparts=1, deps=()):
    name = TaskName(inv_index=1, op=op, shard=shard, num_shard=num_shard)
    return Task(name, None, list(deps), Partitioner(num_partition=nparts),
                Schema([np.int32]))


def int_frame(vals):
    return Frame([np.asarray(vals, np.int32)], Schema([np.int32]))


def _col(frame):
    return [int(x) for x in frame.cols[0]]


def test_publish_epoch_pointer_last_and_gc_of_previous_epoch():
    t = make_task(shard=0)
    frames = FakeFrames({(t.name, 0): [int_frame([1, 2, 3])]})
    ex = make_exchange(pid=0, frames=frames)
    base = _base_key(t.name)
    ex._publish_epoch(t, "ok")
    kv = ex.client.kv
    assert kv[f"{P}{base}/e"] == b"0"
    assert kv[f"{P}{base}/a0/state"] == b"ok"
    # The pointer strictly AFTER the epoch's data and state.
    sets = [k for op_, k in ex.client.log if op_ == "set"]
    assert sets[-1].endswith("/e")
    assert sets.index(f"{P}{base}/a0/state") < sets.index(f"{P}{base}/e")
    # A republish (the owner re-ran): a new epoch, the pointer flips, the
    # previous generation is deleted key by key.
    frames.frames[(t.name, 0)] = [int_frame([4, 5, 6])]
    ex._publish_epoch(t, "ok")
    assert kv[f"{P}{base}/e"] == b"1"
    assert not any(f"/{base}/a0/" in k for k in kv), kv.keys()
    assert kv[f"{P}{base}/a1/state"] == b"ok"


def test_fetch_reads_latest_epoch():
    t = make_task(shard=0)
    frames = FakeFrames({(t.name, 0): [int_frame([7, 8])]})
    ex = make_exchange(pid=0, frames=frames)
    ex._publish_epoch(t, "ok")
    frames.frames[(t.name, 0)] = [int_frame([9])]
    ex._publish_epoch(t, "ok")
    got = ex.fetch(t.name, 0, timeout=0.5)
    assert got is not None and _col(got[0]) == [9]
    assert ex.fetched == [(str(t.name), 0)]


def test_fetch_returns_none_for_unpublished_and_err():
    t = make_task(shard=0)
    ex = make_exchange(pid=0)
    assert ex.fetch(t.name, 0, timeout=0.05) is None
    ex._publish_epoch(t, "err:boom")
    assert ex.fetch(t.name, 0, timeout=0.05) is None


def test_fetch_waits_out_an_unreadable_state_and_says_why(monkeypatch):
    """A pointer whose state cannot be read (a store read that failed,
    or an epoch being replaced) is no published failure: the fetch reads
    again until its timeout and then records why, instead of giving up
    at once (each give-up loses the producer for every consumer that
    read it). A published error still ends the wait at once, by name."""
    monkeypatch.setattr(hd_mod, "POLL_SECS", 0.01)
    t = make_task(shard=0)
    frames = FakeFrames({(t.name, 0): [int_frame([4, 5])]})
    ex = make_exchange(pid=0, frames=frames)
    ex._publish_epoch(t, "ok")
    state_key = f"{P}{_base_key(t.name)}/a0/state"
    saved = ex.client.kv.pop(state_key)
    timer = threading.Timer(0.1, ex.client.set, (state_key, saved))
    timer.start()
    got = ex.fetch(t.name, 0, timeout=5.0)
    timer.join()
    assert got is not None and _col(got[0]) == [4, 5]
    del ex.client.kv[state_key]
    t0 = time.monotonic()
    assert ex.fetch(t.name, 0, timeout=0.2) is None
    assert time.monotonic() - t0 >= 0.2
    assert ex.miss_reason[(str(t.name), 0)] == "epoch 0: no state after 0.2s"
    ex._publish_epoch(t, "err:boom")
    assert ex.fetch(t.name, 0, timeout=5.0) is None
    assert ex.miss_reason[(str(t.name), 0)] == "epoch 1 err:boom"


def test_slow_owner_with_beating_keepalive_extends_deadline(monkeypatch):
    """The absolute deadline must not fire while the owner's beat
    advances; once it stops, the task is judged lost."""
    monkeypatch.setattr(hd_mod, "STATE_TIMEOUT_SECS", 0.1)
    monkeypatch.setattr(hd_mod, "POLL_SECS", 0.01)
    ka = FakeKeepalive(timeout=5.0)
    ka._age[1] = 0.5
    ex = make_exchange(pid=0, keepalive=ka)
    t = make_task(shard=1)  # owner 1
    t.set_state(TaskState.WAITING)
    assert ex.submit(t) is True
    time.sleep(0.5)
    assert t.state == TaskState.RUNNING
    ka._age[1] = 10.0
    deadline = time.monotonic() + 5.0
    while t.state == TaskState.RUNNING and time.monotonic() < deadline:
        time.sleep(0.01)
    assert t.state == TaskState.LOST


def test_owner_lost_by_keepalive_marks_lost(monkeypatch):
    monkeypatch.setattr(hd_mod, "POLL_SECS", 0.01)
    ka = FakeKeepalive()
    ex = make_exchange(pid=0, keepalive=ka)
    t = make_task(shard=1)
    t.set_state(TaskState.WAITING)
    assert ex.submit(t) is True
    ka._lost = [(1, 42.0)]
    deadline = time.monotonic() + 5.0
    while t.state == TaskState.RUNNING and time.monotonic() < deadline:
        time.sleep(0.01)
    assert t.state == TaskState.LOST


def test_remote_ok_resolves_via_epoch_pointer(monkeypatch):
    monkeypatch.setattr(hd_mod, "POLL_SECS", 0.01)
    ex = make_exchange(pid=0)
    t = make_task(shard=1)
    t.set_state(TaskState.WAITING)
    assert ex.submit(t) is True
    assert ex.remote_tasks == [str(t.name)]
    owner = make_exchange(pid=1, store=ex.client, frames=FakeFrames(
        {(t.name, 0): [int_frame([1])]}))
    owner._publish_epoch(make_task(shard=1), "ok")
    deadline = time.monotonic() + 5.0
    while t.state != TaskState.OK and time.monotonic() < deadline:
        time.sleep(0.01)
    assert t.state == TaskState.OK


def test_release_run_keeps_roots_deletes_intermediates():
    root = make_task(shard=0, op="reduce-0")
    inter = make_task(shard=0, op="map-0")
    frames = FakeFrames({(root.name, 0): [int_frame([1])],
                         (inter.name, 0): [int_frame([2])]})
    ex = make_exchange(pid=0, frames=frames, nprocs=2)
    ex._publish_epoch(root, "ok")
    ex._publish_epoch(inter, "ok")
    root.deps = (TaskDep(tasks=(inter,), partition=0),)
    # The peer reaches the barrier too (the store's counter).
    peer = make_exchange(pid=1, store=ex.client)
    th = threading.Thread(target=peer.release_run, args=([root],))
    th.start()
    ex.release_run([root])
    th.join()
    keys = list(ex.client.kv)
    assert any(_base_key(root.name) in k for k in keys)
    assert not any(_base_key(inter.name) in k for k in keys), keys
    # A barrier preceded the deletes (peers may still be fetching).
    log = ex.client.log
    first_add = next(i for i, (k, _) in enumerate(log) if k == "add")
    assert all(i > first_add for i, (k, key) in enumerate(log)
               if k == "del" and _base_key(inter.name) in key)
    # An ever-root task survives a later run that reads it, until close.
    outer = make_task(shard=0, op="fold-0")
    frames.frames[(outer.name, 0)] = [int_frame([3])]
    ex._publish_epoch(outer, "ok")
    outer.deps = (TaskDep(tasks=(root,), partition=0),)
    th = threading.Thread(target=peer.release_run, args=([outer],))
    th.start()
    ex.release_run([outer])
    th.join()
    assert any(_base_key(root.name) in k for k in ex.client.kv)
    ex.close()
    # Only the tombstone (a prefix of its own) and barrier counters stay.
    assert not [k for k in ex.client.kv if k.startswith(P)]
    assert "bigslice/hostdist_closed/0" in ex.client.kv


def test_distributable_excludes_machine_combined():
    ex = make_exchange()
    t = make_task()
    assert ex.distributable(t)
    t.partitioner.combine_key = "mc-1"
    assert not ex.distributable(t)


def test_abort_run_publishes_markers_and_floor_ignores_them():
    """A dead run's abort markers resolve waiters to ERR, but a fresh
    submission records them as its epoch floor and waits for the
    owner's re-publication."""
    t = make_task(shard=0, op="map-0")  # owner 0
    ex = make_exchange(pid=0)
    ex.executor._eligible = lambda task, count=True: False  # host tier
    t.set_state(TaskState.WAITING)
    ex.abort_run([t], RuntimeError("boom"))
    base = _base_key(t.name)
    assert ex.client.kv[f"{P}{base}/e"] == b"0"
    assert ex.client.kv[f"{P}{base}/a0/state"].startswith(
        b"err:run aborted")
    peer = make_exchange(pid=1, store=ex.client)
    t2 = make_task(shard=0, op="map-0")
    t2.set_state(TaskState.WAITING)
    assert peer.submit(t2) is True
    _, _, _, floor = peer._pending[base]
    assert floor == 0
    assert peer._resolve_state(base, floor) is None
    ex.executor = FakeExecutor(FakeFrames({(t.name, 0): [int_frame([5])]}))
    ex._publish_epoch(t, "ok")
    assert peer._resolve_state(base, floor) == "ok"


def test_chunks_split_at_chunk_bytes_and_reassemble(monkeypatch):
    """A partition larger than ``CHUNK_BYTES`` is written in chunks and
    reassembled by ``fetch`` into the same frames."""
    monkeypatch.setattr(hd_mod, "CHUNK_BYTES", 64)
    t = make_task(shard=0)
    vals = list(range(200))
    ex = make_exchange(pid=0, frames=FakeFrames(
        {(t.name, 0): [int_frame(vals[:120]), int_frame(vals[120:])]}))
    ex._publish_epoch(t, "ok")
    base = _base_key(t.name)
    assert int(ex.client.kv[f"{P}{base}/a0/p0/n"]) > 1
    got = ex.fetch(t.name, 0, timeout=0.5)
    assert [v for f in got for v in _col(f)] == vals


# -- 2 gloo ranks against the JAX package's one process ---------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("hostdist"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        launched = pool.submit(
            multihost_smoke.launch, 2,
            [sys.executable, os.path.join(os.path.dirname(__file__),
                                          "torch_spmd_scenarios.py"), out,
             "--hostdist"],
            deadline_s=150.0,
            env={"PYTHONPATH": repo, "OMP_NUM_THREADS": "1"})
        want = {}
        for name, f in scen.HOSTDIST.items():
            sess = RefSession()
            try:
                want[name] = bst.result_shard_rows(sess.run(f(ref_bs, 2)))
            finally:
                sess.shutdown()
        res = launched.result()
    assert res.rc == 0, "\n".join(res.stderr)
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            ranks.append(pickle.load(fh))
    return {"ranks": ranks, "want": want}


@pytest.mark.parametrize("name", sorted(scen.HOSTDIST))
def test_host_tier_rows_equal_the_jax_packages_one_process(world, name):
    want = world["want"][name]
    for r in world["ranks"]:
        got = r["rows"][name]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert [list(map(repr, c)) for c in g] == \
                [list(map(repr, c)) for c in w]


@pytest.mark.parametrize("name", sorted(scen.HOSTDIST))
def test_each_host_task_runs_on_exactly_one_rank(world, name):
    """Ownership partitions the host tasks: the two ranks own disjoint
    sets, each waits on exactly the other's, every task is
    ``shard % 2``'s, and a rank fetched only remote partitions."""
    r0, r1 = world["ranks"]
    o0, o1 = set(r0["owned"][name]), set(r1["owned"][name])
    assert o0 and o1 and not (o0 & o1)
    assert set(r0["remote"][name]) == o1
    assert set(r1["remote"][name]) == o0
    for rank, r in enumerate((r0, r1)):
        for task in r["owned"][name]:
            assert int(task.rsplit(":", 1)[1]) % 2 == rank
        assert {t for t, _ in r["fetched"][name]} <= set(r["remote"][name])
        assert r["fetched"][name]  # a result scan read remote shards
        assert r["modules"] == []


def test_a_previous_sessions_tombstone_fails_no_task_of_the_next():
    """Two sessions in a row on two ranks: rank 0 closes its first
    exchange (its tombstone) and rank 1 opens its second and waits on a
    task rank 0 owns before rank 0 has opened its second. The old
    tombstone is a previous session's (generation 1 against rank 1's
    2) and must not fail the task; rank 0's second exchange deletes it,
    and its own close is heeded."""
    store = FakeStore()
    old0 = make_exchange(pid=0, store=store)
    make_exchange(pid=1, store=store)
    old0.close()
    assert store.kv["bigslice/hostdist_closed/0"] == b"1"
    peer = make_exchange(pid=1, store=store)
    assert peer.gen == 2
    assert peer._owner_verdict(0) is None
    new0 = make_exchange(pid=0, store=store)
    assert new0.gen == 2 and "bigslice/hostdist_closed/0" not in store.kv
    new0.close()
    peer._closed_checked.clear()  # past the check's 2 s throttle
    assert "closed its session" in peer._owner_verdict(0)


def _wait_settled(task, timeout=10.0):
    deadline = time.monotonic() + timeout
    while task.state == TaskState.RUNNING:
        assert time.monotonic() < deadline, "task never settled"
        time.sleep(0.02)


def test_an_owner_at_a_later_exchange_fails_the_task_by_name():
    """The ranks built their exchanges in different orders (rank 0 one
    more, a retried session): rank 1's task owned by rank 0 ends in an
    error that names the generations, instead of waiting on a close of
    this session that never comes."""
    store = FakeStore()
    make_exchange(pid=0, store=store)
    peer = make_exchange(pid=1, store=store)
    make_exchange(pid=0, store=store)  # rank 0's second exchange
    t = make_task(shard=0)
    t.set_state(TaskState.WAITING)
    assert peer.submit(t)
    _wait_settled(t)
    assert t.state == TaskState.ERR
    msg = str(t.error)
    assert "exchange 2, process 1 at 1" in msg
    assert "different orders" in msg


def test_an_owner_left_at_an_earlier_exchange_fails_the_task_by_name(
        monkeypatch):
    """Rank 1 built one exchange more than rank 0: rank 0's tombstone of
    its earlier exchange is ignored while it may still open the next,
    but only for the state timeout, beat or not; then the task ends by
    name."""
    store = FakeStore()
    old0 = make_exchange(pid=0, store=store)
    make_exchange(pid=1, store=store)
    ka = FakeKeepalive()
    peer = make_exchange(pid=1, store=store, keepalive=ka)
    old0.close()
    ka._age[0] = 0.0  # the owner beats throughout
    assert peer._owner_verdict(0) is None
    monkeypatch.setattr(hd_mod, "STATE_TIMEOUT_SECS", 0.0)
    peer._closed_checked.clear()
    msg = peer._owner_verdict(0)
    assert "still at host-task exchange 1" in msg
    assert "process 1 at 2" in msg


class _DeletedInTheWindow:
    """A real c10d store whose ``check`` answers, then deletes the key:
    a peer's delete landing between a reader's ``check`` and its
    ``get``."""

    def __init__(self, store):
        self.store = store

    def check(self, keys):
        found = self.store.check(keys)
        for k in keys:
            self.store.delete_key(k)
        return found

    def __getattr__(self, name):
        return getattr(self.store, name)


def test_a_key_deleted_under_a_read_stalls_no_store_call():
    """ROADMAP C1.6: rank 0 opens its next exchange and deletes its
    tombstone while rank 1, a step ahead, reads it. The c10d store's
    ``get`` of a key that no longer exists waits for it, holding the
    process's store client, so every other store call of rank 1 waited
    too, its keepalive's beat among them: past the keepalive's timeout
    rank 0 judged rank 1 lost and marked rank 1's host task lost at
    every poll, five times, and the task went fatal. The read answers
    at once (no tombstone, so no verdict) and a beat published meanwhile
    is not held up."""
    import datetime

    import torch.distributed as dist

    wait = datetime.timedelta(seconds=4)
    server = dist.TCPStore("127.0.0.1", 0, 1, True, timeout=wait)
    client = dist.TCPStore("127.0.0.1", server.port, 1, False, timeout=wait)
    store = dist.PrefixStore("c16", client)
    first = [make_exchange(pid=r, store=store) for r in (0, 1)]
    for ex in first:
        ex.close()                              # rank 0's tombstone
    peer = make_exchange(pid=1, store=store)    # rank 1's next exchange
    assert peer.gen == 2
    assert store.check(["bigslice/hostdist_closed/0"])
    peer.client = _DeletedInTheWindow(store)
    beats, stop = [], threading.Event()

    def beat():
        while not stop.is_set():
            t0 = time.monotonic()
            store.set("bigslice/keepalive/1", str(len(beats)))
            beats.append(time.monotonic() - t0)
            time.sleep(0.02)

    beater = threading.Thread(target=beat)
    beater.start()
    try:
        time.sleep(0.1)
        t0 = time.monotonic()
        assert peer._owner_verdict(0) is None
        read_s = time.monotonic() - t0
        time.sleep(0.3)
    finally:
        stop.set()
        beater.join()
    assert read_s < 1.0, f"the read waited {read_s:.2f} s"
    assert max(beats) < 1.0, f"a beat waited {max(beats):.2f} s"
