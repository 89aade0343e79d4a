"""The port's FileStore (``bigslice_tpu_torch.exec.store``), mirroring
the JAX package's store tests on local paths: the round trip, streaming
reads, the empty partition, atomic writes, prefetch warming, the
discard race and quarantine. The two packages' FileStores share a
layout and a codec, so each reads the other's partitions, row for row.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bigslice_tpu.exec.store import FileStore as RefFileStore  # noqa: E402
from bigslice_tpu.exec.task import TaskName as RefTaskName  # noqa: E402
from bigslice_tpu.frame.frame import Frame as RefFrame  # noqa: E402
from bigslice_tpu_torch.exec.store import FileStore  # noqa: E402
from bigslice_tpu_torch.exec.store import MemoryStore, Missing  # noqa: E402
from bigslice_tpu_torch.exec.task import TaskName  # noqa: E402
from bigslice_tpu_torch.frame.frame import Frame  # noqa: E402
from bigslice_tpu_torch.slicetype import Schema  # noqa: E402
from bigslice_tpu_torch.utils import fileio  # noqa: E402


def _frame(vals):
    return Frame([np.asarray(vals, np.int32)], Schema([np.int32], prefix=1))


def _wait(pred, secs=5.0):
    deadline = time.time() + secs
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def test_filestore_roundtrip(tmp_path):
    store = FileStore(str(tmp_path / "store"))
    name = TaskName(1, "op", 0, 2)
    store.put(name, 0, [_frame([1, 2]), _frame([3])])
    assert store.committed(name, 0)
    assert not store.committed(name, 1)
    frames = list(store.read(name, 0))
    assert [f.cols[0].tolist() for f in frames] == [[1, 2], [3]]
    store.discard(name)
    assert not store.committed(name, 0)
    with pytest.raises(Missing):
        store.read(name, 0)


def test_filestore_read_streams(tmp_path):
    store = FileStore(str(tmp_path / "store"))
    name = TaskName(1, "big", 0, 1)
    store.put(name, 0, [_frame(list(range(100))) for _ in range(5)])
    r = store.read(name, 0)
    assert not isinstance(r, (list, tuple))
    assert len(next(iter(r))) == 100


def test_filestore_empty_partition(tmp_path):
    store = FileStore(str(tmp_path / "store"))
    name = TaskName(1, "empty", 0, 1)
    store.put(name, 0, [])
    assert store.committed(name, 0)
    assert list(store.read(name, 0)) == []


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_partitions(tmp_path, writer):
    rng = np.random.RandomState(3)
    cols = [rng.randint(0, 1000, 257).astype(np.int32),
            rng.rand(257, 2).astype(np.float32)]
    prefix = str(tmp_path / "shared")
    if writer == "jax":
        RefFileStore(prefix).put(RefTaskName(2, "op@x.py:3", 1, 4), 5,
                                 [RefFrame(cols, prefix=1)])
        frames = list(FileStore(prefix).read(TaskName(2, "op@x.py:3", 1, 4),
                                             5))
        got = frames[0].cols
    else:
        FileStore(prefix).put(TaskName(2, "op@x.py:3", 1, 4), 5,
                              [Frame.from_numpy(cols)])
        frames = list(RefFileStore(prefix).read(
            RefTaskName(2, "op@x.py:3", 1, 4), 5))
        got = frames[0].to_host().cols
    for g, w in zip(got, cols):
        assert np.asarray(g).tobytes() == w.tobytes()


def test_atomic_write_cleanup_on_error(tmp_path):
    path = str(tmp_path / "d" / "x")
    with pytest.raises(RuntimeError):
        with fileio.atomic_write(path) as fp:
            fp.write(b"partial")
            raise RuntimeError("boom")
    assert not fileio.exists(path)
    assert list((tmp_path / "d").iterdir()) == []


def test_url_prefix_raises_by_name():
    with pytest.raises(fileio.URLNotPorted, match="fsspec"):
        FileStore("memory://bucket/run")


def test_retry_transient_retries_then_raises(monkeypatch):
    monkeypatch.setenv("BIGSLICE_IO_BACKOFF", "0")
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert fileio.retry_transient(flaky) == "ok" and len(calls) == 3
    with pytest.raises(FileNotFoundError):
        fileio.retry_transient(lambda: open("/nonexistent/x", "rb"))


def test_filestore_prefetch_warms_and_serves(tmp_path):
    store = FileStore(str(tmp_path / "store"))
    name = TaskName(1, "warm", 0, 1)
    store.put(name, 0, [_frame([4, 5, 6])])
    store.prefetch(name, 0)
    assert _wait(lambda: (name, 0) in store._warm)
    assert [f.cols[0].tolist() for f in store.read(name, 0)] == [[4, 5, 6]]
    assert (name, 0) not in store._warm  # one-shot: consumed by the read
    # The file stays authoritative for re-reads.
    assert [f.cols[0].tolist() for f in store.read(name, 0)] == [[4, 5, 6]]


def test_filestore_prefetch_missing_is_silent(tmp_path):
    store = FileStore(str(tmp_path / "store"))
    name = TaskName(1, "nothere", 0, 1)
    store.prefetch(name, 0)
    assert _wait(lambda: (name, 0) not in store._warm_pending)
    with pytest.raises(Missing):
        store.read(name, 0)


def test_filestore_prefetch_discard_drops_warm(tmp_path):
    store = FileStore(str(tmp_path / "store"))
    name = TaskName(1, "stale", 0, 1)
    store.put(name, 0, [_frame([1])])
    store.prefetch(name, 0)
    assert _wait(lambda: (name, 0) in store._warm)
    store.discard(name)
    with pytest.raises(Missing):
        store.read(name, 0)


def test_filestore_prefetch_race_with_discard_not_stale(tmp_path):
    """A prefetch in flight when discard() lands must not repopulate the
    warm cache with the frames it read before (the generation guard)."""
    store = FileStore(str(tmp_path / "store"))
    name = TaskName(1, "race", 0, 1)
    store.put(name, 0, [_frame([1])])
    gate, reading = threading.Event(), threading.Event()
    orig = store._read_direct

    def slow_read(n, p):
        frames = list(orig(n, p))
        reading.set()
        gate.wait(5)  # hold the read open across the discard
        return iter(frames)

    store._read_direct = slow_read
    store.prefetch(name, 0)
    assert reading.wait(5)
    store.discard(name)
    gate.set()
    assert _wait(lambda: (name, 0) not in store._warm_pending)
    assert (name, 0) not in store._warm
    store._read_direct = orig
    with pytest.raises(Missing):
        store.read(name, 0)


def test_filestore_prefetch_cache_is_bounded(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGSLICE_PREFETCH_CACHE", "2")
    store = FileStore(str(tmp_path / "store"))
    names = [TaskName(1, "b", s, 4) for s in range(4)]
    for n in names:
        store.put(n, 0, [_frame([n.shard])])
        store.prefetch(n, 0)
    assert _wait(lambda: not store._warm_pending)
    assert len(store._warm) <= 2
    for n in names:  # warm or not, every read is right
        assert [f.cols[0].tolist() for f in store.read(n, 0)] == [[n.shard]]


def test_corrupt_file_is_quarantined_and_missing(tmp_path):
    store = FileStore(str(tmp_path / "store"))
    name = TaskName(1, "bad", 0, 1)
    store.put(name, 0, [_frame(list(range(50)))])
    path = store._path(name, 0)
    with open(path, "r+b") as fp:
        fp.seek(40)
        b = fp.read(1)
        fp.seek(40)
        fp.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(Missing, match="quarantined"):
        list(store.read(name, 0))
    assert store.quarantined == 1
    assert not store.committed(name, 0)
    assert fileio.exists(path + ".quarantine")
    # A recompute's put replaces it.
    store.put(name, 0, [_frame([7])])
    assert [f.cols[0].tolist() for f in store.read(name, 0)] == [[7]]


@pytest.mark.parametrize("make", ["memory", "file"])
def test_aux_blobs_and_drop(tmp_path, make):
    store = MemoryStore() if make == "memory" else FileStore(
        str(tmp_path / "store"))
    assert store.get_aux("a") is None
    store.put_aux("a", b"xyz")
    assert store.get_aux("a") == b"xyz"
    name = TaskName(1, "d", 0, 1)
    store.put(name, 0, [_frame([1])])
    store.put(name, 1, [_frame([2])])
    store.drop(name, 0)
    assert not store.committed(name, 0) and store.committed(name, 1)
