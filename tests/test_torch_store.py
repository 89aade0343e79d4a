"""The port's FileStore (``bigslice_tpu_torch.exec.store``), mirroring
the JAX package's store tests: the round trip, streaming reads, the
empty partition, atomic writes, prefetch warming, the discard race and
quarantine, on local paths and (the ``*_on_a_url`` cases) on
``memory://`` prefixes through fsspec. The two packages' FileStores
share a layout and a codec, so each reads the other's partitions, row
for row, on either kind of prefix. ``memory://`` is one filesystem a
process: every case takes its own prefix.
"""

import itertools
import sys
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


def test_url_prefix_raises_by_name(monkeypatch):
    """Without fsspec a URL store raises by name (with it, the memory://
    cases below run)."""
    monkeypatch.setitem(sys.modules, "fsspec", None)
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


# -- memory:// prefixes (the JAX package's tests/test_store.py cases) -----

_URL_IDS = itertools.count()


@pytest.fixture
def url():
    """A fresh memory:// prefix, removed after the test."""
    import fsspec

    name = f"torch-store-{next(_URL_IDS)}"
    yield f"memory://{name}"
    fs = fsspec.filesystem("memory")
    if fs.exists(f"/{name}"):
        fs.rm(f"/{name}", recursive=True)


def test_filestore_roundtrip_on_a_url(url):
    store = FileStore(url)
    name = TaskName(1, "op", 0, 2)
    store.put(name, 0, [_frame([1, 2]), _frame([3])])
    assert store.committed(name, 0) and not store.committed(name, 1)
    assert [f.cols[0].tolist() for f in store.read(name, 0)] == [[1, 2], [3]]
    store.discard(name)
    assert not store.committed(name, 0)
    with pytest.raises(Missing):
        store.read(name, 0)


def test_filestore_read_streams_and_empty_partition_on_a_url(url):
    store = FileStore(url)
    name = TaskName(1, "big", 0, 1)
    store.put(name, 0, [_frame(list(range(100))) for _ in range(5)])
    r = store.read(name, 0)
    assert not isinstance(r, (list, tuple))
    assert len(next(iter(r))) == 100
    empty = TaskName(1, "empty", 0, 1)
    store.put(empty, 0, [])
    assert store.committed(empty, 0)
    assert list(store.read(empty, 0)) == []


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_partitions_on_a_url(url, writer):
    rng = np.random.RandomState(4)
    cols = [rng.randint(0, 1000, 300).astype(np.int32),
            rng.rand(300, 3).astype(np.float32)]
    if writer == "jax":
        RefFileStore(url).put(RefTaskName(2, "op@x.py:3", 1, 4), 5,
                              [RefFrame(cols, prefix=1)])
        got = list(FileStore(url).read(TaskName(2, "op@x.py:3", 1, 4),
                                       5))[0].cols
    else:
        FileStore(url).put(TaskName(2, "op@x.py:3", 1, 4), 5,
                           [Frame.from_numpy(cols)])
        got = list(RefFileStore(url).read(
            RefTaskName(2, "op@x.py:3", 1, 4), 5))[0].to_host().cols
    for g, w in zip(got, cols):
        assert np.asarray(g).tobytes() == w.tobytes()


def test_session_with_url_store_matches_the_jax_package(url):
    """Every task output of a local-executor session persisted to a
    memory:// store; the shards equal the JAX package's on its own."""
    import bigslice_tpu as ref_bs
    import bigslice_tpu_torch as bst
    from bigslice_tpu.exec.local import LocalExecutor as RefLocal
    from bigslice_tpu.exec.session import Session as RefSession

    keys = np.arange(40, dtype=np.int32) % 5
    ones = np.ones(40, np.int32)
    sess = bst.Session(executor=bst.LocalExecutor(
        device="cpu", store=FileStore(f"{url}/port")))
    got = bst.result_shard_rows(sess.run(bst.Reduce(bst.Const(4, keys, ones),
                                                    lambda a, b: a + b)))
    ref = RefSession(executor=RefLocal(store=RefFileStore(f"{url}/jax")))
    want = bst.result_shard_rows(ref.run(ref_bs.Reduce(
        ref_bs.Const(4, keys, ones), lambda a, b: a + b)))
    for g, w in zip(got, want):
        assert [c.tobytes() for c in g] == [c.tobytes() for c in w]
    assert dict(zip(*[np.concatenate(c) for c in zip(*got)])) == \
        {i: 8 for i in range(5)}


def test_atomic_write_cleanup_on_error_on_a_url(url):
    """A failing writer leaves neither the key nor its temp key."""
    import fsspec

    path = f"{url}/d/x"
    with pytest.raises(RuntimeError):
        with fileio.atomic_write(path) as fp:
            fp.write(b"partial")
            raise RuntimeError("boom")
    assert not fileio.exists(path)
    assert fsspec.filesystem("memory").find(url.split("://")[1]) == []
    with fileio.atomic_write(path) as fp:
        fp.write(b"whole")
    with fileio.open_read(path) as fp:
        assert fp.read() == b"whole"
    assert fileio.size(path) == 5 and fileio.mtime(path) > 0


def test_url_readers_do_not_share_a_position(url):
    """memory:// hands every opener one stored file: each reader gets
    its own position (concurrent readers of one key interleave)."""
    path = f"{url}/r"
    with fileio.atomic_write(path) as fp:
        fp.write(bytes(range(10)))
    a, b = fileio.open_read(path), fileio.open_read(path)
    assert a.read(3) == bytes([0, 1, 2])
    assert b.read(3) == bytes([0, 1, 2])
    assert a.read(2) == bytes([3, 4])


def test_filestore_prefetch_on_a_url(url):
    """Warming serves one read, a missing partition stays Missing, and a
    discard drops a warmed entry (the generation guard), on memory://."""
    store = FileStore(url)
    name = TaskName(1, "warm", 0, 1)
    store.put(name, 0, [_frame([4, 5, 6])])
    store.prefetch(name, 0)
    assert _wait(lambda: (name, 0) in store._warm)
    assert [f.cols[0].tolist() for f in store.read(name, 0)] == [[4, 5, 6]]
    assert (name, 0) not in store._warm
    assert [f.cols[0].tolist() for f in store.read(name, 0)] == [[4, 5, 6]]
    gone = TaskName(1, "nothere", 0, 1)
    store.prefetch(gone, 0)
    assert _wait(lambda: (gone, 0) not in store._warm_pending)
    with pytest.raises(Missing):
        store.read(gone, 0)
    store.prefetch(name, 0)
    assert _wait(lambda: (name, 0) in store._warm)
    store.discard(name)
    with pytest.raises(Missing):
        store.read(name, 0)


def test_corrupt_url_file_is_quarantined_and_missing(url):
    store = FileStore(url)
    name = TaskName(1, "bad", 0, 1)
    store.put(name, 0, [_frame(list(range(50)))])
    path = store._path(name, 0)
    with fileio.open_read(path) as fp:
        data = bytearray(fp.read())
    data[40] ^= 0xFF
    with fileio.atomic_write(path) as fp:
        fp.write(bytes(data))
    with pytest.raises(Missing, match="quarantined"):
        list(store.read(name, 0))
    assert store.quarantined == 1 and not store.committed(name, 0)
    assert fileio.exists(path + ".quarantine")
    store.put(name, 0, [_frame([7])])
    assert [f.cols[0].tolist() for f in store.read(name, 0)] == [[7]]


def test_aux_blobs_and_drop_on_a_url(url):
    store = FileStore(url)
    assert store.get_aux("a") is None
    store.put_aux("a", b"xyz")
    assert store.get_aux("a") == b"xyz"
    name = TaskName(1, "d", 0, 1)
    store.put(name, 0, [_frame([1])])
    store.put(name, 1, [_frame([2])])
    store.drop(name, 0)
    assert not store.committed(name, 0) and store.committed(name, 1)
