"""The port's file-backed result cache against the JAX package's.

The cases of tests/test_aux.py, test_groupby.py, test_spill_shuffle.py
and test_serve.py on ``ops/cache.py`` have their counterparts here (the
serving case's counts only), on the port's ``MeshExecutor(device=
"cpu")`` and ``LocalExecutor(device="cpu")``. Files written by either
package read back in the other with equal rows, and a plain file is
byte-equal to the JAX package's for the same slice. A cached re-run
builds no producer task (the compile-time short-circuit) and launches
no kernel.
"""

import glob
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.exec.session import Session as RefSession  # noqa: E402
from bigslice_tpu.frame import codec as ref_codec  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch import slicetest  # noqa: E402
from bigslice_tpu_torch.frame import codec  # noqa: E402
from bigslice_tpu_torch.frame.frame import Frame  # noqa: E402
from bigslice_tpu_torch.ops import cache as cache_mod  # noqa: E402
from bigslice_tpu_torch.ops.cache import ShardCache, shard_path  # noqa: E402
from bigslice_tpu_torch.ops.reduce import Reduce  # noqa: E402
from bigslice_tpu_torch.parallel import cuda_kernels  # noqa: E402
from bigslice_tpu_torch.slicetype import ColType, Schema  # noqa: E402
from bigslice_tpu_torch.utils import fileio  # noqa: E402

KINDS = ["mesh", "local"]


def _session(kind):
    if kind == "mesh":
        return bst.Session(executor=bst.MeshExecutor(device="cpu"))
    return bst.Session(executor=bst.LocalExecutor(device="cpu"))


def _add(a, b):
    return a + b


def _keyed(rows=2000, nkeys=20, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, nkeys, rows).astype(np.int32),
            rng.randint(0, 50, rows).astype(np.int32))


@pytest.fixture
def rc_policy():
    cache_mod.reset_result_cache_policy()
    cache_mod.reset_result_cache_counts()
    yield cache_mod
    cache_mod.reset_result_cache_policy()
    cache_mod.reset_result_cache_counts()


def _all_tasks(roots):
    seen, stack = {}, list(roots)
    while stack:
        t = stack.pop()
        if id(t) in seen:
            continue
        seen[id(t)] = t
        for d in t.deps:
            stack.extend(d.tasks)
    return list(seen.values())


@pytest.mark.parametrize("kind", KINDS)
def test_empty_cached_shard_stays_cached(tmp_path, kind):
    """A shard whose reader yields nothing caches as a file of no frames
    (0 bytes, or an empty zstd frame), which counts as cached (empty),
    not as a format mismatch."""
    prefix = str(tmp_path / "c")
    runs = []

    def gen(shard):
        runs.append(shard)
        if shard == 0:
            yield ([1, 2],)

    sess = _session(kind)
    r1 = slicetest.sorted_rows(
        bst.Cache(bst.ReaderFunc(2, gen, out=[np.int32]), prefix),
        session=sess)
    n = len(runs)
    r2 = slicetest.sorted_rows(
        bst.Cache(bst.ReaderFunc(2, gen, out=[np.int32]), prefix),
        session=sess)
    assert r1 == r2 == [(1,), (2,)]
    assert len(runs) == n  # the second run was served from the cache
    assert ShardCache(prefix, 2).all_cached
    rows = slicetest.sorted_rows(bst.ReadCache([np.int32], 2, prefix),
                                 session=sess)
    assert rows == [(1,), (2,)]


def test_cache_reads_legacy_uncompressed_files(tmp_path):
    prefix = str(tmp_path / "legacy")
    schema = Schema([ColType(np.dtype(np.int32))], prefix=1)
    f = Frame([np.arange(10, dtype=np.int32)], schema)
    with open(shard_path(prefix, 0, 1), "wb") as fp:
        fp.write(codec.encode_frame(f))  # plain frames, no container
    cache = ShardCache(prefix, 1)
    assert cache.all_cached
    rows = [r for fr in cache.read(0) for r in fr.rows()]
    assert [r[0] for r in rows] == list(range(10))


def test_cache_files_are_zstd_compressed(tmp_path):
    """The writethrough compresses; reads sniff the container."""
    pytest.importorskip("zstandard")
    prefix = str(tmp_path / "zc")
    data = np.arange(4000, dtype=np.int32)
    rows = slicetest.scan_all(bst.Cache(bst.Const(2, data), prefix),
                              session=_session("local"))
    assert sorted(r[0] for r in rows) == list(range(4000))
    with open(shard_path(prefix, 0, 2), "rb") as fp:
        assert fp.read(4) == codec.ZMAGIC
    cache = ShardCache(prefix, 2)
    assert cache.all_cached
    got = [r for s in range(2) for f in cache.read(s) for r in f.rows()]
    assert sorted(r[0] for r in got) == list(range(4000))


def test_codec_container_matches_jax(tmp_path):
    """The container's magic is the JAX package's; without zstandard the
    writer declines (plain frames), and the sniffing reader replays the
    plain bytes whole, to any read size."""
    import io

    assert codec.ZMAGIC == ref_codec.ZMAGIC
    buf = io.BytesIO()
    zw = codec.open_compressed_write(buf)
    try:
        import zstandard  # noqa: F401
    except ImportError:
        assert zw is None and buf.getvalue() == b""
    else:
        zw.close()
        assert buf.getvalue()[:4] == codec.ZMAGIC
    f = Frame([np.arange(50, dtype=np.int32)])
    data = codec.encode_frame(f) * 2
    r = codec.maybe_decompressed(io.BytesIO(data))
    assert r.read(2) + r.read(3) + r.read(-1) == data
    frames = list(codec.read_stream(codec.maybe_decompressed(
        io.BytesIO(data))))
    assert [fr.rows() for fr in frames] == [f.rows(), f.rows()]


@pytest.mark.parametrize("kind", KINDS)
def test_stale_cache_format_is_miss(tmp_path, kind):
    prefix = str(tmp_path / "c")
    for s in range(2):
        with open(shard_path(prefix, s, 2), "wb") as fp:
            fp.write(b"BSF2" + b"\x00" * 16)  # an older format
    ran = []

    def gen(shard):
        ran.append(shard)
        yield ([shard],)

    rows = slicetest.sorted_rows(
        bst.Cache(bst.ReaderFunc(2, gen, out=[np.int32]), prefix),
        session=_session(kind))
    assert rows == [(0,), (1,)]
    assert ran  # stale files recomputed, not crashed on


@pytest.mark.parametrize("kind", KINDS)
def test_result_cache_ttl_expiry(tmp_path, rc_policy, kind):
    rc_policy.configure_result_cache(ttl_s=300.0, max_bytes=None)
    keys, vals = _keyed()
    sess = _session(kind)

    def run():
        s = bst.Cache(bst.Reduce(bst.Const(4, keys, vals), _add),
                      str(tmp_path / "p"))
        res = sess.run(s)
        rows = sorted(map(tuple, res.rows()))
        res.discard()
        return rows

    first = run()
    assert rc_policy.result_cache_counts()["miss"] == 4
    assert run() == first  # within the TTL: served from the cache
    assert rc_policy.result_cache_counts()["hit"] == 4
    rc_policy.configure_result_cache(ttl_s=0.05)
    time.sleep(0.1)
    assert run() == first  # expired: recomputed, the same rows
    counts = rc_policy.result_cache_counts()
    assert counts["expired"] == 4 and counts["miss"] == 8


@pytest.mark.parametrize("kind", KINDS)
def test_result_cache_lru_byte_bound(tmp_path, rc_policy, kind):
    rc_policy.configure_result_cache(ttl_s=None, max_bytes=1)
    keys, vals = _keyed()
    sess = _session(kind)
    s = bst.Cache(bst.Reduce(bst.Const(4, keys, vals), _add),
                  str(tmp_path / "q"))
    res = sess.run(s)
    rows = sorted(map(tuple, res.rows()))
    res.discard()
    counts = rc_policy.result_cache_counts()
    # Four shards written; all but the most recent evicted.
    assert counts["evicted"] == 3, counts
    assert len(glob.glob(str(tmp_path / "q-*"))) == 1
    policy = rc_policy.result_cache_policy()
    assert policy["max_bytes"] == 1 and policy["tracked_files"] == 1
    # A re-run recomputes the evicted shards and still answers right.
    s2 = bst.CachePartial(bst.Reduce(bst.Const(4, keys, vals), _add),
                          str(tmp_path / "q"))
    assert sorted(map(tuple, sess.run(s2).rows())) == rows


def test_policy_from_the_environment(tmp_path, rc_policy, monkeypatch):
    monkeypatch.setenv("BIGSLICE_RESULT_CACHE_TTL_S", "12.5")
    monkeypatch.setenv("BIGSLICE_RESULT_CACHE_MAX_BYTES", "4096")
    rc_policy.reset_result_cache_policy()
    p = rc_policy.result_cache_policy()
    assert p["ttl_s"] == 12.5 and p["max_bytes"] == 4096
    rc_policy.configure_result_cache(max_bytes=None)
    p = rc_policy.result_cache_policy()
    assert p["ttl_s"] == 12.5 and p["max_bytes"] is None


def test_result_cache_hit_accounting(tmp_path, rc_policy):
    """One miss a shard computed and written, one hit a shard read."""
    rng = np.random.RandomState(3)
    keys = rng.randint(0, 16, 1024).astype(np.int32)
    vals = np.ones(1024, np.int32)
    sess = _session("mesh")

    def run():
        res = sess.run(bst.Cache(bst.Reduce(bst.Const(2, keys, vals), _add),
                                 str(tmp_path / "rc")))
        return sorted(map(tuple, res.rows()))

    before = rc_policy.result_cache_counts()
    r1 = run()
    mid = rc_policy.result_cache_counts()
    assert mid["miss"] - before["miss"] == 2
    r2 = run()
    after = rc_policy.result_cache_counts()
    assert after["hit"] - mid["hit"] == 2 and after["miss"] == mid["miss"]
    assert r1 == r2


@pytest.mark.parametrize("zstd", ["installed", "missing"])
@pytest.mark.parametrize("kind", KINDS)
def test_cache_files_cross_packages(tmp_path, monkeypatch, kind, zstd):
    """A cache written by the JAX package reads back through the port's
    ReadCache and the other way round; the files are byte-equal: zstd
    at one level, or plain frames where zstandard is missing."""
    if zstd == "installed":
        pytest.importorskip("zstandard")
    else:
        import sys

        monkeypatch.setitem(sys.modules, "zstandard", None)
    keys, vals = _keyed(3000, 50, seed=11)
    fvals = np.random.RandomState(2).randn(3000).astype(np.float32)
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "port")
    ref_rows = RefSession().run(ref_bs.Cache(
        ref_bs.Reduce(ref_bs.Const(3, keys, vals, fvals), _add), jp)).rows()
    rows = _session(kind).run(bst.Cache(
        bst.Reduce(bst.Const(3, keys, vals, fvals), _add), tp)).rows()
    assert sorted(rows) == sorted(ref_rows)
    schema = [np.int32, np.int32, np.float32]
    got = _session(kind).run(bst.ReadCache(schema, 3, jp)).rows()
    assert sorted(got) == sorted(ref_rows)
    back = RefSession().run(ref_bs.ReadCache(schema, 3, tp)).rows()
    assert sorted(back) == sorted(ref_rows)
    for s in range(3):
        with open(shard_path(jp, s, 3), "rb") as a, \
                open(shard_path(tp, s, 3), "rb") as b:
            head = a.read()
            assert head == b.read()
            assert head[:4] == (codec.ZMAGIC if zstd == "installed"
                                else codec.MAGIC4)


def test_cached_rerun_runs_no_producer_and_no_kernel(tmp_path):
    """A Cache over a device Reduce on the device executor writes every
    shard; a second session's run over the same prefix compiles to the
    cache's tasks alone (no Reduce, no Const), runs no group on the
    device path and launches no kernel."""
    keys, vals = _keyed(5000, 300, seed=5)
    prefix = str(tmp_path / "dev")

    def build():
        return bst.Cache(bst.Reduce(bst.Const(4, keys, vals), _add), prefix)

    ex1 = bst.MeshExecutor(device="cpu", auto_dense=False)
    res1 = bst.Session(executor=ex1).run(build())
    rows1 = sorted(res1.rows())
    assert len(ex1._outputs) == 1  # the map side ran on the device path
    assert all(os.path.getsize(shard_path(prefix, s, 4)) > 0
               for s in range(4))
    cuda_kernels.reset_launches()
    s2 = build()
    assert s2.deps() == ()
    ex2 = bst.MeshExecutor(device="cpu", auto_dense=False)
    res2 = bst.Session(executor=ex2).run(s2)
    assert sorted(res2.rows()) == rows1
    tasks = _all_tasks(res2.tasks)
    assert len(tasks) == 4
    assert not any(isinstance(s, (Reduce, bst.Const))
                   for t in tasks for s in t.chain)
    assert not ex2._outputs
    assert all(v == 0 for v in cuda_kernels.LAUNCHES.values())
    want = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        want[k] = want.get(k, 0) + v
    assert dict(rows1) == want


@pytest.mark.parametrize("kind", KINDS)
def test_cache_partial_rewrites_a_deleted_shard(tmp_path, kind):
    keys, vals = _keyed(4000, 100, seed=9)
    prefix = str(tmp_path / "part")

    def build():
        return bst.CachePartial(bst.Reduce(bst.Const(4, keys, vals), _add),
                                prefix)

    rows = sorted(_session(kind).run(build()).rows())
    with open(shard_path(prefix, 2, 4), "rb") as fh:
        before = fh.read()
    os.unlink(shard_path(prefix, 2, 4))
    s = build()
    assert s.cache.present == [True, True, False, True]
    assert sorted(_session(kind).run(s).rows()) == rows
    with open(shard_path(prefix, 2, 4), "rb") as fh:
        assert fh.read() == before
    assert ShardCache(prefix, 4).all_cached


def test_cache_recomputes_a_shard_that_vanished_after_the_scan(tmp_path):
    """CachePartial: a file evicted between the presence scan and the
    read is recomputed and written through instead of failing."""
    keys, vals = _keyed(1000, 30, seed=4)
    prefix = str(tmp_path / "gone")

    def build():
        return bst.CachePartial(bst.Reduce(bst.Const(2, keys, vals), _add),
                                prefix)

    sess = _session("local")
    rows = sorted(sess.run(build()).rows())
    s = build()
    assert s.cache.all_cached
    os.unlink(shard_path(prefix, 0, 2))
    assert sorted(sess.run(s).rows()) == rows
    assert os.path.exists(shard_path(prefix, 0, 2))


def test_read_cache_needs_every_shard(tmp_path):
    from bigslice_tpu_torch.typecheck import TypecheckError

    with pytest.raises(TypecheckError, match="missing cached shards"):
        bst.ReadCache([np.int32], 2, str(tmp_path / "none"))


def test_url_prefix_raises_by_name(monkeypatch):
    """Without fsspec a URL prefix raises by name (with it, the memory://
    cases below run)."""
    import sys

    monkeypatch.setitem(sys.modules, "fsspec", None)
    with pytest.raises(fileio.URLNotPorted):
        bst.Cache(bst.Const(1, np.arange(4, dtype=np.int32)),
                  "memory://bucket/c")


def test_fileio_size_and_mtime(tmp_path, monkeypatch):
    p = str(tmp_path / "f")
    assert fileio.size(p) is None and fileio.mtime(p) is None
    with open(p, "wb") as fh:
        fh.write(b"x" * 37)
    assert fileio.size(p) == 37
    assert abs(fileio.mtime(p) - os.stat(p).st_mtime) < 1e-6
    u = f"memory://torch-cache-size-{os.getpid()}/f"
    assert fileio.size(u) is None and fileio.mtime(u) is None
    with fileio.atomic_write(u) as fh:
        fh.write(b"y" * 11)
    assert fileio.size(u) == 11
    assert abs(fileio.mtime(u) - time.time()) < 60
    fileio.remove(u)
    assert not fileio.exists(u)
    import sys

    monkeypatch.setitem(sys.modules, "fsspec", None)
    with pytest.raises(fileio.URLNotPorted):
        fileio.size("s3://bucket/key")


# -- memory:// prefixes (the JAX package's tests/test_store.py cases) -----


def _url(tag):
    return f"memory://torch-cache-{tag}-{os.getpid()}-{time.monotonic_ns()}"


@pytest.mark.parametrize("kind", KINDS)
def test_cache_on_url_prefix(kind):
    """Cache, its writethrough and the read back over memory://; a
    second session serves every shard from the files and recomputes
    nothing, and the JAX package reads the port's files (and the other
    way round) with equal rows."""
    base = _url(kind)
    calls = []

    def gen(shard):
        calls.append(shard)
        yield ([shard] * 3, [1] * 3)

    def build(prefix):
        return bst.Cache(bst.ReaderFunc(3, gen, out=[np.int32, np.int32]),
                         prefix)

    r1 = sorted(_session(kind).run(build(f"{base}/wc")).rows())
    assert len(calls) == 3
    r2 = sorted(_session(kind).run(build(f"{base}/wc")).rows())
    assert r1 == r2 == [(s, 1) for s in range(3) for _ in range(3)]
    assert len(calls) == 3  # served from the cache
    schema = [np.int32, np.int32]
    back = RefSession().run(ref_bs.ReadCache(schema, 3, f"{base}/wc"))
    assert sorted(back.rows()) == r1
    RefSession().run(ref_bs.Cache(ref_bs.ReaderFunc(
        3, gen, out=[np.int32, np.int32]), f"{base}/jax"))
    got = _session(kind).run(bst.ReadCache(schema, 3, f"{base}/jax"))
    assert sorted(got.rows()) == r1


@pytest.mark.parametrize("kind", KINDS)
def test_readcache_and_partial_on_url_prefix(kind):
    base = _url(f"r{kind}")
    src = np.arange(8, dtype=np.int32)
    _session(kind).run(bst.Cache(bst.Const(2, src), f"{base}/rc"))
    rc = bst.ReadCache([np.int32], 2, f"{base}/rc")
    assert sorted(_session(kind).run(rc).rows()) == [(i,) for i in range(8)]
    fileio.remove(shard_path(f"{base}/rc", 0, 2))
    partial = bst.CachePartial(bst.Const(2, src), f"{base}/rc")
    assert partial.cache.present == [False, True]
    assert sorted(_session(kind).run(partial).rows()) == \
        [(i,) for i in range(8)]
    assert fileio.exists(shard_path(f"{base}/rc", 0, 2))


def test_cached_device_reduce_on_url_prefix_runs_no_kernel():
    """A Cache over a device Reduce on memory://: the re-run compiles no
    producer task and launches nothing; the rows equal the JAX
    package's."""
    keys, vals = _keyed(5000, 300, seed=5)
    prefix = f"{_url('dev')}/sums"

    def build():
        return bst.Cache(bst.Reduce(bst.Const(4, keys, vals), _add), prefix)

    rows = sorted(bst.Session(executor=bst.MeshExecutor(
        device="cpu", auto_dense=False)).run(build()).rows())
    cuda_kernels.reset_launches()
    s2 = build()
    assert s2.deps() == ()
    ex2 = bst.MeshExecutor(device="cpu", auto_dense=False)
    assert sorted(bst.Session(executor=ex2).run(s2).rows()) == rows
    assert not ex2._outputs
    assert all(v == 0 for v in cuda_kernels.LAUNCHES.values())
    ref = RefSession().run(ref_bs.Reduce(ref_bs.Const(4, keys, vals), _add))
    assert sorted(ref.rows()) == rows


def test_result_cache_ttl_expiry_on_url_prefix(rc_policy):
    """An object store's creation time is its last modification: a file
    past the TTL expires on memory:// as on a local path."""
    rc_policy.configure_result_cache(ttl_s=300.0, max_bytes=None)
    keys, vals = _keyed()
    prefix = f"{_url('ttl')}/p"
    sess = _session("local")

    def run():
        res = sess.run(bst.Cache(bst.Reduce(bst.Const(4, keys, vals), _add),
                                 prefix))
        rows = sorted(map(tuple, res.rows()))
        res.discard()
        return rows

    first = run()
    assert run() == first
    assert rc_policy.result_cache_counts()["hit"] == 4
    rc_policy.configure_result_cache(ttl_s=0.05)
    time.sleep(0.1)
    assert run() == first
    assert rc_policy.result_cache_counts()["expired"] == 4
