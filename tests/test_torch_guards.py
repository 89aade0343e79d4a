"""Guards on the port's boundaries: the package runs without JAX or the
JAX package, and its entry points never drop to the CPU on their own."""

import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu_torch as bst  # noqa: E402


def test_slice_runs_without_jax_or_the_jax_package():
    """Every ported path runs in a process with neither JAX nor the JAX
    package in ``sys.modules``, nor in a spawned parse worker."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import bigslice_tpu_torch as bs

        keys = np.arange(1000, dtype=np.int32) % 37
        sess = bs.Session(executor=bs.MeshExecutor(device="cpu"))
        res = sess.run(bs.Reduce(bs.Const(4, keys, np.ones(1000, np.int32)),
                                 lambda a, b: a + b))
        assert len(res.rows()) == 37
        # The sort lowering with map stages: the lww-wave chain.
        import torch
        rng = np.random.RandomState(42)
        k = rng.randint(0, 1 << 24, 4096).astype(np.int32)
        t = rng.permutation(4096).astype(np.int32)
        s = bs.Map(bs.Const(4, k, t, t), lambda k, t, v: (k & 0xFFFFF, t, v))
        s = bs.Filter(s, lambda k, t, v: t >= 512)
        res = sess.run(bs.Reduce(s, lambda a, b: (
            torch.maximum(a[0], b[0]), torch.where(a[0] >= b[0], a[1], b[1]))))
        assert len(res.rows()) == len(np.unique((k & 0xFFFFF)[t >= 512]))
        # A hash join, a join on the sort path and a GroupByKey with a Map
        # over its vector column.
        ak, bk = k % 300, t % 200
        for fb in (lambda a, b: a + b, lambda a, b: a ^ b):
            res = sess.run(bs.JoinAggregate(bs.Const(4, ak, t),
                                            bs.Const(4, bk, t),
                                            lambda a, b: a + b, fb))
            assert len(res.rows()) == len(np.intersect1d(ak, bk))
        g = bs.GroupByKey(bs.Const(4, bk, t), capacity=8)
        res = sess.run(bs.Map(g, lambda k, grp, c: (k, grp.sum(), c)))
        assert sorted(c for _, _, c in res.rows()) == sorted(
            np.bincount(bk).tolist())
        # The wave pipeline's modules, a pipelined, budget-split run and
        # a spilled run through the FileStore and the BSF4 codec.
        import os
        from bigslice_tpu_torch.exec import shuffleplan, staging, store
        from bigslice_tpu_torch.frame import codec
        from bigslice_tpu_torch.utils import fileio
        ex = bs.MeshExecutor(device="cpu", prefetch_depth=2,
                             device_budget_bytes=4096)
        res = bs.Session(executor=ex).run(bs.Reduce(
            bs.Const(8, keys, np.ones(1000, np.int32)), lambda a, b: a + b))
        assert len(res.rows()) == 37 and ex.split_runs
        os.environ["BIGSLICE_SHUFFLE"] = "spill"
        sp = bs.Session(executor=bs.MeshExecutor(device="cpu"))
        res = sp.run(bs.Reduce(bs.Const(8, keys, np.ones(1000, np.int32)),
                               lambda a, b: a + b))
        assert len(res.rows()) == 37 and sp.executor._spill is not None
        sp.shutdown()
        del os.environ["BIGSLICE_SHUFFLE"]
        # The general Cogroup: the tagged-sort alignment, the scatter at
        # the largest group's width and the decode into object lists.
        hot = np.concatenate([np.zeros(40, np.int32), bk[:200]])
        res = sess.run(bs.Cogroup(bs.Const(4, ak, t), bs.Const(2, hot, hot)))
        rows = res.rows()
        assert len(rows) == len(np.union1d(ak, hot))
        assert sum(len(a) for _, a, _ in rows) == len(ak)
        assert sess.executor.cogroup_caps
        # The local executor and the host tier: word count end to end
        # (ScanReader, host Flatmap and Map, a Reduce over str keys),
        # and the device-key Reduce.
        import tempfile
        from bigslice_tpu_torch.models.wordcount import wordcount
        path = os.path.join(tempfile.mkdtemp(), "corpus.txt")
        with open(path, "w") as fh:
            fh.write("the quick brown fox\\njumps over the lazy dog\\nthe fox\\n")
        local = bs.Session(executor=bs.LocalExecutor(device="cpu"))
        counts = dict(local.run(wordcount(3, path)).rows())
        assert counts["the"] == 3 and counts["fox"] == 2 and len(counts) == 8
        res = local.run(bs.Reduce(bs.Const(4, keys, np.ones(1000, np.int32)),
                                  lambda a, b: a + b))
        assert len(res.rows()) == 37
        # The rest of the user API: a device Fold on both executors, a
        # Reshard, a registered Func and a Scan.
        from bigslice_tpu_torch.models.maxint import int_max_func
        for ex in (sess, local):
            res = ex.run(bs.Fold(bs.Const(4, keys, t[:1000]),
                                 lambda acc, v: acc * 31 + v, init=7))
            assert len(res.rows()) == 37
        res = sess.run(bs.Reduce(bs.Reshard(bs.Const(4, keys, t[:1000]), 8),
                                 lambda a, b: a + b))
        assert res.num_shards == 8 and len(res.rows()) == 37
        res = sess.run(int_max_func, 4, keys, t[:1000])
        assert len(res.rows()) == 37
        seen = []
        local.run(bs.Scan(bs.Const(4, keys), lambda shard, r: seen.append(
            sum(len(f) for f in r))))
        assert sum(seen) == 1000
        # Dictionary-encoded string keys: an encoded Reduce, the urls
        # model's encoded count with the parse pool at two processes,
        # a Cache written and read back, and a TarSlice.
        import io, tarfile
        from bigslice_tpu_torch.frame import dictenc, strparse
        from bigslice_tpu_torch.models.urls import domain_count_encoded
        words = np.array(["a", "b", "a", "c"] * 50, dtype=object)
        vocab = dictenc.GlobalVocab(["a", "b", "c"])
        rows = dictenc.dict_encoded_reduce(sess, bs.Const(
            4, words, np.ones(200, np.int32)), lambda a, b: a + b, vocab)
        assert sorted(rows) == [("a", 100), ("b", 50), ("c", 50)]
        os.environ["BIGSLICE_PARSE_PROCS"] = "2"
        urls = [f"http://s{i % 9}.com/p{i}" for i in range(1 << 16)]
        rows = domain_count_encoded(sess, 2, urls)
        assert dict(rows)["s0.com"] == len(range(0, 1 << 16, 9))
        pool = strparse._pool()
        worker_mods = pool.apply(eval, ("sorted(__import__('sys').modules)",))
        assert "bigslice_tpu_torch.frame.strparse" in worker_mods
        strparse.shutdown_pool()
        prefix = os.path.join(tempfile.mkdtemp(), "c")
        red = bs.Reduce(bs.Const(4, keys, np.ones(1000, np.int32)),
                        lambda a, b: a + b)
        rows = sorted(sess.run(bs.Cache(red, prefix)).rows())
        assert rows == sorted(sess.run(bs.ReadCache(
            [np.int32, np.int32], 4, prefix)).rows()) and len(rows) == 37
        tpath = os.path.join(tempfile.mkdtemp(), "a.tar")
        with tarfile.open(tpath, "w") as tf:
            info = tarfile.TarInfo("x")
            info.size = 2
            tf.addfile(info, io.BytesIO(b"xy"))
        assert sess.run(bs.TarSlice(2, tpath)).rows() == [("x", b"xy")]

        def leaked(mods):
            return sorted(m for m in mods
                          if m == "jax" or m.startswith("jax.")
                          or m == "bigslice_tpu"
                          or m.startswith("bigslice_tpu."))

        bad = leaked(sys.modules) + leaked(worker_mods)
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_dense_reduce_and_fallback_wordcount_run_without_jax():
    """A dense Reduce (declared and discovered), a dense join and Fold,
    the standalone classes and word count through the device executor's
    host tier import neither JAX nor the JAX package."""
    code = textwrap.dedent("""
        import os, sys, tempfile
        import numpy as np
        import torch
        import bigslice_tpu_torch as bs
        from bigslice_tpu_torch.models.wordcount import wordcount
        from bigslice_tpu_torch.parallel import dense, hashagg, join, shuffle

        keys = np.arange(1000, dtype=np.int32) % 37
        ones = np.ones(1000, np.int32)
        sess = bs.Session(executor=bs.MeshExecutor(device="cpu"))
        r = bs.Reduce(bs.Const(1, keys, ones), lambda a, b: a + b,
                      dense_keys=37)
        assert r.frame_combiner.dense_keys == 37
        assert len(sess.run(r).rows()) == 37
        r = bs.Reduce(bs.Const(4, keys, ones), lambda a, b: a + b)
        assert len(sess.run(r).rows()) == 37
        assert r.frame_combiner.dense_keys == 37
        j = bs.JoinAggregate(bs.Const(1, keys, ones), bs.Const(1, keys, ones),
                             lambda a, b: a + b, lambda a, b: a + b,
                             dense_keys=37)
        assert len(sess.run(j).rows()) == 37
        f = bs.Fold(bs.Const(4, keys, ones), lambda acc, v: torch.maximum(
            acc, v), init=0, dense_keys=37)
        assert f.dense_op == "max" and len(sess.run(f).rows()) == 37
        assert dense.routing_tables(37, 4, 0)[1] >= 1
        k = torch.from_numpy(keys)
        c = torch.tensor([1000], dtype=torch.int32)
        v = torch.from_numpy(ones)
        assert int(hashagg.MeshHashReduceByKey(1, 1, 1000, ["add"],
                                               device="cpu")([k], [v], c)[2]) == 37
        assert int(join.MeshJoinAggregate(1000, lambda a, b: a + b,
                                          lambda a, b: a + b, device="cpu")(
            [k, v], c, [k, v], c)[3]) == 37
        assert int(shuffle.MeshShuffle(2, 1, 1000, device="cpu")([k, v], c)[1]) == 1000
        path = os.path.join(tempfile.mkdtemp(), "corpus.txt")
        with open(path, "w") as fh:
            fh.write("the quick brown fox\\njumps over the lazy dog\\nthe fox\\n")
        counts = dict(sess.run(wordcount(3, path)).rows())
        assert counts["the"] == 3 and counts["fox"] == 2 and len(counts) == 8
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "bigslice_tpu" or m.startswith("bigslice_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_observability_plane_runs_without_jax():
    """Every module of the observability plane, driven through a session
    with the hub, a trace, an eventer, a counter, the status printer and
    a profiler window, imports neither JAX nor the JAX package."""
    code = textwrap.dedent("""
        import json, os, sys, tempfile
        import numpy as np
        import bigslice_tpu_torch as bs
        from bigslice_tpu_torch.utils import (devicetelemetry, metrics,
                                              resources, stats, status,
                                              telemetry, topn, trace, xprof)

        d = tempfile.mkdtemp()
        events = []
        sess = bs.Session(executor=bs.MeshExecutor(device="cpu"),
                          trace_path=os.path.join(d, "t.json"),
                          eventer=lambda n, **f: events.append(n),
                          status=True)
        keys = np.arange(1000, dtype=np.int32) % 37
        res = sess.run(bs.Reduce(bs.Const(4, keys, np.ones(1000, np.int32)),
                                 lambda a, b: a + b), corr="c1")
        assert len(res.rows()) == 37 and res.corr == "c1"
        c = metrics.new_counter("rows")
        def f(x):
            c.incr()
            return x
        r = sess.run(bs.Map(bs.Const(2, keys), f, out=[np.int32]))
        assert c.value(r.scope) == 1000
        s = sess.telemetry_summary()
        json.dumps(s)
        assert any("skew" in e for e in s["ops"].values())
        assert sess.telemetry.prometheus_text()
        assert sess.executor.resource_stats()["host_rss_bytes"]
        out = sess.profiler.window(0.05, out_dir=os.path.join(d, "w"))
        assert out["files"]
        sess.shutdown()
        assert json.load(open(os.path.join(d, "t.json")))["traceEvents"]
        assert "bigslice:sessionStart" in events
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "bigslice_tpu" or m.startswith("bigslice_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_data_plane_and_kmeans_run_without_jax():
    """Parquet -> Reduce -> write_parquet, a memory:// store and spill,
    to_arrow and k-means run with neither JAX nor the JAX package in
    ``sys.modules``; importing the package alone (or its models) loads
    none of pyarrow, fsspec and pandas."""
    code = textwrap.dedent("""
        import os, sys, tempfile
        import numpy as np
        import bigslice_tpu_torch as bs
        import bigslice_tpu_torch.models
        from bigslice_tpu_torch.frame import arrow
        from bigslice_tpu_torch.utils import fileio
        lazy = [m for m in ("pyarrow", "fsspec", "pandas")
                if m in sys.modules]
        assert not lazy, lazy
        import pyarrow as pa, pyarrow.parquet as pq
        d = tempfile.mkdtemp()
        rng = np.random.default_rng(1)
        k, v = rng.integers(0, 50, 4000), rng.integers(0, 9, 4000)
        pq.write_table(pa.table({"k": k, "v": v}), os.path.join(d, "a.parquet"),
                       row_group_size=500)
        sess = bs.Session(executor=bs.MeshExecutor(device="cpu"))
        res = sess.run(bs.Reduce(bs.ParquetReader(
            4, os.path.join(d, "*.parquet"), out=[np.int32, np.int32]),
            lambda a, b: a + b))
        assert dict(res.rows()) == {
            int(i): int(v[k == i].sum()) for i in np.unique(k)}
        res.write_parquet("memory://guard/out")
        assert arrow.parquet_row_group_count(
            "memory://guard/out-0000-of-0004.parquet") == 1
        assert res.to_arrow().num_rows == 50
        os.environ["BIGSLICE_SHUFFLE"] = "spill"
        os.environ["BIGSLICE_SPILL_DIR"] = "memory://guard/spill"
        r2 = bs.Session(executor=bs.MeshExecutor(device="cpu")).run(
            bs.Reduce(bs.Const(4, k.astype(np.int32), v.astype(np.int32)),
                      lambda a, b: a + b))
        assert sorted(r2.rows()) == sorted(res.rows())
        del os.environ["BIGSLICE_SHUFFLE"]
        from bigslice_tpu_torch.models import kmeans
        pts = np.concatenate([rng.normal(10 * i, 1, (40, 3))
                              for i in range(3)]).astype(np.float32)
        c = kmeans.kmeans(sess, pts, k=3, iters=3, num_shards=2)
        assert np.allclose(c, kmeans.kmeans_oracle(pts, 3, 3), atol=1e-4)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "bigslice_tpu" or m.startswith("bigslice_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bst.MeshExecutor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bst.Session()


def test_local_executor_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bst.LocalExecutor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bst.Session(parallelism=2)


def test_mesh_executor_refuses_a_str_key_reduce():
    """Host keys typecheck for a Reduce; the device executor runs it on
    its host tier (the inner local executor), with the local executor's
    rows."""
    import numpy as np

    words = np.array(["a", "b", "a", "c"] * 8, dtype=object)

    def build():
        return bst.Reduce(bst.Const(2, words, np.ones(32, np.int32)),
                          lambda a, b: a + b)

    ex = bst.MeshExecutor(device="cpu")
    rows = bst.Session(executor=ex).run(build()).rows()
    assert sorted(rows) == [("a", 16), ("b", 8), ("c", 8)]
    local = bst.Session(executor=bst.LocalExecutor(device="cpu"))
    assert sorted(rows) == sorted(local.run(build()).rows())
    assert not ex._outputs  # no group ran on the device path


def test_cuda_executor_raises_without_the_kernels(monkeypatch):
    """A card with no buildable kernels (no nvcc, or a probe that
    returns wrong values) fails at construction, not mid-run."""
    from bigslice_tpu_torch.parallel import cuda_kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cuda_kernels, "kernels_available", lambda: False)
    with pytest.raises(RuntimeError, match="kernels are not available"):
        bst.MeshExecutor()
    with pytest.raises(RuntimeError, match="kernels are not available"):
        bst.Session()
    with pytest.raises(RuntimeError, match="kernels are not available"):
        bst.LocalExecutor()


def test_kernel_wrappers_take_plain_versions_only_on_cpu():
    """On CPU tensors the wrappers run their plain versions and count
    no launch; the probe reports no kernels without a GPU."""
    from bigslice_tpu_torch.parallel import cuda_kernels

    cuda_kernels.reset_launches()
    keys = torch.arange(100, dtype=torch.int32)
    cuda_kernels.hash_partition([keys], 7)
    cuda_kernels.hash_aggregate(
        torch.ones(100, dtype=torch.bool), [keys], [keys], ["add"],
        torch.zeros(100, dtype=torch.int32), 1, 128)
    assert all(v == 0 for v in cuda_kernels.LAUNCHES.values())
    if not torch.cuda.is_available():
        assert cuda_kernels.kernels_available() is False


def test_pad_cols_and_bucket_size():
    from bigslice_tpu_torch.parallel.jitutil import bucket_size, pad_cols

    assert [bucket_size(n) for n in (0, 8, 9, 1000)] == [8, 8, 16, 1024]
    a = torch.tensor([1, 2, 3], dtype=torch.int32)
    (p,) = pad_cols([a], 3, 5)
    assert p.tolist() == [1, 2, 3, 3, 3]
    (z,) = pad_cols([a[:0]], 0, 2)
    assert z.tolist() == [0, 0]


# -- what the Cogroup path sends to the host tier --------------------------


def _cogroup_fallback(build, **session_kw):
    """``build()`` on the device executor and on the local executor, both
    on the CPU: equal rows (each list's members sorted: their order is
    the tier's), and no group on the device path."""
    def norm(rows):
        return sorted(tuple(sorted(x) if isinstance(x, list) else x
                            for x in r) for r in rows)

    ex = bst.MeshExecutor(device="cpu")
    got = bst.Session(executor=ex, **session_kw).run(build()).rows()
    want = bst.Session(executor=bst.LocalExecutor(device="cpu"),
                       **session_kw).run(build()).rows()
    assert norm(got) == norm(want) and got
    return ex, norm(got)


def _keyed_const(n=32):
    import numpy as np

    k = np.arange(n, dtype=np.int32) % 7
    return bst.Const(2, k, k)


def test_cogroup_over_object_keys_is_refused():
    """Host keys typecheck (they hash and compare on the host tier): the
    producers and the Cogroup run on the device executor's host tier."""
    import numpy as np

    def build():
        host = bst.Const(2, np.array(list("abcdabcd"), dtype=object),
                         np.ones(8, np.int32))
        return bst.Cogroup(host)

    ex, rows = _cogroup_fallback(build)
    assert rows == [(c, [1, 1]) for c in "abcd"]
    assert not ex._outputs


def test_map_fused_after_a_cogroup_is_refused():
    """A Map fused after a Cogroup reads object lists: the group runs on
    the host tier, its producers on the device path."""
    ex, rows = _cogroup_fallback(lambda: bst.Map(
        bst.Cogroup(_keyed_const()), lambda k, v: (k, len(v)),
        out=[int, int]))
    assert rows == [(k, 5 if k < 4 else 4) for k in range(7)]
    assert len(ex._outputs) == 1  # the producers' group


@pytest.mark.parametrize("consumer", ["reshuffle", "reduce"])
def test_cogroup_feeding_a_shuffle_is_refused(consumer):
    """A Cogroup feeding a shuffle routes object lists: it runs on the
    host tier, and so does its host-column consumer."""
    def build():
        cg = bst.Cogroup(_keyed_const(), _keyed_const())
        return (bst.Reshuffle(cg) if consumer == "reshuffle"
                else bst.Reduce(cg, lambda a, b: a))

    _, rows = _cogroup_fallback(build)
    assert [r[0] for r in rows] == list(range(7))


def test_cogroup_over_vector_inputs_is_refused():
    """A Cogroup over a vector value column runs on the host tier (lists
    of [3] rows)."""
    import numpy as np

    k = np.arange(16, dtype=np.int32) % 5
    ex = bst.MeshExecutor(device="cpu")
    rows = bst.Session(executor=ex).run(bst.Cogroup(bst.Const(
        2, k, np.stack([k, k + 1, k + 2], 1)))).rows()
    assert sorted(int(r[0]) for r in rows) == list(range(5))
    for key, vals in rows:
        assert len(vals) == int((k == key).sum())
        assert all(list(np.asarray(v)) == [key, key + 1, key + 2]
                   for v in vals)
    assert len(ex._outputs) == 1  # the producers' group only


def test_machine_combined_cogroup_group_is_refused():
    """A machine-combined group whose combiner is host-tier (a Reduce
    over a Cogroup's lists) keeps the local executor's shared combiner
    buffer, on the device executor's host tier."""
    _, rows = _cogroup_fallback(
        lambda: bst.Reduce(bst.Cogroup(_keyed_const(), _keyed_const()),
                           lambda a, b: a), machine_combiners=True)
    assert [r[0] for r in rows] == list(range(7))


def test_parse_workers_import_no_torch():
    """``import bigslice_tpu_torch`` and the parse modules load no torch
    (the package's names import at first use), so a spawned parse
    worker of a main script that keeps torch out of its top level stays
    light; the worker still parses exactly."""
    code = textwrap.dedent("""
        import os, sys
        import bigslice_tpu_torch
        from bigslice_tpu_torch.frame import strparse
        assert "torch" not in sys.modules
        os.environ["BIGSLICE_PARSE_PROCS"] = "2"
        pool = strparse._pool()
        job = (b"http://A.com/x\\n/b.org\\n/", 2)
        res = pool.map(strparse._worker_parse, [job] * 8, chunksize=1)
        mods = set().union(*pool.map(
            eval, ["sorted(__import__('sys').modules)"] * 8, chunksize=1))
        strparse.shutdown_pool()
        assert "bigslice_tpu_torch.frame.strparse" in mods
        assert all(r[0] == "native" and r[2] == ["a.com", "b.org"]
                   for r in res), res
        print("TORCH", "torch" in sys.modules, "torch" in mods)
        sys.exit(1 if "torch" in sys.modules or "torch" in mods else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_loads_as_a_parse_worker():
    """``chip_smoke.py``'s phase 23 spawns parse workers, which import the
    script as ``__mp_main__``, where it loads no torch: nothing at its
    top level may name torch, or every worker dies at import and the pool
    waits on them for good."""
    import runpy

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    names = runpy.run_path(os.path.join(repo, "chip_smoke.py"),
                           run_name="__mp_main__")
    assert "torch" not in names and "main" in names


def test_robustness_plane_runs_without_jax():
    """The robustness plane's modules (utils/faultinject, exec/adaptive,
    exec/codedplan, tools/chaosslice) and runs under a chaos plan, a
    coded combine, a deadline and each adaptive policy import neither
    JAX nor the JAX package; faultinject, adaptive and codedplan import
    only the standard library (and the task names), chaosslice adds
    numpy."""
    code = textwrap.dedent("""
        import os, sys, tempfile
        before = set(sys.modules)
        from bigslice_tpu_torch.utils import faultinject
        from bigslice_tpu_torch.exec import adaptive, codedplan
        light = sorted(m for m in set(sys.modules) - before
                       if m.split(".")[0] in ("torch", "numpy"))
        assert not light, light
        import numpy as np
        import bigslice_tpu_torch as bs
        from bigslice_tpu_torch.exec.evaluate import DeadlineExceeded
        from bigslice_tpu_torch.tools import chaosslice

        keys = np.arange(2000, dtype=np.int32) % 37
        vals = np.ones(2000, np.int32)
        red = lambda: bs.Reduce(bs.Const(8, keys, vals), lambda a, b: a + b)
        faultinject.install(faultinject.parse_plan(
            "5:mesh.dispatch=1.0x1~infra,staging.assemble=1.0x2,"
            "shuffle.upload=1.0x2,store.read=0.25x4,eval.resubmit=0.15x2"))
        sess = bs.Session(executor=bs.MeshExecutor(device="cpu",
                                                   prefetch_depth=2))
        assert len(sess.run(red()).rows()) == 37
        assert sess.executor.probation
        faultinject.clear()
        os.environ["BIGSLICE_CODED"] = "combine"
        local = bs.Session(executor=bs.LocalExecutor(device="cpu"))
        assert len(local.run(red()).rows()) == 37
        assert local.telemetry.coded.count("covered") == 1
        del os.environ["BIGSLICE_CODED"]
        faultinject.install(faultinject.parse_plan("5:task.run=1.0x1~stuck"))
        try:
            bs.Session(executor=bs.LocalExecutor(device="cpu", procs=1)).run(
                red(), deadline_s=0.2)
            raise SystemExit("no deadline")
        except DeadlineExceeded:
            pass
        faultinject.clear()
        os.environ["BIGSLICE_ADAPTIVE"] = "all"
        s = bs.Session(executor=bs.MeshExecutor(device="cpu"))
        assert len(s.run(red()).rows()) == 37 and s.adaptive is not None
        del os.environ["BIGSLICE_ADAPTIVE"]
        assert chaosslice.main(["-chaos", "7:store.read=0.2x3,io.read=0.5x2",
                                "-rows", "2000", "-shards", "4",
                                "-device", "cpu"]) == 0
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "bigslice_tpu" or m.startswith("bigslice_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_operator_plane_runs_without_jax():
    """The operator plane's modules (utils/debughttp, parallel/
    kernelselect, tools/slicetrace, tools/obsdump) and a session with the
    debug server and a measured selector, slicetrace over its trace and
    obsdump's workload, import neither JAX nor the JAX package;
    debughttp and slicetrace import only the standard library (and the
    hub, for slicetrace)."""
    code = textwrap.dedent("""
        import json, os, sys, tempfile, urllib.request
        before = set(sys.modules)
        from bigslice_tpu_torch.utils import debughttp
        from bigslice_tpu_torch.tools import slicetrace
        light = sorted(m for m in set(sys.modules) - before
                       if m.split(".")[0] in ("torch", "numpy"))
        assert not light, light
        import numpy as np
        import bigslice_tpu_torch as bs
        from bigslice_tpu_torch.parallel import kernelselect
        from bigslice_tpu_torch.tools import obsdump

        d = tempfile.mkdtemp()
        os.environ["BIGSLICE_KERNEL_SELECT"] = "measured"
        trace = os.path.join(d, "t.json")
        sess = bs.Session(executor=bs.MeshExecutor(device="cpu"),
                          debug_port=0, trace_path=trace)
        keys = np.arange(4000, dtype=np.int32) * 7919 % 100003
        res = sess.run(bs.Reduce(bs.Const(4, keys, np.ones(4000, np.int32)),
                                 lambda a, b: a + b))
        assert len(res.rows()) == 4000
        del os.environ["BIGSLICE_KERNEL_SELECT"]
        url = f"http://127.0.0.1:{sess.debug.port}/debug/device"
        with urllib.request.urlopen(url, timeout=30) as r:
            assert "kernels" in json.loads(r.read().decode())
        assert sess.kernel_select.stats.samples >= 2
        sess.shutdown()
        assert ":kernels" in slicetrace.analyze(trace)
        summary = obsdump.run_workload(os.path.join(d, "o.json"), rows=4096,
                                       device="cpu")
        assert summary["workload"]["shards"] == 4
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "bigslice_tpu" or m.startswith("bigslice_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_serving_plane_runs_without_jax():
    """The serving plane's modules (serve/programcache, serve/server,
    tools/sliceserve) and a served pipeline through the program cache,
    a fresh Session attached and the sliceserve CLI's server, import
    neither JAX nor the JAX package; serve/programcache imports only the
    standard library."""
    code = textwrap.dedent("""
        import json, sys, urllib.request
        before = set(sys.modules)
        from bigslice_tpu_torch.serve import programcache
        light = sorted(m for m in set(sys.modules) - before
                       if m.split(".")[0] in ("torch", "numpy"))
        assert not light, light
        import numpy as np
        import bigslice_tpu_torch as bs
        from bigslice_tpu_torch.serve import ServeServer
        from bigslice_tpu_torch.tools import sliceserve

        keys = np.arange(4000, dtype=np.int32) % 37

        def pipe():
            return bs.Reduce(bs.Const(4, keys, np.ones(4000, np.int32)),
                             lambda a, b: a + b)

        sess = bs.Session(executor=bs.MeshExecutor(device="cpu"))
        srv = ServeServer(sess, port=0)
        srv.register("count", pipe)
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/serve/invoke",
            data=json.dumps({"pipeline": "count"}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read())["num_rows"] == 37
        srv.attach_session(bs.Session(executor=bs.MeshExecutor(device="cpu")))
        code, doc = srv.invoke_request({"pipeline": "count"})
        assert code == 200 and doc["num_rows"] == 37
        assert programcache.program_cache_stats()["hits"] >= 1
        srv.session.shutdown()
        sess.shutdown()
        cli = sliceserve.build_server(port=0, device="cpu")
        code, doc = cli.invoke_request({"pipeline": "reduce",
                                        "args": [4096, 64]})
        assert code == 200 and doc["num_rows"] == 64, doc
        cli.session.shutdown()
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "bigslice_tpu" or m.startswith("bigslice_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_attention_tools_and_staging_breakdown_run_without_jax():
    """SelfAttend on both tiers (the device stage at S = 1, the host
    tier's broadcast reader at S = 4), the three one-card tools' mains
    and the hub's staging breakdown import neither JAX nor the JAX
    package."""
    code = textwrap.dedent("""
        import contextlib, io, os, sys, tempfile
        import numpy as np
        import bigslice_tpu_torch as bs
        from bigslice_tpu_torch.parallel.ulysses import dense_mha_reference
        from bigslice_tpu_torch.tools import microbench, slicer
        from bigslice_tpu_torch.tools import slicetypecheck

        rng = np.random.RandomState(0)
        q3, k3, v3 = (rng.randn(40, 2, 4).astype(np.float32) * 0.3
                      for _ in range(3))
        flat = [x.reshape(40, 8) for x in (q3, k3, v3)]
        ref = dense_mha_reference(q3, k3, v3, causal=True).reshape(40, 8)
        for S in (1, 4):
            ex = bs.MeshExecutor(device="cpu")
            res = bs.Session(executor=ex).run(bs.SelfAttend(
                bs.Const(S, *flat), causal=True, heads=2))
            out = np.stack([np.asarray(o) for (o,) in res.rows()])
            np.testing.assert_allclose(out, ref, rtol=3e-4, atol=3e-4)
            assert bool(ex.attend_methods) == (S == 1), ex.attend_methods
        with contextlib.redirect_stdout(io.StringIO()):
            assert slicer.main(["reduce", "-rows", "500", "-shards", "2",
                                "-device", "cpu"]) == 0
            microbench.bench_eval(10)
            microbench.bench_device_reduce(1 << 8, device="cpu")
        path = os.path.join(tempfile.mkdtemp(), "p.py")
        with open(path, "w") as fh:
            fh.write("import bigslice_tpu_torch as bs\\n@bs.func\\n"
                     "def f(a):\\n    return None\\nsess.run(f)\\n")
        with contextlib.redirect_stdout(io.StringIO()):
            assert slicetypecheck.main([path]) == 1
        sess = bs.Session(executor=bs.MeshExecutor(device="cpu",
                                                   prefetch_depth=0))
        keys = np.arange(4000, dtype=np.int32) % 37
        sess.run(bs.Reduce(bs.Const(4, keys, np.ones(4000, np.int32)),
                           lambda a, b: a + b))
        waves = [o["waves"] for o in sess.telemetry_summary()["ops"].values()
                 if "waves" in o]
        assert any("staging_breakdown" in w for w in waves), waves
        sess.shutdown()
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "bigslice_tpu" or m.startswith("bigslice_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_spmd_modules_and_ranks_run_without_jax():
    """The SPMD plane's modules import neither JAX nor the JAX package,
    in the launching process or in any of its two ranks (each rank's
    report says what its ``sys.modules`` held), and ``spmd_session()``
    needs the GPU unless asked for the CPU."""
    code = textwrap.dedent("""
        import json, sys
        import bigslice_tpu_torch as bs
        from bigslice_tpu_torch import sliceconfig
        from bigslice_tpu_torch.exec import spmd
        from bigslice_tpu_torch.parallel import meshutil
        from bigslice_tpu_torch.tools import multihost_smoke, run
        from bigslice_tpu_torch.utils import distributed
        import io, contextlib
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = multihost_smoke.main(["2", "--device", "cpu",
                                       "--rows", "4096", "--deadline",
                                       "120"])
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        assert rc == 0, summary
        for r in summary["reports"]:
            assert r["jax_loaded"] is False, r
            assert r["bigslice_tpu_loaded"] is False, r
        assert len(summary["reports"]) == 2
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "bigslice_tpu" or m.startswith("bigslice_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    if not torch.cuda.is_available():
        from bigslice_tpu_torch.exec.spmd import spmd_session

        with pytest.raises(RuntimeError, match="no CUDA device"):
            spmd_session()


_RANK_PROGRAM = """
import os, sys
import numpy as np
import bigslice_tpu_torch as bs
from bigslice_tpu_torch.exec.spmd import spmd_session
from bigslice_tpu_torch.utils import distributed

keys = np.arange(2000, dtype=np.int32) % 53
red = bs.func(lambda n: bs.Reduce(bs.Const(2 * n, keys, keys),
                                  lambda a, b: a + b))
host = bs.func(lambda n: bs.Map(bs.Const(n, keys), lambda k: (str(k),),
                                out=[str]))
rng = np.random.RandomState(0)
q, k, v = (rng.randn(64, 8).astype(np.float32) for _ in "qkv")
att = bs.func(lambda n: bs.SelfAttend(bs.Const(n, q, k, v), causal=True))
distributed.initialize(device="cpu")
n = distributed.process_count()
sess = spmd_session(fleet_dir=sys.argv[1])
assert sess.executor.mesh.is_hier
assert len(sess.run(red, n).rows()) == 53
assert len(sess.run(host, n).rows()) == 2000
assert len(sess.run(att, n).rows()) == 64
assert sess.executor._hostdist.owned_count > 0
assert sess.telemetry_summary(scope="fleet")["nranks"] == n
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "bigslice_tpu" or m.startswith("bigslice_tpu."))
with open(os.path.join(sys.argv[1], f"leaked{distributed.process_index()}"),
          "w") as fh:
    fh.write(repr(leaked))
sess.executor.mesh.barrier()
sess.shutdown()
distributed.shutdown()
"""


def test_multiprocess_plane_runs_without_jax(tmp_path):
    """The multi-process plane's modules (``exec/hostdist.py``,
    ``parallel/hier.py``, ``utils/fleettelemetry.py``,
    ``tools/aotcheck.py``) and an elastic session in one process, then
    a 4-rank world on the 2-D mesh (a two-stage reduce, a host task
    run by its owner, a SelfAttend over the ranks, the fleet export),
    import neither JAX nor the JAX package."""
    code = textwrap.dedent("""
        import os, sys, tempfile
        import numpy as np
        import bigslice_tpu_torch as bs
        from bigslice_tpu_torch.exec import hostdist
        from bigslice_tpu_torch.parallel import hier
        from bigslice_tpu_torch.tools import aotcheck, obsdump
        from bigslice_tpu_torch.utils import faultinject, fleettelemetry
        d = tempfile.mkdtemp()
        faultinject.install(faultinject.parse_plan("0:peer.lost=0.5x1"))
        os.environ["BIGSLICE_ELASTIC_BACKOFF"] = "0"
        sess = bs.Session(executor=bs.MeshExecutor(device="cpu"),
                          elastic=1, fleet_dir=d)
        keys = np.arange(1000, dtype=np.int32) % 37
        res = sess.run(bs.Reduce(bs.Const(4, keys, np.ones(1000, np.int32)),
                                 lambda a, b: a + b))
        assert len(res.rows()) == 37
        assert sess.telemetry_summary(scope="fleet")["ranks"] == [0]
        sess.shutdown()
        faultinject.clear()
        assert obsdump.fleet_merge(d)["merged_from"] == 1
        assert aotcheck.sources()
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "bigslice_tpu" or m.startswith("bigslice_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    from bigslice_tpu_torch.tools import multihost_smoke

    prog = tmp_path / "ranks.py"
    prog.write_text(_RANK_PROGRAM)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = multihost_smoke.launch(
        4, [sys.executable, str(prog), str(tmp_path)], deadline_s=150.0,
        env={"PYTHONPATH": repo, "OMP_NUM_THREADS": "1",
             "BIGSLICE_MESH_SHAPE": "2x2"})
    assert res.rc == 0, "\n".join(res.stderr)
    for r in range(4):
        assert (tmp_path / f"leaked{r}").read_text() == "[]"
