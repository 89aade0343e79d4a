"""The whole slice: keyed Reduce through the port's device executor
(on the CPU, through the kernels' plain versions) against the JAX
package's MeshExecutor on 8 virtual CPU devices with the hash-aggregate
lowering, on the same seeded inputs.

Each output shard's sorted rows must be equal: bit-equal for int
columns and for float max/min; float add within 1e-5 * sum|v| per key,
because the two packages sum in different orders. The task graphs must
be equal under graph_string(locations=False), since the two call sites'
file:line differ.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.exec import compile as ref_compile  # noqa: E402
from bigslice_tpu.models import wordcount as ref_wordcount  # noqa: E402
import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.exec import compile as port_compile  # noqa: E402
from bigslice_tpu_torch.models import wordcount as port_wordcount  # noqa: E402


@pytest.fixture(scope="module")
def ref_session():
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    mesh = Mesh(np.array(jax.devices()[:8]), ("shards",))
    return Session(executor=MeshExecutor(mesh, auto_dense=False,
                                         hash_aggregate=True))


@pytest.fixture(scope="module")
def port_session():
    return bst.Session(executor=bst.MeshExecutor(device="cpu"))


def _keys(n, seed, span=2000):
    rng = np.random.RandomState(seed)
    return rng.randint(-span // 2, span, n).astype(np.int32)


def _graphs_equal(ref_slice, port_slice):
    want = ref_compile.graph_string(
        ref_compile.compile_slice(ref_slice, 1), locations=False)
    got = port_compile.graph_string(
        port_compile.compile_slice(port_slice, 1), locations=False)
    assert got == want


def _compare(ref_session, port_session, ref_slice, port_slice,
             float_add_cols=()):
    _graphs_equal(ref_slice, port_slice)
    want = bst.result_shard_rows(ref_session.run(ref_slice))
    got = bst.result_shard_rows(port_session.run(port_slice))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [c.dtype for c in g] == [c.dtype for c in w]
        assert len(g[0]) == len(w[0])
        for j, (gc, wc) in enumerate(zip(g, w)):
            if j in float_add_cols:
                continue
            if gc.dtype.kind == "f":
                np.testing.assert_array_equal(gc.view(np.int32),
                                              wc.view(np.int32))
            else:
                np.testing.assert_array_equal(gc, wc)
    return got


@pytest.mark.parametrize("S", [1, 4, 8])
def test_reduce_count_matches_reference(ref_session, port_session, S):
    keys = _keys(6000, S)
    ones = np.ones(len(keys), np.int32)
    got = _compare(
        ref_session, port_session,
        ref_bs.Reduce(ref_bs.Const(S, keys, ones), lambda a, b: a + b),
        bst.Reduce(bst.Const(S, keys, ones), lambda a, b: a + b),
    )
    k = np.concatenate([g[0] for g in got])
    v = np.concatenate([g[1] for g in got])
    uniq, cnt = np.unique(keys, return_counts=True)
    order = np.argsort(k)
    np.testing.assert_array_equal(k[order], uniq)
    np.testing.assert_array_equal(v[order], cnt)


def test_wordcount_ids_matches_reference(ref_session, port_session):
    rng = np.random.RandomState(7)
    ids = rng.zipf(1.3, 8000).clip(max=50000).astype(np.int32)
    _compare(ref_session, port_session,
             ref_wordcount.wordcount_ids(8, ids, 50001),
             port_wordcount.wordcount_ids(8, ids, 50001))


def test_reduce_max_min_matches_reference(ref_session, port_session):
    import jax.numpy as jnp

    rng = np.random.RandomState(11)
    n = 5000
    keys = _keys(n, 11, span=500)
    imax = rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32)
    fmin = (rng.randn(n) * 50).astype(np.float32)
    fmin[::97] = -0.0
    fmin[::89] = 0.0
    _compare(
        ref_session, port_session,
        ref_bs.Reduce(ref_bs.Const(4, keys, imax, fmin),
                      lambda a, b: (jnp.maximum(a[0], b[0]),
                                    jnp.minimum(a[1], b[1]))),
        bst.Reduce(bst.Const(4, keys, imax, fmin),
                   lambda a, b: (torch.maximum(a[0], b[0]),
                                 torch.minimum(a[1], b[1]))),
    )


def test_reduce_eight_value_columns_matches_reference(ref_session,
                                                     port_session):
    """The widest value side a combine can have (eight columns, every
    op, int32 and float32), the shape that sizes the kernel's buckets
    smallest, through the plain versions against the JAX package."""
    import jax.numpy as jnp

    rng = np.random.RandomState(17)
    n = 4000
    keys = _keys(n, 17, span=700)
    i = [rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32)
         for _ in range(5)]
    f = [(rng.randn(n) * 9).astype(np.float32) for _ in range(3)]
    f[0][::31] = -0.0
    cols = [i[0], i[1], i[2], f[0], f[1], i[3], i[4], f[2]]

    def fn(mod):
        return lambda a, b: (
            a[0] + b[0], mod.maximum(a[1], b[1]), mod.minimum(a[2], b[2]),
            mod.maximum(a[3], b[3]), mod.minimum(a[4], b[4]), a[5] + b[5],
            mod.minimum(a[6], b[6]), mod.maximum(a[7], b[7]))

    _compare(ref_session, port_session,
             ref_bs.Reduce(ref_bs.Const(4, keys, *cols), fn(jnp)),
             bst.Reduce(bst.Const(4, keys, *cols), fn(torch)))


def test_reduce_float_add_within_tolerance(ref_session, port_session):
    rng = np.random.RandomState(13)
    n = 6000
    keys = _keys(n, 13, span=300)
    vals = (rng.randn(n) * 10).astype(np.float32)
    got = _compare(
        ref_session, port_session,
        ref_bs.Reduce(ref_bs.Const(8, keys, vals), lambda a, b: a + b),
        bst.Reduce(bst.Const(8, keys, vals), lambda a, b: a + b),
        float_add_cols=(1,),
    )
    k = np.concatenate([g[0] for g in got])
    v = np.concatenate([g[1] for g in got]).astype(np.float64)
    order = np.argsort(k)
    uniq, inv = np.unique(keys, return_inverse=True)
    exact = np.bincount(inv, weights=vals.astype(np.float64))
    mag = np.bincount(inv, weights=np.abs(vals.astype(np.float64)))
    np.testing.assert_array_equal(k[order], uniq)
    assert (np.abs(v[order] - exact) <= 1e-5 * mag).all()
    # And against the reference's own float sums, by key.
    want = bst.result_shard_rows(ref_session.run(
        ref_bs.Reduce(ref_bs.Const(8, keys, vals), lambda a, b: a + b)))
    wk = np.concatenate([w[0] for w in want])
    wv = np.concatenate([w[1] for w in want]).astype(np.float64)
    np.testing.assert_array_equal(np.sort(wk), uniq)
    assert (np.abs(v[order] - wv[np.argsort(wk)]) <= 1e-5 * mag).all()


def test_frame_from_numpy_and_result_discard(port_session):
    keys = np.arange(100, dtype=np.int64) % 7
    f = bst.Frame.from_numpy([keys, np.ones(100)], device="cpu")
    assert f.cols[0].dtype == torch.int32 and f.cols[1].dtype == torch.float32
    res = port_session.run(bst.Reduce(bst.Const(2, *f.cols),
                                      lambda a, b: a + b))
    assert sorted(res.rows()) == [(k, float((keys == k).sum()))
                                  for k in range(7)]
    rows = sorted(res.rows())
    res.discard()
    ex = port_session.executor
    assert not any(ex._has_device_output(t.name) for t in res.tasks)
    # A discarded result re-evaluates on read.
    assert sorted(res.rows()) == rows


def test_map_side_partitions_read_through_the_store(port_session):
    """The map side's device-resident, wave-merged output read back per
    partition through the store bridge: partition p holds only keys the
    routing contract sends to p, each at most once per map wave, and
    the partitions' counts add up to the input."""
    from bigslice_tpu_torch import sliceio
    from bigslice_tpu_torch.parallel.cuda_kernels import hash_partition_plain
    from bigslice_tpu_torch.parallel.shuffle import send_capacity

    S = 4
    keys = _keys(4000, 21, span=300)
    res = port_session.run(bst.Reduce(bst.Const(S, keys,
                                                np.ones(4000, np.int32)),
                                      lambda a, b: a + b))
    producers = res.tasks[0].deps[0].tasks
    ex = port_session.executor
    total = 0
    for p in range(S):
        part = sliceio.read_all(
            (f for t in producers for f in ex.reader(t, p)),
            schema=producers[0].schema)
        k = part.cols[0]
        ids, _ = hash_partition_plain([k], S)
        assert bool((ids == p).all())
        assert len(k) <= S * len(np.unique(k.numpy()))
        total += int(part.cols[1].sum())
    assert total == 4000
    assert send_capacity(1000, 4) == 500


def test_concurrent_runs_share_one_executor(port_session):
    """Many threads run Reduces on one executor at once (group threads,
    the wave mutex and the output index are shared): every result is
    right, and every thread finishes in time."""
    import sys
    import threading

    errors, done = [], []

    def work(i):
        try:
            keys = _keys(3000, 100 + i, span=97)
            res = port_session.run(bst.Reduce(
                bst.Const(1 + i % 5, keys, np.ones(3000, np.int32)),
                lambda a, b: a + b))
            got = dict(res.rows())
            uniq, cnt = np.unique(keys, return_counts=True)
            assert got == dict(zip(uniq.tolist(), cnt.tolist()))
            done.append(i)
        except BaseException as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert sorted(done) == list(range(24))


# -- the sort lowering, map stages and the combinerless shuffle ------------


def _lww(mod):
    """Keep the latest record per key: max timestamp, its value."""
    return lambda a, b: (mod.maximum(a[0], b[0]),
                         mod.where(a[0] >= b[0], a[1], b[1]))


def _lww_chain(bs, mod, n):
    """The chip's lww-wave chain at ``n`` rows: Const -> Map (fold keys
    to 2**20) -> Filter (a timestamp watermark) -> Reduce (latest
    record per key)."""
    rng = np.random.RandomState(42)
    keys = rng.randint(0, 1 << 24, n).astype(np.int32)
    ts = rng.permutation(n).astype(np.int32)
    vals = rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32)
    s = bs.Map(bs.Const(4, keys, ts, vals),
               lambda k, t, v: (k & 0xFFFFF, t, v))
    s = bs.Filter(s, lambda k, t, v: t >= n // 8)
    return bs.Reduce(s, _lww(mod)), (keys, ts, vals)


def test_lww_chain_matches_reference(ref_session, port_session):
    import jax.numpy as jnp

    n = 1 << 14
    ref, _ = _lww_chain(ref_bs, jnp, n)
    port, (keys, ts, vals) = _lww_chain(bst, torch, n)
    got = _compare(ref_session, port_session, ref, port)
    # And against numpy: the latest (k, ts, v) of each folded key.
    k, t = (keys & 0xFFFFF), ts
    sel = t >= n // 8
    order = np.lexsort((t[sel], k[sel]))
    last = np.r_[k[sel][order][1:] != k[sel][order][:-1], True]
    want = sorted(zip(k[sel][order][last].tolist(),
                      t[sel][order][last].tolist(),
                      vals[sel][order][last].tolist()))
    rows = sorted(r for g in got for r in zip(*[c.tolist() for c in g]))
    assert rows == want


def _float_keys(n, seed):
    rng = np.random.RandomState(seed)
    keys = rng.randn(n).astype(np.float32)[rng.randint(0, 300, n)]
    keys[::13] = 0.0
    keys[::17] = -0.0
    keys[::29] = np.nan
    return keys


def test_float_key_reduce_matches_reference(ref_session, port_session):
    """Float keys on the sort lowering: +-0.0 one key, each NaN row
    alone; counts bit-equal, float sums within 1e-5 * sum|v| per key."""
    def _add2(a, b):
        return (a[0] + b[0], a[1] + b[1])

    n = 6000
    keys = _float_keys(n, 3)
    ones = np.ones(n, np.int32)
    vals = (np.random.RandomState(4).randn(n) * 10).astype(np.float32)
    got = _compare(
        ref_session, port_session,
        ref_bs.Reduce(ref_bs.Const(4, keys, ones, vals), _add2),
        bst.Reduce(bst.Const(4, keys, ones, vals), _add2),
        float_add_cols=(2,),
    )
    want = bst.result_shard_rows(ref_session.run(
        ref_bs.Reduce(ref_bs.Const(4, keys, ones, vals),
                      _add2)))
    # Sum |v| per key (+-0.0 one key; a NaN key's row is its own).
    canon = np.where(keys == 0, np.float32(0), keys)
    mag = {}
    for kb, v in zip(canon.view(np.int32).tolist(), np.abs(vals).tolist()):
        mag[kb] = mag.get(kb, 0.0) + v
    for g, w in zip(got, want):
        gk = np.where(g[0] == 0, np.float32(0), g[0])
        bound = np.array([
            abs(float(v)) if np.isnan(k) else mag[int(kb)]
            for k, kb, v in zip(gk, gk.view(np.int32), w[2])])
        err = np.abs(g[2].astype(np.float64) - w[2].astype(np.float64))
        assert (err <= 1e-5 * bound).all()
    k = np.concatenate([g[0] for g in got])
    c = np.concatenate([g[1] for g in got])
    nan = np.isnan(k)
    assert nan.sum() == np.isnan(keys).sum() and (c[nan] == 1).all()
    assert (k == 0).sum() == 1
    assert c[k == 0][0] == (keys == 0).sum()


def test_map_filter_reduce_matches_reference(ref_session, port_session):
    keys = _keys(5000, 31, span=4000)
    vals = np.random.RandomState(31).randint(0, 50, 5000).astype(np.int32)
    _compare(
        ref_session, port_session,
        ref_bs.Reduce(ref_bs.Filter(
            ref_bs.Map(ref_bs.Const(4, keys, vals),
                       lambda k, v: (k % 97, v * 3)),
            lambda k, v: v % 2 == 0), lambda a, b: a + b),
        bst.Reduce(bst.Filter(
            bst.Map(bst.Const(4, keys, vals),
                    lambda k, v: (k % 97, v * 3)),
            lambda k, v: v % 2 == 0), lambda a, b: a + b),
    )


def test_flatmap_reduce_matches_reference(ref_session, port_session):
    import jax.numpy as jnp

    def dup(mod):
        def f(k, v):
            if mod is jnp:
                mask = jnp.array([True, True]) & (v >= 0)
            else:
                mask = torch.tensor([True, True], device=k.device) & (v >= 0)
            return mask, mod.stack([k, k + 1]), mod.stack([v, v + 7])
        return f

    keys = _keys(3000, 33, span=300)
    vals = np.random.RandomState(33).randint(-5, 50, 3000).astype(np.int32)
    _compare(
        ref_session, port_session,
        ref_bs.Reduce(ref_bs.Flatmap(ref_bs.Const(3, keys, vals), dup(jnp),
                                     out=[np.int32, np.int32], fanout=2),
                      lambda a, b: jnp.maximum(a, b) - 1),
        bst.Reduce(bst.Flatmap(bst.Const(3, keys, vals), dup(torch),
                               out=[np.int32, np.int32], fanout=2),
                   lambda a, b: torch.maximum(a, b) - 1),
    )


@pytest.mark.parametrize("n", [0, 3, 700])
def test_head_matches_reference(ref_session, port_session, n):
    keys = _keys(2000, 35)
    vals = np.arange(2000, dtype=np.int32)
    _compare(ref_session, port_session,
             ref_bs.Head(ref_bs.Map(ref_bs.Const(4, keys, vals),
                                    lambda k, v: (k, v + 1)), n),
             bst.Head(bst.Map(bst.Const(4, keys, vals),
                              lambda k, v: (k, v + 1)), n))


@pytest.mark.parametrize("S", [1, 4, 8])
def test_reshuffle_matches_reference(ref_session, port_session, S):
    keys = _keys(3000, 40 + S, span=1 << 20)
    vals = (np.random.RandomState(S).randn(3000)).astype(np.float32)
    got = _compare(ref_session, port_session,
                   ref_bs.Reshuffle(ref_bs.Const(S, keys, vals)),
                   bst.Reshuffle(bst.Const(S, keys, vals)))
    _shards_routed_by_hash(got)


def _shards_routed_by_hash(shards):
    from bigslice_tpu_torch.parallel.cuda_kernels import hash_partition_plain

    for s, cols in enumerate(shards):
        if len(cols[0]):
            ids, _ = hash_partition_plain([torch.from_numpy(cols[0])],
                                          len(shards))
            assert bool((ids == s).all())


def test_repartition_matches_reference(ref_session, port_session):
    keys = _keys(3000, 50, span=1000)
    vals = np.arange(3000, dtype=np.int32)
    got = _compare(
        ref_session, port_session,
        ref_bs.Repartition(ref_bs.Const(4, keys, vals),
                           lambda k, n: (k * 7 + 3) % n),
        bst.Repartition(bst.Const(4, keys, vals),
                        lambda k, n: (k * 7 + 3) % n))
    for s, cols in enumerate(got):
        assert ((cols[0] * 7 + 3) % 4 == s).all()


def test_maxint_matches_reference(ref_session, port_session):
    from bigslice_tpu.models import maxint as ref_maxint
    from bigslice_tpu_torch.models import maxint as port_maxint

    rng = np.random.RandomState(60)
    keys = _keys(4000, 60, span=500)
    vals = rng.randint(-(2**31), 2**31 - 1, 4000).astype(np.int32)
    _compare(ref_session, port_session,
             ref_maxint.int_max(ref_bs.Const(4, keys, vals)),
             port_maxint.int_max(bst.Const(4, keys, vals)))


def test_sorted_partitions_read_back(port_session):
    """A Reshuffle's partitions read back and sorted on their device:
    the same multiset of rows, each partition sorted by key."""
    keys = _keys(5000, 70, span=1 << 30)
    res = port_session.run(bst.Reshuffle(bst.Const(4, keys)))
    parts = []
    for shard in range(4):
        frames = list(res.reader(shard, ()))
        if frames:
            f = bst.Frame.concat(frames).sorted_by_key()
            k = f.cols[0].numpy()
            assert (np.diff(k) >= 0).all()
            parts.append(k)
    np.testing.assert_array_equal(np.sort(np.concatenate(parts)),
                                  np.sort(keys))
