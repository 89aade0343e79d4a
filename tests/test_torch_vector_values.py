"""K2's hash lowering over vector value columns against the JAX package.

The JAX package's hash lowering takes [n, G] value columns: its combine
classifies over one row's [G] vectors (reference
exec/meshexec.py ``_hash_combine_ops``) and its table build claims a
slot per key, then scatters whole rows (parallel/hashagg.py
``hash_aggregate``). The port does the same: ``FrameCombiner.hash_ops``
classifies with the columns' shapes, and ``cuda_kernels.hash_aggregate``
holds the rows' lanes in the kernel (narrow route) or places the rows
and scatters them after it (wide route); on the CPU its plain version,
the claim cascade and the row scatter, is the JAX package's XLA
lowering slot for slot.

Here the same seeded numpy inputs go through both packages: the plain
table against ``hashagg.hash_aggregate(backend="xla")``, the fused
combine-shuffle and the reduce-side combine against the JAX package's
on its 8-device CPU mesh (tests/test_hashagg.py:322), and undeclared
``Reduce``s through ``Session`` against the JAX package's
``MeshExecutor`` (tests/test_meshexec.py:603), each with the hash
lowering engaged: no ``hash_off`` entry and the K2 wrapper called.
Integer results are exact, float32 sums within the reference's 1e-4.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.parallel import hashagg as ref_hashagg  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.exec.meshexec import MeshExecutor  # noqa: E402
from bigslice_tpu_torch.parallel import cuda_kernels  # noqa: E402
from bigslice_tpu_torch.parallel import hashagg  # noqa: E402
from bigslice_tpu_torch.parallel import segment  # noqa: E402

RTOL = ATOL = 1e-4


def add(a, b):
    return a + b


@pytest.fixture
def k2_calls(monkeypatch):
    """Counts the K2 wrapper's calls with rows (``hashagg`` reaches it
    through the module attribute)."""
    calls = []
    real = cuda_kernels.hash_aggregate

    def counted(valid, key_cols, val_cols, *args, **kw):
        if key_cols[0].shape[0]:
            calls.append(tuple(tuple(v.shape[1:]) for v in val_cols))
        return real(valid, key_cols, val_cols, *args, **kw)

    monkeypatch.setattr(cuda_kernels, "hash_aggregate", counted)
    return calls


def _mesh(n):
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), ("shards",))


def _ref_session(n=1, **kw):
    from bigslice_tpu.exec.meshexec import MeshExecutor as RefMesh
    from bigslice_tpu.exec.session import Session

    return Session(executor=RefMesh(_mesh(n), auto_dense=False,
                                    hash_aggregate=True, **kw))


def _port_session(**kw):
    return bst.Session(executor=MeshExecutor(device="cpu",
                                             auto_dense=False, **kw))


def _by_key(shards):
    """{key: value row} over every shard, each key once."""
    got = {}
    for sh in shards:
        for k, v in zip(sh[0], sh[1]):
            assert int(k) not in got
            got[int(k)] = np.asarray(v)
    return got


def _assert_same(got, want, exact):
    assert set(got) == set(want)
    for k in want:
        if exact:
            np.testing.assert_array_equal(got[k], want[k])
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=ATOL)


# -- the table: the plain version against the JAX package's XLA build ---


def _table_case(G, dtype, op, seed):
    rng = np.random.RandomState(seed)
    n, nparts, R = 3000, 4, 256
    keys = rng.randint(0, nparts * R // 4, n).astype(np.int32)
    if dtype == np.int32:
        vals = rng.randint(-1000, 1000, (n, G)).astype(np.int32)
    else:
        vals = rng.randn(n, G).astype(np.float32)
        vals[::53, 0] = -0.0
        vals[::97, G - 1] = np.nan
    valid = rng.rand(n) < 0.9
    part = (keys % nparts).astype(np.int32)
    return keys, vals, valid, part, nparts, R


def _rows_by_key(present, keys, vals):
    present = np.asarray(present)
    k = np.asarray(keys)[present]
    v = np.asarray(vals)[present]
    order = np.argsort(k)
    return k[order], v[order]


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32],
                         ids=["int32", "float32"])
@pytest.mark.parametrize("G", [4, 128])
def test_plain_vector_table_matches_xla(G, dtype, op):
    """``hash_aggregate_plain`` over an [n, G] column equals the JAX
    package's ``hash_aggregate(backend="xla")`` per key on occupied
    rows, bits and all (both scatter whole rows in index order), and
    slot for slot (the same claim cascade)."""
    keys, vals, valid, part, nparts, R = _table_case(G, dtype, op, G)
    rp, rk, rv, rov = ref_hashagg.hash_aggregate(
        jnp.asarray(valid), [jnp.asarray(keys)], [jnp.asarray(vals)], [op],
        jnp.asarray(part), nparts, R, backend="xla")
    present, okeys, ovals, ov = cuda_kernels.hash_aggregate(
        torch.from_numpy(valid), [torch.from_numpy(keys)],
        [torch.from_numpy(vals)], [op], torch.from_numpy(part), nparts, R)
    assert int(ov) == int(rov) == 0
    assert ovals[0].shape == (nparts * R, G)
    gk, gv = _rows_by_key(present.numpy(), okeys[0].numpy(),
                          ovals[0].numpy())
    wk, wv = _rows_by_key(rp, rk[0], rv[0])
    np.testing.assert_array_equal(gk, wk)
    if dtype == np.float32:
        np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))
        np.testing.assert_array_equal(ovals[0].numpy().view(np.int32),
                                      np.asarray(rv[0]).view(np.int32))
    else:
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(ovals[0].numpy(), np.asarray(rv[0]))
    np.testing.assert_array_equal(present.numpy(), np.asarray(rp))


def test_empty_vector_table_holds_identities():
    """No rows: every lane of every slot holds the op's identity."""
    z = torch.zeros(0, dtype=torch.int32)
    present, _, tables, ov = cuda_kernels.hash_aggregate(
        torch.zeros(0, dtype=torch.bool), [z],
        [torch.zeros((0, 3), dtype=torch.float32),
         torch.zeros((0, 9), dtype=torch.int32)],
        ["max", "min"], z, 2, 8)
    assert not bool(present.any()) and int(ov) == 0
    assert tables[0].shape == (16, 3) and tables[1].shape == (16, 9)
    assert bool((tables[0] == float("-inf")).all())
    assert bool((tables[1] == np.iinfo(np.int32).max).all())


@pytest.mark.parametrize("shapes,held,wide", [
    ([()], (0,), ()),
    ([(8,)], (0,), ()),
    ([(4,), ()], (0, 1), ()),
    ([(2, 4)], (0,), ()),
    ([(9,)], (), (0,)),
    ([(), (128,)], (0,), (1,)),
    ([(4,), (4,), ()], (2,), (0, 1)),
    ([()] * 8, tuple(range(8)), ()),
])
def test_aggregate_routes(shapes, held, wide):
    """Narrow when every lane fits the kernel's eight; else the kernel
    holds the scalar columns and the vector ones are scattered."""
    assert cuda_kernels.aggregate_routes(shapes) == (held, wide)


@pytest.mark.parametrize("dtypes,held,wide", [
    ([torch.int32, torch.float32], (0, 1), ()),
    ([torch.int16, torch.int32], (1,), (0,)),
    ([torch.float16], (), (0,)),
    ([torch.int32] * 9, tuple(range(8)), (8,)),
])
def test_aggregate_routes_by_dtype(dtypes, held, wide):
    """Scalar columns of a dtype the kernel does not combine (int16,
    float16), and a ninth column, are scattered after it, as the JAX
    package's XLA table takes what its Pallas kernel cannot."""
    shapes = [()] * len(dtypes)
    assert cuda_kernels.aggregate_routes(shapes, dtypes) == (held, wide)


@pytest.mark.parametrize("dtype", [np.int16, np.float16],
                         ids=["int16", "float16"])
def test_reduce_over_values_the_kernel_does_not_combine(dtype, k2_calls):
    """An undeclared Reduce over an int16 or float16 value column takes
    the hash lowering in both packages (K2 places the rows, the column
    is scattered), with the JAX package's rows."""
    rng = np.random.RandomState(81)
    keys = rng.randint(0, 200, 2000).astype(np.int32)
    vals = rng.randint(-50, 50, 2000).astype(dtype)
    want = bst.result_shard_rows(_ref_session().run(
        ref_bs.Reduce(ref_bs.Const(4, keys, vals), add)))
    sess = _port_session()
    got = bst.result_shard_rows(sess.run(
        bst.Reduce(bst.Const(4, keys, vals), add)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    assert sess.executor.hash_off == frozenset()
    assert ((),) in k2_calls


def test_aggregate_supported_takes_vector_shapes():
    i32, f32 = torch.int32, torch.float32
    assert cuda_kernels.aggregate_supported([i32], [f32], 4, 1 << 16,
                                            1 << 18, [(128,)])
    assert cuda_kernels.aggregate_supported([i32], [i32, f32], 4, 64, 10,
                                            [(), (9,)])
    # The wide route's slots are int32: a table of 2**31 slots or more
    # cannot take it.
    assert not cuda_kernels.aggregate_supported([i32], [f32], 2**11,
                                                2**20, 10, [(128,)])
    assert cuda_kernels.aggregate_supported([i32], [f32], 2**11, 2**20,
                                            10, [(8,)])


def test_aggregate_plan_row_lane():
    plan = cuda_kernels.aggregate_plan(1, 0, 4, 1 << 16, 1000,
                                       row_lane=True)
    assert plan.payload_words == 2 * 1000
    assert plan.smem_bytes == 2 * 4 << plan.bucket_log2


def test_declared_cost_counts_vector_rows():
    """A [n, G] column's declared bytes are its rows' and its [T, G]
    table's; its operations one a lane."""
    n, T, G = 100, 64, 16
    c = cuda_kernels.cost("hash_aggregate", n=n, key_itemsizes=(4,),
                          val_itemsizes=(4 * G,), nparts=1, R=T,
                          val_lanes=G)
    assert c == {"bytes": n * (1 + 4 + 4 * G + 4) + T * (1 + 4 + 4 * G),
                 "flops": n * (8 + 2 + G)}


def test_wave_model_counts_the_wide_route():
    """The wide route keeps the scattered rows out of the kernel's
    bucketed copy, which carries a row index, beside each row's slot and
    the scatter's int64 index."""
    base = MeshExecutor.wave_bytes_model(1000, 4 + 512, hash_table=True)
    wide = MeshExecutor.wave_bytes_model(1000, 4 + 512, hash_table=True,
                                         wide_bytes=512)
    assert base - wide == 2 * 1000 * (512 - 16)


# -- the fused combine-shuffle and the reduce side (test_hashagg.py:322) --


def _ref_shardmap(fn, nouts, *arrays):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bigslice_tpu.parallel.meshutil import get_shard_map

    mesh = _mesh(8)
    sharding = NamedSharding(mesh, P("shards"))
    placed = [jax.device_put(a, sharding) for a in arrays]
    jitted = jax.jit(get_shard_map()(
        fn, mesh=mesh, in_specs=tuple(P("shards") for _ in arrays),
        out_specs=tuple(P("shards") for _ in range(nouts)),
        check_rep=False))
    return [np.asarray(o) for o in jitted(*placed)]


def test_hash_shuffle_vector_value_columns():
    """tests/test_hashagg.py:322, "the k-means point-sum shape": [n, 4]
    int32 rows through the fused combine-shuffle and the reduce-side
    combine. The JAX package runs 8 devices, each combining its n rows
    and routing partition p to device p; the port runs the same 8
    chunks as 8 map waves of one slot (8 partitions, a subid each),
    then each partition's rows through its reduce-side combine. Every
    partition holds the same keys with the same sums, exactly, and the
    K2 wrapper carried the vectors on both sides."""
    from bigslice_tpu.parallel import hashagg as rh
    from bigslice_tpu.parallel import segment as rseg

    n, d = 1 << 10, 4
    rng = np.random.RandomState(23)
    keys = rng.randint(0, 128, 8 * n).astype(np.int32)
    vecs = rng.randint(0, 10, (8 * n, d)).astype(np.int32)
    fused = rh.make_hash_combine_shuffle(8, 1, 1, ("add",), "shards")
    recv = rh.make_hash_combine(1, 1, ("add",))

    def body(k, v):
        valid = jnp.ones(n, bool)
        rm, ov, bad, oc = fused.masked(valid, k, v)
        m2, k2, v2, ov2 = recv(rm, (oc[0],), (oc[1],))
        cnt, packed = rseg.compact_by_mask(m2, tuple(k2) + tuple(v2))
        return cnt.reshape(1), (ov + ov2).reshape(1), packed[0], packed[1]

    cnt, over, ko, vo = _ref_shardmap(body, 4, keys, vecs)
    assert int(over.sum()) == 0
    size = len(ko) // 8
    want = {}
    for dev in range(8):
        c = int(cnt[dev])
        want[dev] = {int(ko[i]): vo[i].tolist()
                     for i in range(dev * size, dev * size + c)}

    body = hashagg.make_hash_combine_shuffle(1, 1, 1, ("add",), nparts=8)
    combine = hashagg.make_hash_combine(1, 1, ("add",))
    parts = collections.defaultdict(list)
    total_ov = 0
    for src in range(8):
        k = torch.from_numpy(keys[src * n:(src + 1) * n])
        v = torch.from_numpy(vecs[src * n:(src + 1) * n])
        mask, ov, cols = body(torch.ones(n, dtype=torch.bool), k, v)
        total_ov += int(ov)
        subid, ok, ov_ = cols
        assert ov_.shape == (mask.shape[0], d)
        for p in range(8):
            sel = mask & (subid == p)
            parts[p].append((ok[sel], ov_[sel]))
    got = {}
    for p in range(8):
        k = torch.cat([a for a, _ in parts[p]])
        v = torch.cat([b for _, b in parts[p]])
        m2, k2, v2, ov2 = combine(torch.ones(k.shape[0], dtype=torch.bool),
                                  (k,), (v,))
        total_ov += int(ov2)
        cnt2, packed = segment.compact_by_mask(m2, list(k2) + list(v2))
        c = int(cnt2)
        got[p] = {int(a): b.tolist()
                  for a, b in zip(packed[0][:c], packed[1][:c])}
    assert total_ov == 0
    assert got == want


# -- undeclared Reduces through Session (test_meshexec.py:603) -----------


def test_vector_value_reduce_on_mesh(k2_calls):
    """tests/test_meshexec.py:603: [n, 8] float32 rows through
    ``Session`` on the JAX package's 8-device mesh and its
    ``LocalExecutor``, against the port's ``MeshExecutor``: the same
    keys, sums within 1e-4 of each other and of the oracle, with the
    hash lowering engaged (K2 over the [8] rows, no ``hash_off``; the
    port's discovery is off, which would take its dense table over 23
    keys)."""
    from bigslice_tpu.exec.meshexec import MeshExecutor as RefMesh
    from bigslice_tpu.exec.session import Session

    rng = np.random.RandomState(3)
    n, d = 2048, 8
    keys = rng.randint(0, 23, n).astype(np.int32)
    vecs = rng.rand(n, d).astype(np.float32)
    oracle = collections.defaultdict(lambda: np.zeros(d, np.float64))
    for k, v in zip(keys, vecs):
        oracle[int(k)] += v
    local = Session().run(ref_bs.Reduce(ref_bs.Const(8, keys, vecs), add))
    meshr = Session(executor=RefMesh(_mesh(8))).run(
        ref_bs.Reduce(ref_bs.Const(8, keys, vecs), add))
    sess = _port_session()
    got = _by_key(bst.result_shard_rows(
        sess.run(bst.Reduce(bst.Const(8, keys, vecs), add))))
    for res in (local, meshr):
        want = {}
        for f in res.frames():
            kcol, vcol = np.asarray(f.cols[0]), np.asarray(f.cols[1])
            for j in range(len(f)):
                want[int(kcol[j])] = vcol[j]
        _assert_same(got, want, exact=False)
    _assert_same(got, oracle, exact=False)
    assert sess.executor.hash_off == frozenset()
    assert ((d,),) in k2_calls
    assert sess.executor.device_group_count() >= 2


@pytest.mark.parametrize("G", [4, 128])
def test_undeclared_int_vector_reduce_equals_the_reference(G, k2_calls):
    """An undeclared Reduce over int32 [n, G] rows equals the JAX
    package's one-device ``MeshExecutor`` exactly, shard for shard,
    through the hash lowering (K2 called on [G] rows, nothing on the
    sort path)."""
    rng = np.random.RandomState(G)
    n = 4000
    keys = rng.randint(0, 300, n).astype(np.int32)
    vals = rng.randint(-(2**31), 2**31 - 1, (n, G)).astype(np.int32)
    want = bst.result_shard_rows(_ref_session().run(
        ref_bs.Reduce(ref_bs.Const(4, keys, vals), add)))
    sess = _port_session()
    got = bst.result_shard_rows(sess.run(
        bst.Reduce(bst.Const(4, keys, vals), add)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            np.testing.assert_array_equal(gc, wc)
    assert sess.executor.hash_off == frozenset()
    assert ((G,),) in k2_calls


def _maxmin(mod):
    return lambda a, b: (mod.maximum(a[0], b[0]), mod.minimum(a[1], b[1]))


@pytest.mark.parametrize("G", [3, 16])
def test_vector_max_min_reduce_bits_equal(G, k2_calls):
    """float32 [n, G] max beside int32 [n, G] min, -0.0 and NaN among
    them: both packages' rows bit for bit."""
    rng = np.random.RandomState(40 + G)
    n = 3000
    keys = rng.randint(0, 200, n).astype(np.int32)
    f = rng.randn(n, G).astype(np.float32)
    f[::31, 0] = -0.0
    f[::37, G - 1] = 0.0
    f[::211, G // 2] = np.nan
    i = rng.randint(-(2**31), 2**31 - 1, (n, G)).astype(np.int32)
    want = bst.result_shard_rows(_ref_session().run(
        ref_bs.Reduce(ref_bs.Const(4, keys, f, i), _maxmin(jnp))))
    sess = _port_session()
    got = bst.result_shard_rows(sess.run(
        bst.Reduce(bst.Const(4, keys, f, i), _maxmin(torch))))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1].view(np.int32),
                                      w[1].view(np.int32))
        np.testing.assert_array_equal(g[2], w[2])
    assert sess.executor.hash_off == frozenset()
    assert ((G,), (G,)) in k2_calls


def test_vector_fn_that_does_not_classify_keeps_the_sort_path(k2_calls):
    """A combine fn that is not add/max/min per lane (a product) takes
    the sort path in both packages, with equal rows."""
    rng = np.random.RandomState(5)
    keys = rng.randint(0, 50, 1000).astype(np.int32)
    vals = rng.randint(1, 4, (1000, 4)).astype(np.int32)

    def mul(a, b):
        return a * b

    want = bst.result_shard_rows(_ref_session().run(
        ref_bs.Reduce(ref_bs.Const(4, keys, vals), mul)))
    r = bst.Reduce(bst.Const(4, keys, vals), mul)
    assert r.frame_combiner.hash_ops() is None
    got = bst.result_shard_rows(_port_session().run(r))
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            np.testing.assert_array_equal(gc, wc)
    assert k2_calls == []


def test_hash_ops_classify_vector_columns():
    """``hash_ops`` accepts [G] value columns per column, as the JAX
    package's ``_hash_combine_ops`` does; float keys still refuse."""
    k = np.zeros(4, np.int32)
    v = np.zeros((4, 5), np.float32)
    s = np.zeros(4, np.int32)
    r = bst.Reduce(bst.Const(1, k, v, s),
                   lambda a, b: (torch.maximum(a[0], b[0]), a[1] + b[1]))
    assert r.frame_combiner.hash_ops() == ("max", "add")
    r = bst.Reduce(bst.Const(1, k.astype(np.float32), v), add)
    assert r.frame_combiner.hash_ops() is None


@pytest.mark.parametrize("setting", ["waves", "prefetch2", "split",
                                     "spill", "sort"])
def test_vector_reduce_under_executor_settings(setting, k2_calls,
                                               monkeypatch, tmp_path):
    """The [n, G] rows through the wave pipeline's settings, equal to the
    JAX package's one-device executor: 16 shards on one slot (the
    cross-wave merge), prefetch depth 2, a budget split of each wave
    into row slices, the spill exchange, and the sort path pinned
    (``hash_aggregate=False``, which must not call K2)."""
    rng = np.random.RandomState(61)
    n, G = 4096, 6
    # Few keys a partition: a 16-shard wave's regions hold as many slots
    # as its rows, which near-distinct keys would overflow (in both
    # packages) onto the sort path.
    keys = rng.randint(0, 64, n).astype(np.int32)
    vals = rng.randint(-1000, 1000, (n, G)).astype(np.int32)
    kw = {}
    shards = 4
    if setting == "waves":
        shards = 16
    elif setting == "prefetch2":
        kw = dict(prefetch_depth=2)
    elif setting == "split":
        kw = dict(device_budget_bytes=1 << 15)
    elif setting == "spill":
        monkeypatch.setenv("BIGSLICE_SHUFFLE", "spill")
        monkeypatch.setenv("BIGSLICE_SPILL_DIR", str(tmp_path))
    elif setting == "sort":
        kw = dict(hash_aggregate=False)
    want = bst.result_shard_rows(_ref_session().run(
        ref_bs.Reduce(ref_bs.Const(shards, keys, vals), add)))
    sess = _port_session(**kw)
    got = bst.result_shard_rows(sess.run(
        bst.Reduce(bst.Const(shards, keys, vals), add)))
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            np.testing.assert_array_equal(gc, wc)
    if setting == "sort":
        assert k2_calls == []
    else:
        assert sess.executor.hash_off == frozenset()
        assert ((G,),) in k2_calls
    if setting == "split":
        assert sess.executor.split_runs


def test_vector_join_takes_the_hash_join(k2_calls):
    """A JoinAggregate over vector values: both sides' fns classify over
    [G] rows, so it takes the hash join (K2 on the map sides), as in the
    JAX package, with equal rows."""
    rng = np.random.RandomState(71)
    n, G = 2000, 4
    ak = rng.randint(0, 300, n).astype(np.int32)
    bk = rng.randint(100, 400, n).astype(np.int32)
    av = rng.randint(-50, 50, (n, G)).astype(np.int32)
    bv = rng.randint(-50, 50, (n, G)).astype(np.int32)
    want = bst.result_shard_rows(_ref_session().run(ref_bs.JoinAggregate(
        ref_bs.Const(4, ak, av), ref_bs.Const(4, bk, bv), add, add)))
    sess = _port_session()
    got = bst.result_shard_rows(sess.run(bst.JoinAggregate(
        bst.Const(4, ak, av), bst.Const(4, bk, bv), add, add)))
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            np.testing.assert_array_equal(gc, wc)
    assert ((G,),) in k2_calls
    assert sess.executor.hash_off == frozenset()


def test_standalone_hash_reduce_carries_vector_rows(k2_calls):
    """``hashagg.MeshHashReduceByKey`` (the fused map side, then the
    reduce side's table) over [n, 4] int32 rows: every key's sum exact,
    front-packed, K2 called on [4] rows on both sides."""
    rng = np.random.RandomState(91)
    n = 1000
    keys = rng.randint(0, 50, n).astype(np.int32)
    vals = rng.randint(-9, 9, (n, 4)).astype(np.int32)
    red = hashagg.MeshHashReduceByKey(1, 1, 1024, ["add"], device="cpu")
    ko, vo, cnt, ov = red([torch.from_numpy(keys)], [torch.from_numpy(vals)],
                          torch.tensor([n]))
    c = int(cnt[0])
    assert int(ov) == 0 and vo[0].shape == (red.out_capacity, 4)
    got = {int(k): v.tolist() for k, v in zip(ko[0][:c], vo[0][:c])}
    want = collections.defaultdict(lambda: np.zeros(4, np.int64))
    for k, v in zip(keys, vals):
        want[int(k)] += v
    assert got == {k: v.tolist() for k, v in want.items()}
    assert k2_calls.count(((4,),)) == 2
