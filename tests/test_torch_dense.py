"""The port's dense lowerings against the JAX package's.

Each case of tests/test_dense.py has its counterpart here: the same
seeded numpy inputs go through the JAX package's ``MeshExecutor`` on a
one-device CPU mesh (so the device count, and with it every lowering
decision, matches the port's) and the port's ``MeshExecutor(device=
"cpu")``. Integer results are equal bit for bit; float sums within
``rtol=1e-5``. No case here needs a multi-device mesh (one device runs
8 shards as 8 waves).

Beside them: the routing and rank tables bit-equal to the JAX package's,
the dense functions held one by one against the JAX package's (the
exchanging ones under its one-device ``shard_map``), the standalone
classes against the counterparts tests/test_shuffle.py, test_join.py and
test_wave_pipeline.py use, and a float32 vector-value Reduce on the hash
lowering (formerly C3.4's pinned divergence).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.parallel import dense as ref_dense  # noqa: E402
from bigslice_tpu.parallel import segment as ref_segment  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.exec import meshexec  # noqa: E402
from bigslice_tpu_torch.exec.task import TaskError  # noqa: E402
from bigslice_tpu_torch.parallel import dense  # noqa: E402
from bigslice_tpu_torch.parallel import segment  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def mesh1():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:1]), ("shards",))


def _ref_session(mesh1, **kw):
    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    return Session(executor=MeshExecutor(mesh1, **kw))


def _port_session(**kw):
    return bst.Session(executor=bst.MeshExecutor(device="cpu", **kw))


def assert_same_shards(got, want, rtol=RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [c.dtype for c in g] == [c.dtype for c in w]
        for gc, wc in zip(g, w):
            if gc.dtype.kind == "f":
                np.testing.assert_allclose(gc, wc, rtol=rtol, atol=ATOL)
            else:
                np.testing.assert_array_equal(gc, wc)


def run_both(mesh1, build, port_kw=None, ref_kw=None):
    """``build(bs, mod)`` (``mod`` the array module its fns use) through
    both packages; the shards compared. Returns (port slice, ref slice,
    port rows)."""
    rs = build(ref_bs, jnp)
    ps = build(bst, torch)
    want = bst.result_shard_rows(
        _ref_session(mesh1, **(ref_kw or {})).run(rs))
    got = bst.result_shard_rows(_port_session(**(port_kw or {})).run(ps))
    assert_same_shards(got, want)
    return ps, rs, got


@pytest.fixture
def dense_calls(monkeypatch):
    """Counts of the executor's dense lowerings built while the test
    runs (a lowering is built once a wave)."""
    calls = {"combine": 0, "join": 0, "fold": 0, "combine_shuffle": 0}
    for name in calls:
        fn = getattr(dense, f"make_dense_{name}")

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(meshexec.dense_mod, f"make_dense_{name}", spy)
    return calls


def rows_dict(got):
    return {int(k): tuple(x.item() for x in rest)
            for sh in got for k, *rest in zip(*sh)}


def add(a, b):
    return a + b


# ---------------------------------------------------------- classifier


def _canon(fn, nvals):
    return segment.canonical_combine(fn, nvals)


def _ref_canon(fn, nvals):
    return ref_segment.canonical_combine(fn, nvals)


@pytest.mark.parametrize("case", ["add-int32", "max-float32", "min-int32"])
def test_classify_add_max_min(case):
    op, dt = case.split("-")
    pfn = {"add": add, "max": torch.maximum, "min": torch.minimum}[op]
    rfn = {"add": add, "max": jnp.maximum, "min": jnp.minimum}[op]
    got = dense.classify_combine_ops(_canon(pfn, 1), [np.dtype(dt)])
    assert got == (op,)
    assert got == ref_dense.classify_combine_ops(_ref_canon(rfn, 1),
                                                 [np.dtype(dt)])


def test_classify_per_column_mix():
    def fn(mod):
        return lambda a, b: (a[0] + b[0], mod.maximum(a[1], b[1]))

    dts = [np.int32, np.float32]
    got = dense.classify_combine_ops(_canon(fn(torch), 2), dts)
    assert got == ("add", "max") == ref_dense.classify_combine_ops(
        _ref_canon(fn(jnp), 2), dts)


def test_classify_rejects_nonstandard():
    for fn, n, dts in ((lambda a, b: a * b, 1, [np.int32]),
                       (lambda a, b: (a[0] + b[1], a[1] + b[0]), 2,
                        [np.int32, np.int32])):
        assert dense.classify_combine_ops(_canon(fn, n), dts) is None
        assert ref_dense.classify_combine_ops(_ref_canon(fn, n), dts) is None


def test_classify_vector_value_columns():
    """Vector value columns classify per column, as the JAX package's."""
    def fn(mod):
        return lambda a, b: (a[0] + b[0], mod.minimum(a[1], b[1]))

    dts, shapes = [np.float32, np.int32], [(4,), (3,)]
    got = dense.classify_combine_ops(_canon(fn(torch), 2), dts, shapes)
    assert got == ("add", "min") == ref_dense.classify_combine_ops(
        _ref_canon(fn(jnp), 2), dts, shapes)


# ------------------------------------------------------ routing tables


def test_routing_matches_sort_path_hash():
    from bigslice_tpu_torch.parallel import shuffle

    K, P = 1000, 8
    table, maxc = dense.routing_tables(K, P, 0)
    part, _, _ = shuffle.partition_ids(
        (torch.arange(K, dtype=torch.int32),), P, 0)
    part = part.numpy()
    for p in range(P):
        slots = table[p][table[p] != K]
        assert slots.tolist() == np.flatnonzero(part == p).tolist()
    assert table.shape == (P, maxc)


@pytest.mark.parametrize("nparts", [1, 4, 16])
@pytest.mark.parametrize("K", [1, 200, (1 << 16) + 3, 1 << 20])
def test_routing_and_rank_tables_bit_equal(K, nparts):
    table, maxc = dense.routing_tables(K, nparts, 0)
    rtable, rmaxc = ref_dense.routing_tables(K, nparts, 0)
    assert maxc == rmaxc and table.dtype == rtable.dtype
    np.testing.assert_array_equal(table, rtable)
    pid, rank, m2 = dense.rank_tables(K, nparts, 0)
    rpid, rrank, rm2 = ref_dense.rank_tables(K, nparts, 0)
    assert m2 == rm2
    np.testing.assert_array_equal(pid, rpid)
    np.testing.assert_array_equal(rank, rrank)


# ----------------------------------------- the dense functions, one by one


def _f32_specials(rng, n):
    v = rng.randn(n).astype(np.float32)
    v[rng.randint(0, n, 6)] = np.nan
    v[rng.randint(0, n, 6)] = 0.0
    v[rng.randint(0, n, 6)] = -0.0
    return v


@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_make_dense_combine_matches_jax(op):
    rng = np.random.RandomState(3)
    K, n = 97, 3000
    key = rng.randint(-5, K + 5, n).astype(np.int32)
    valid = rng.rand(n) < 0.9
    iv = rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32)
    fv = (_f32_specials(rng, n) if op != "add"
          else rng.randn(n).astype(np.float32))
    vec = rng.randn(n, 4).astype(np.float32)
    ops = (op, op, op)
    got = dense.make_dense_combine(K, ops)(
        torch.from_numpy(valid), (torch.from_numpy(key),),
        tuple(torch.from_numpy(v) for v in (iv, fv, vec)))
    want = ref_dense.make_dense_combine(
        K, ops, [np.int32, np.float32, np.float32])(
        jnp.asarray(valid), (jnp.asarray(key),),
        tuple(jnp.asarray(v) for v in (iv, fv, vec)))
    mask = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), mask)
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1][0]))
    for g, w in zip(got[2], want[2]):
        g, w = g.numpy()[mask], np.asarray(w)[mask]
        if op == "add" and g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        else:
            # Exact, float max/min included: NaN propagates, -0.0 < +0.0.
            np.testing.assert_array_equal(g.view(np.int32),
                                          w.view(np.int32))


@pytest.mark.parametrize("op,dt", [("max", np.float32), ("min", np.float32),
                                   ("add", np.int32), ("max", np.int32)])
def test_make_dense_fold_matches_jax(op, dt):
    rng = np.random.RandomState(4)
    K, n = 64, 2000
    key = rng.randint(0, K, n).astype(np.int32)
    valid = rng.rand(n) < 0.8
    v = (_f32_specials(rng, n) if dt == np.float32
         else rng.randint(-1000, 1000, n).astype(np.int32))
    init = -3
    got = dense.make_dense_fold(K, op, dt, init)(
        torch.from_numpy(valid), (torch.from_numpy(key),),
        (torch.from_numpy(v),))
    want = ref_dense.make_dense_fold(K, op, dt, init)(
        jnp.asarray(valid), (jnp.asarray(key),), (jnp.asarray(v),))
    mask = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), mask)
    g, w = got[2][0].numpy()[mask], np.asarray(want[2][0])[mask]
    np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


def _shard_map1(mesh1, fn, n_in, out_specs):
    from jax.sharding import PartitionSpec as P

    from bigslice_tpu.parallel.meshutil import get_shard_map

    return jax.jit(get_shard_map()(fn, mesh=mesh1,
                                   in_specs=(P("shards"),) * n_in,
                                   out_specs=out_specs, check_rep=False))


def test_make_dense_join_matches_jax(mesh1):
    from jax.sharding import PartitionSpec as P

    rng = np.random.RandomState(5)
    K, n = 300, 2500
    ka = rng.randint(-3, K + 3, n).astype(np.int32)
    kb = rng.randint(0, K // 2, n).astype(np.int32)
    va = rng.randint(-50, 50, n).astype(np.int32)
    vb = _f32_specials(rng, n)
    ma, mb = rng.rand(n) < 0.9, rng.rand(n) < 0.9
    got = dense.make_dense_join(K, ("add",), ("max",), 1)(
        torch.from_numpy(ma), [torch.from_numpy(ka), torch.from_numpy(va)],
        torch.from_numpy(mb), [torch.from_numpy(kb), torch.from_numpy(vb)])
    rjoin, maxc = ref_dense.make_dense_join(
        K, ("add",), ("max",), [np.int32], [np.float32], 1, "shards")

    def body(ma, ka, va, mb, kb, vb):
        m, cols, bad = rjoin(ma, [ka, va], mb, [kb, vb])
        return m, tuple(cols), bad

    want = _shard_map1(mesh1, body, 6,
                       (P("shards"), (P("shards"),) * 3, P()))(
        ma, ka, va, mb, kb, vb)
    mask = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), mask)
    for g, w in zip(got[1], want[1]):
        g, w = g.numpy()[mask], np.asarray(w)[mask]
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    assert int(got[2]) == int(want[2]) > 0


def test_make_dense_combine_shuffle_matches_jax(mesh1):
    from jax.sharding import PartitionSpec as P

    rng = np.random.RandomState(6)
    K, n = 200, 3000
    key = rng.randint(-2, K + 2, n).astype(np.int32)
    valid = rng.rand(n) < 0.9
    iv = rng.randint(-99, 99, n).astype(np.int32)
    fv = _f32_specials(rng, n)
    got = dense.make_dense_combine_shuffle(1, K, ("add", "min"))(
        torch.from_numpy(valid), torch.from_numpy(key),
        torch.from_numpy(iv), torch.from_numpy(fv))
    body = ref_dense.make_dense_combine_shuffle(
        1, K, ("add", "min"), [np.int32, np.float32], "shards")
    want = _shard_map1(mesh1, body.masked, 4,
                       (P("shards"), P(), P(), (P("shards"),) * 3))(
        valid, key, iv, fv)
    mask = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), mask)
    assert int(got[1]) == int(want[1]) == 0
    assert int(got[2]) == int(want[2]) > 0
    for g, w in zip(got[3], want[3]):
        g, w = g.numpy()[mask], np.asarray(w)[mask]
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


# ------------------------------------------------------- e2e, one device


def oracle(keys, vals, op):
    out = {}
    f = {"add": lambda a, b: a + b, "max": max, "min": min}[op]
    for k, v in zip(keys.tolist(), vals.tolist()):
        out[k] = f(out[k], v) if k in out else v
    return out


@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_dense_reduce_matches_oracle(mesh1, op, dense_calls):
    rng = np.random.RandomState(3)
    K = 500
    keys = rng.randint(0, K, 6000).astype(np.int32)
    vals = rng.randint(-100, 100, 6000).astype(np.int32)

    def build(bs, mod):
        fn = {"add": add, "max": mod.maximum, "min": mod.minimum}[op]
        return bs.Reduce(bs.Const(8, keys, vals), fn, dense_keys=K)

    ps, _, got = run_both(mesh1, build)
    assert ps.frame_combiner.dense_keys == K
    assert {k: v[0] for k, v in rows_dict(got).items()} == oracle(
        keys, vals, op)
    assert dense_calls["combine"] >= 1


def test_dense_matches_sort_path_exactly(mesh1):
    rng = np.random.RandomState(4)
    K = 300
    keys = rng.randint(0, K, 4000).astype(np.int32)
    vals = rng.randn(4000).astype(np.float32)
    _, _, d = run_both(mesh1, lambda bs, mod: bs.Reduce(
        bs.Const(8, keys, vals), add, dense_keys=K))
    _, _, s = run_both(mesh1, lambda bs, mod: bs.Reduce(
        bs.Const(8, keys, vals), add), port_kw=dict(auto_dense=False),
        ref_kw=dict(auto_dense=False))
    d, s = rows_dict(d), rows_dict(s)
    assert set(d) == set(s)
    for k in d:
        # Both reassociate float adds; equal up to accumulation order.
        assert abs(d[k][0] - s[k][0]) < 1e-3


def test_dense_multi_value_mixed_ops(mesh1):
    rng = np.random.RandomState(5)
    K = 64
    keys = rng.randint(0, K, 3000).astype(np.int32)
    v1 = rng.randint(0, 50, 3000).astype(np.int32)
    v2 = rng.randn(3000).astype(np.float32)

    def build(bs, mod):
        return bs.Reduce(bs.Const(8, keys, v1, v2),
                         lambda a, b: (a[0] + b[0], mod.maximum(a[1], b[1])),
                         dense_keys=K)

    ps, rs, got = run_both(mesh1, build)
    assert ps.frame_combiner.dense_ops == ("add", "max") == \
        rs.frame_combiner.dense_ops
    want = {}
    for k, a, b in zip(keys.tolist(), v1.tolist(), v2.tolist()):
        want[k] = ((want[k][0] + a, max(want[k][1], b)) if k in want
                   else (a, b))
    g = rows_dict(got)
    assert set(g) == set(want)
    for k in want:
        assert g[k][0] == want[k][0] and abs(g[k][1] - want[k][1]) < 1e-6


def test_unclassifiable_fn_ignores_dense_hint(mesh1):
    def build(bs, mod):
        return bs.Reduce(bs.Const(8, np.arange(100, dtype=np.int32) % 7,
                                  np.ones(100, np.int32)),
                         lambda a, b: a * b, dense_keys=7)

    ps, rs, got = run_both(mesh1, build)
    assert ps.frame_combiner.dense_keys is None is rs.frame_combiner.dense_keys
    assert {k: v[0] for k, v in rows_dict(got).items()} == {
        k: 1 for k in range(7)}


def _raises_range(mesh1, build):
    """Both packages fail the run, naming the declared range."""
    with pytest.raises(TaskError) as ei:
        _port_session().run(build(bst, torch)).rows()
    assert isinstance(ei.value.cause, ValueError)
    assert "dense_keys" in str(ei.value.cause)
    with pytest.raises(Exception) as ri:
        _ref_session(mesh1).run(build(ref_bs, jnp)).rows()
    assert "dense_keys" in repr(ri.value) or "partitioner" in repr(ri.value)


def test_out_of_range_keys_fail_loudly(mesh1):
    keys = np.array([0, 1, 2, 99], dtype=np.int32)  # 99 >= K

    def build(bs, mod):
        return bs.Reduce(bs.Const(8, keys, np.ones(4, np.int32)), add,
                         dense_keys=10)

    assert build(bst, torch).frame_combiner.dense_keys == 10
    _raises_range(mesh1, build)


def test_dense_result_feeds_downstream_consumers(mesh1):
    """The dense producer's rows reach a consumer compiled against it."""
    rng = np.random.RandomState(6)
    K = 128
    keys = rng.randint(0, K, 2000).astype(np.int32)

    def build(bs, mod):
        red = bs.Reduce(bs.Const(8, keys, np.ones(2000, np.int32)), add,
                        dense_keys=K)
        return bs.Map(red, lambda k, c: (k, c * 10))

    _, _, got = run_both(mesh1, build)
    want = {int(k): int(c) * 10 for k, c in
            zip(*np.unique(keys, return_counts=True))}
    assert {k: v[0] for k, v in rows_dict(got).items()} == want


@pytest.mark.parametrize("kind", ["local", "mesh"])
def test_wordcount_model_uses_dense_path(tmp_path, kind):
    """The urls model's encoded count (a dense Reduce over the codes) on
    the port's local and device executors, equal to the JAX package's
    on its LocalExecutor."""
    from bigslice_tpu.exec.local import LocalExecutor
    from bigslice_tpu.exec.session import Session
    import bigslice_tpu.models.urls as ref_urls
    import bigslice_tpu_torch.models.urls as urls_mod

    p = tmp_path / "urls.txt"
    lines = [f"http://site{i % 5}.com/p{i}" for i in range(100)]
    p.write_text("\n".join(lines) + "\n")
    ex = (bst.LocalExecutor(device="cpu") if kind == "local"
          else bst.MeshExecutor(device="cpu"))
    rows = urls_mod.domain_count_encoded(bst.Session(executor=ex), 2, str(p))
    assert dict(rows) == {f"site{i}.com": 20 for i in range(5)}
    ref = ref_urls.domain_count_encoded(Session(executor=LocalExecutor()), 2,
                                        str(p))
    assert sorted(rows) == sorted(ref)


def test_dense_combine_single_partition_one_device_mesh(mesh1, dense_calls):
    """One shard: no shuffle stage; the combine stage takes the dense
    table."""
    rng = np.random.RandomState(7)
    K = 200
    keys = rng.randint(0, K, 5000).astype(np.int32)
    vals = rng.randint(-5, 5, 5000).astype(np.int32)
    _, _, got = run_both(mesh1, lambda bs, mod: bs.Reduce(
        bs.Const(1, keys, vals), add, dense_keys=K))
    assert {k: v[0] for k, v in rows_dict(got).items()} == oracle(
        keys, vals, "add")
    assert dense_calls["combine"] == 1


def test_dense_combine_out_of_range_single_partition_raises(mesh1):
    keys = np.array([0, 1, 50], dtype=np.int32)
    _raises_range(mesh1, lambda bs, mod: bs.Reduce(
        bs.Const(1, keys, np.ones(3, np.int32)), add, dense_keys=10))


# -------------------------------------------------------------- dense join


def join_oracle(ak, av, bk, bv):
    A, B = {}, {}
    for k, v in zip(ak.tolist(), av.tolist()):
        A[k] = A.get(k, 0) + v
    for k, v in zip(bk.tolist(), bv.tolist()):
        B[k] = B.get(k, 0) + v
    return {k: (A[k], B[k]) for k in A if k in B}


def test_dense_join_matches_oracle(mesh1):
    rng = np.random.RandomState(8)
    K = 400
    ak = rng.randint(0, K, 4000).astype(np.int32)
    bk = rng.randint(0, K // 2, 4000).astype(np.int32)  # partial overlap
    av = rng.randint(1, 5, 4000).astype(np.int32)
    bv = rng.randint(1, 5, 4000).astype(np.int32)
    ps, _, got = run_both(mesh1, lambda bs, mod: bs.JoinAggregate(
        bs.Const(8, ak, av), bs.Const(8, bk, bv), add, add, dense_keys=K))
    assert ps.frame_combiners[0].dense_keys == K
    assert rows_dict(got) == join_oracle(ak, av, bk, bv)


def test_dense_join_matches_sort_join(mesh1):
    rng = np.random.RandomState(9)
    K = 256
    ak = rng.randint(0, K, 3000).astype(np.int32)
    bk = rng.randint(0, K, 3000).astype(np.int32)
    ones = np.ones(3000, np.int32)
    _, _, jd = run_both(mesh1, lambda bs, mod: bs.JoinAggregate(
        bs.Const(1, ak, ones), bs.Const(1, bk, ones), add, add,
        dense_keys=K))
    _, _, js = run_both(mesh1, lambda bs, mod: bs.JoinAggregate(
        bs.Const(1, ak, ones), bs.Const(1, bk, ones), add, add))
    assert rows_dict(jd) == rows_dict(js)


def test_dense_join_single_device(mesh1, dense_calls):
    """One shard a device: the dense join engages."""
    rng = np.random.RandomState(10)
    K = 100
    ak = rng.randint(0, K, 1000).astype(np.int32)
    bk = rng.randint(0, K, 1000).astype(np.int32)
    av = rng.randint(1, 3, 1000).astype(np.int32)
    bv = rng.randint(1, 3, 1000).astype(np.int32)
    _, _, got = run_both(mesh1, lambda bs, mod: bs.JoinAggregate(
        bs.Const(1, ak, av), bs.Const(1, bk, bv), add, add, dense_keys=K))
    assert rows_dict(got) == join_oracle(ak, av, bk, bv)
    assert dense_calls["join"] == 1


def test_dense_join_then_narrower_shard_count_no_cache_collision(
        mesh1, dense_calls):
    """The same fn objects and bound at two shard counts: one takes the
    dense join, the other the sort join, both right."""
    rng = np.random.RandomState(11)
    K = 64
    ak = rng.randint(0, K, 512).astype(np.int32)
    bk = rng.randint(0, K, 512).astype(np.int32)
    ones = np.ones(512, np.int32)
    want = join_oracle(ak, ones, bk, ones)
    for shards in (1, 4):
        _, _, got = run_both(mesh1, lambda bs, mod: bs.JoinAggregate(
            bs.Const(shards, ak, ones), bs.Const(shards, bk, ones), add,
            add, dense_keys=K))
        assert rows_dict(got) == want
    assert dense_calls["join"] == 1


def test_dense_vector_value_columns(mesh1):
    """Vector value columns scatter whole rows (the kmeans shape)."""
    rng = np.random.RandomState(12)
    K, d = 16, 8
    keys = rng.randint(0, K, 2000).astype(np.int32)
    vecs = rng.randn(2000, d).astype(np.float32)
    w = np.ones(2000, np.float32)

    def build(bs, mod):
        return bs.Reduce(bs.Const(8, keys, vecs, w),
                         lambda a, b: (a[0] + b[0], a[1] + b[1]),
                         dense_keys=K)

    ps, _, got = run_both(mesh1, build)
    assert ps.frame_combiner.dense_keys == K
    for sh in got:
        for k, v, c in zip(*sh):
            sel = keys == k
            assert c == sel.sum()
            np.testing.assert_allclose(v, vecs[sel].sum(0), rtol=1e-4,
                                       atol=1e-4)


# -------------------------------------------------------------- dense fold


def test_dense_fold_max_matches_oracle(mesh1, dense_calls):
    rng = np.random.RandomState(13)
    K = 100
    keys = rng.randint(0, K, 3000).astype(np.int32)
    vals = rng.randint(-1000, 1000, 3000).astype(np.int32)
    ps, _, got = run_both(mesh1, lambda bs, mod: bs.Fold(
        bs.Const(8, keys, vals), lambda acc, v: mod.maximum(acc, v),
        init=-50, dense_keys=K))
    assert ps.dense_op == "max"
    want = {int(k): max(int(vals[keys == k].max()), -50)
            for k in np.unique(keys)}
    assert {k: v[0] for k, v in rows_dict(got).items()} == want
    assert dense_calls["fold"] >= 1


def test_dense_fold_add_with_wider_acc(mesh1):
    rng = np.random.RandomState(14)
    K = 64
    keys = rng.randint(0, K, 2000).astype(np.int32)
    vals = rng.randint(0, 100, 2000).astype(np.int32)
    ps, _, got = run_both(mesh1, lambda bs, mod: bs.Fold(
        bs.Const(8, keys, vals), lambda acc, v: acc + v, init=7,
        out_value=np.int32, dense_keys=K))
    assert ps.dense_op == "add"
    want = {int(k): int(vals[keys == k].sum()) + 7 for k in np.unique(keys)}
    assert {k: v[0] for k, v in rows_dict(got).items()} == want


def test_nonassociative_fold_keeps_scan_path(mesh1):
    def build(bs, mod):
        return bs.Fold(bs.Const(4, np.zeros(10, np.int32),
                                np.ones(10, np.int32)),
                       lambda acc, v: acc * 2 + v, init=0, dense_keys=5)

    ps, rs, got = run_both(mesh1, build)
    assert ps.dense_keys is None is rs.dense_keys
    assert rows_dict(got) == {0: (1023,)}


def test_out_of_range_fails_even_when_heuristic_reverts(mesh1):
    """A tiny input under a large declared K keeps the fold on the scan
    path (K > 2 x rows), and the violation still fails the run."""
    keys = np.array([0, 1, 5000], dtype=np.int32)
    _raises_range(mesh1, lambda bs, mod: bs.Fold(
        bs.Const(1, keys, np.ones(3, np.int32)),
        lambda acc, v: mod.maximum(acc, v), init=0, dense_keys=4000))


# ------------------------------------------------- C3.4: float vectors


@pytest.mark.parametrize("declared", [False, True])
def test_float_vector_value_reduce_within_rounding(mesh1, declared,
                                                   monkeypatch):
    """A float32 vector-value Reduce (G = 4), formerly C3.4's pin.
    Undeclared and with discovery off, both packages take the hash
    lowering, whose table scatters the [4] rows whole: the port's K2
    wrapper carries them and no op goes to the sort path; the sums agree
    within rounding. Declared, both take the dense table."""
    from bigslice_tpu_torch.parallel import cuda_kernels

    calls = []
    real = cuda_kernels.hash_aggregate

    def counted(valid, key_cols, val_cols, *args):
        calls.append(tuple(tuple(v.shape[1:]) for v in val_cols))
        return real(valid, key_cols, val_cols, *args)

    monkeypatch.setattr(cuda_kernels, "hash_aggregate", counted)
    rng = np.random.RandomState(15)
    K = 50
    keys = rng.randint(0, K, 3000).astype(np.int32)
    vecs = rng.randn(3000, 4).astype(np.float32)
    kw = {} if declared else dict(auto_dense=False)
    extra = dict(dense_keys=K) if declared else {}
    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    ref = Session(executor=MeshExecutor(mesh1, hash_aggregate=True, **kw))
    want = bst.result_shard_rows(ref.run(ref_bs.Reduce(
        ref_bs.Const(4, keys, vecs), add, **extra)))
    port = _port_session(**kw)
    r = bst.Reduce(bst.Const(4, keys, vecs), add, **extra)
    got = bst.result_shard_rows(port.run(r))
    assert_same_shards(got, want)
    for sh in got:
        for k, v in zip(*sh):
            np.testing.assert_allclose(v, vecs[keys == k].sum(0),
                                       rtol=RTOL, atol=1e-4)
    if declared:
        assert r.frame_combiner.dense_ops == ("add",)
        assert calls == []
    else:
        assert r.frame_combiner.hash_ops() == ("add",)
        assert ((4,),) in calls
        assert port.executor.hash_off == frozenset()


# ------------------------------------------------- the standalone classes


def _ref_sharded(mesh1, cols, cap):
    from bigslice_tpu.parallel import shuffle as ref_shuffle

    return ref_shuffle.shard_columns(mesh1, [[c] for c in cols],
                                     [len(cols[0])], cap)


def _ref_rows(cols, counts, capacity):
    from bigslice_tpu.parallel import shuffle as ref_shuffle

    chunks = ref_shuffle.unshard_columns(cols, np.asarray(counts), capacity)
    return sorted(zip(*[c[0].tolist() for c in chunks]))


def _port_rows(cols, n):
    n = int(n[0])
    return sorted(zip(*[c[:n].tolist() for c in cols]))


def _standalone_input(seed, n=300, cap=512, span=60):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, span, n).astype(np.int32),
            rng.randint(1, 10, n).astype(np.int32), cap)


def _port_cols(cols, cap):
    out = []
    for c in cols:
        buf = np.zeros(cap, c.dtype)
        buf[:len(c)] = c
        out.append(torch.from_numpy(buf))
    return out, torch.tensor([len(cols[0])], dtype=torch.int32)


def test_mesh_shuffle_matches_jax(mesh1):
    from bigslice_tpu.parallel import shuffle as ref_shuffle
    from bigslice_tpu_torch.parallel import shuffle

    keys, vals, cap = _standalone_input(0)
    sh = shuffle.MeshShuffle(2, 1, cap, device="cpu")
    pc, pn = _port_cols([keys, vals], cap)
    out, n, ov = sh(pc, pn)
    rsh = ref_shuffle.MeshShuffle(mesh1, ncols=2, nkeys=1, capacity=cap)
    rc, rn = _ref_sharded(mesh1, [keys, vals], cap)
    rout, rnn, rov = rsh(rc, rn)
    assert sh.out_capacity == rsh.out_capacity
    assert int(ov) == int(rov) == 0
    assert _port_rows(out, n) == _ref_rows(rout, rnn, rsh.out_capacity) == \
        sorted(zip(keys.tolist(), vals.tolist()))


def test_mesh_reduce_by_key_matches_jax(mesh1):
    from bigslice_tpu.parallel import shuffle as ref_shuffle
    from bigslice_tpu_torch.parallel import shuffle

    keys, vals, cap = _standalone_input(1, span=37)
    red = shuffle.MeshReduceByKey(1, 1, cap, add, device="cpu")
    pc, pn = _port_cols([keys, vals], cap)
    k, v, n, ov = red([pc[0]], [pc[1]], pn)
    rred = ref_shuffle.MeshReduceByKey(mesh1, nkeys=1, nvals=1, capacity=cap,
                                       combine_fn=add)
    rc, rn = _ref_sharded(mesh1, [keys, vals], cap)
    rk, rv, rnn, rov = rred([rc[0]], [rc[1]], rn)
    assert int(ov) == int(rov) == 0
    got = _port_rows(k + v, n)
    assert got == _ref_rows(rk + rv, rnn, rred.out_capacity)
    assert dict(got) == oracle(keys, vals, "add")


def test_hash_reduce_kernel_matches_sort_kernel(mesh1):
    """tests/test_wave_pipeline.py's case: the standalone sortless kernel
    agrees with the sort kernel, the numpy oracle and the JAX package's
    MeshHashReduceByKey."""
    from bigslice_tpu.parallel import hashagg as ref_hashagg
    from bigslice_tpu_torch.parallel import hashagg, shuffle

    rng = np.random.RandomState(19)
    per = 256
    keys = rng.randint(0, 100, per).astype(np.int32)
    vals = rng.randint(1, 10, per).astype(np.int32)
    pc, pn = _port_cols([keys, vals], per)
    hashed = hashagg.MeshHashReduceByKey(1, 1, per, ["add"], device="cpu")
    hk, hv, hn, hov = hashed([pc[0]], [pc[1]], pn)
    sk, sv, sn, sov = shuffle.MeshReduceByKey(1, 1, per, add, device="cpu")(
        [pc[0]], [pc[1]], pn)
    assert int(hov) == int(sov) == 0
    got = _port_rows(hk + hv, hn)
    assert got == _port_rows(sk + sv, sn) == sorted(
        oracle(keys, vals, "add").items())
    rhashed = ref_hashagg.MeshHashReduceByKey(mesh1, nkeys=1, nvals=1,
                                              capacity=per, ops=["add"])
    rc, rn = _ref_sharded(mesh1, [keys, vals], per)
    rk, rv, rnn, rov = rhashed([rc[0]], [rc[1]], rn)
    assert hashed.out_capacity == rhashed.out_capacity and int(rov) == 0
    assert got == _ref_rows(rk + rv, rnn, rhashed.out_capacity)


@pytest.mark.parametrize("case", ["overlap", "disjoint"])
def test_mesh_join_aggregate_matches_jax(mesh1, case):
    from bigslice_tpu.parallel import join as ref_join
    from bigslice_tpu_torch.parallel import join

    rng = np.random.RandomState(0)
    cap = 512
    if case == "overlap":
        a = rng.randint(0, 60, 300).astype(np.int32)
        b = rng.randint(30, 90, 300).astype(np.int32)
    else:
        a = np.arange(0, 128, dtype=np.int32)
        b = np.arange(1000, 1128, dtype=np.int32)
    ones = np.ones(300, np.int32)
    j = join.MeshJoinAggregate(cap, add, add, device="cpu")
    ac, an = _port_cols([a, ones[:len(a)]], cap)
    bc, bn = _port_cols([b, ones[:len(b)]], cap)
    keys, av, bv, n, ov = j(ac, an, bc, bn)
    rj = ref_join.MeshJoinAggregate(mesh1, cap, add, add)
    rac, ran = _ref_sharded(mesh1, [a, ones[:len(a)]], cap)
    rbc, rbn = _ref_sharded(mesh1, [b, ones[:len(b)]], cap)
    rk, rav, rbv, rn, rov = rj(rac, ran, rbc, rbn)
    assert int(ov) == int(rov) == 0
    got = _port_rows([keys, av, bv], n)
    assert got == _ref_rows([rk, rav, rbv], rn, rj.out_capacity)
    want = join.join_count_oracle(a.tolist(), b.tolist())
    assert want == ref_join.join_count_oracle(a.tolist(), b.tolist())
    assert {k: (x, y) for k, x, y in got} == want
    assert (len(want) == 0) == (case == "disjoint")
