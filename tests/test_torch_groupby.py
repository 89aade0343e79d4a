"""GroupByKey in the port against the JAX package.

The grouping core ``make_group_by_key_masked`` against the JAX
function on the same masked inputs: head mask, keys, [G] groups and
counts equal, row for row. Whole GroupByKeys through the port's device
executor (on the CPU) against the JAX package's MeshExecutor, per
output shard, every column exact — the [G] group vectors included.

Which values a group keeps: both packages keep a group's first G
values in arrival order after the shuffle. The JAX package's 8-device
mesh delivers a consumer's rows ordered by source device, which with
S <= 8 shards is the source shard; the port's single lane delivers
them ordered by source wave, which is also the source shard. So the
groups are compared exactly, truncated groups too, against the
8-device mesh and against a one-device mesh, where the JAX package
streams S waves as the port does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.parallel import groupby as ref_groupby  # noqa: E402
import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.exec.task import TaskError  # noqa: E402
from bigslice_tpu_torch.parallel import groupby as port_groupby  # noqa: E402


def _ref_session(ndev):
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    mesh = Mesh(np.array(jax.devices()[:ndev]), ("shards",))
    return Session(executor=MeshExecutor(mesh, auto_dense=False,
                                         hash_aggregate=True))


@pytest.fixture(scope="module", params=[8, 1], ids=["mesh8", "mesh1"])
def ref_session(request):
    return _ref_session(request.param)


def _port_session():
    return bst.Session(executor=bst.MeshExecutor(device="cpu"))


def _same_shards(port_res, ref_res):
    got = bst.result_shard_rows(port_res)
    want = bst.result_shard_rows(ref_res)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [(c.dtype, c.shape[1:]) for c in g] == \
            [(c.dtype, c.shape[1:]) for c in w]
        for gc, wc in zip(g, w):
            np.testing.assert_array_equal(gc, wc)
    return got


def _run_both(ref_session, build):
    sess = _port_session()
    return sess, _same_shards(sess.run(build(bst)),
                              ref_session.run(build(ref_bs)))


def _oracle(keys, vals):
    out = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        out.setdefault(k, []).append(v)
    return out


def _rows(shards):
    return [row for sh in shards for row in zip(*sh)]


# -- the grouping core against the JAX function ---------------------------


@pytest.mark.parametrize("case", ["int", "multikey", "float_vals", "uint",
                                  "capacity1"])
def test_group_by_key_core_matches_reference(case):
    import jax.numpy as jnp

    rng = np.random.RandomState(sum(map(ord, case)))
    n, G = 500, 8
    keys = [rng.randint(0, 60, n).astype(np.int32)]
    val = rng.randint(-1000, 1000, n).astype(np.int32)
    if case == "multikey":
        keys = [keys[0] % 20, rng.randint(0, 3, n).astype(np.int32)]
    elif case == "float_vals":
        val = rng.randn(n).astype(np.float32)
        val[::17] = -0.0
    elif case == "uint":
        val = val.view(np.uint32)
    elif case == "capacity1":
        G = 1
    mask = rng.rand(n) < 0.9
    rh, rk, rg, rc = ref_groupby.make_group_by_key_masked(len(keys), G)(
        jnp.asarray(mask), tuple(map(jnp.asarray, keys)), jnp.asarray(val))
    t = torch.from_numpy
    h, k, g, c = port_groupby.make_group_by_key_masked(len(keys), G)(
        t(mask), tuple(map(t, keys)), t(val))
    rh = np.asarray(rh)
    np.testing.assert_array_equal(h.numpy(), rh)
    assert rh.sum() > 0 and (np.asarray(rc) > G).any()
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    assert g.dtype == t(val).dtype and tuple(g.shape) == (n, G)
    gv, rgv = g.numpy(), np.asarray(rg)
    if gv.dtype.kind == "f":
        gv, rgv = gv.view(np.int32), rgv.view(np.int32)
    np.testing.assert_array_equal(gv, rgv)
    for kc, rkc in zip(k, rk):
        np.testing.assert_array_equal(kc.numpy()[rh], np.asarray(rkc)[rh])


def test_group_by_key_core_empty():
    core = port_groupby.make_group_by_key_masked(1, 4)
    e = torch.zeros(0, dtype=torch.int32)
    h, (k,), g, c = core(torch.zeros(0, dtype=torch.bool), (e,), e)
    assert h.shape == (0,) and k.shape == (0,) and tuple(g.shape) == (0, 4)
    assert c.shape == (0,)


# -- whole GroupByKeys through the executor -------------------------------


def test_groupby_basic(ref_session):
    keys = np.array([3, 1, 3, 2, 1, 3], np.int32)
    vals = np.array([30, 10, 31, 20, 11, 32], np.int32)
    _, got = _run_both(ref_session, lambda bs: bs.GroupByKey(
        bs.Const(2, keys, vals), capacity=4))
    oracle = _oracle(keys, vals)
    rows = _rows(got)
    assert sorted(int(k) for k, _, _ in rows) == sorted(oracle)
    for k, grp, cnt in rows:
        assert cnt == len(oracle[int(k)])
        assert sorted(grp[:cnt].tolist()) == sorted(oracle[int(k)])
        assert not grp[cnt:].any()


@pytest.mark.parametrize("S", [2, 4])
def test_groupby_overflow_visible(ref_session, S):
    """One key with 10 values, capacity 4: the count stays 10, and the
    first 4 values in arrival order are kept — the same 4 in both
    packages."""
    keys = np.zeros(10, np.int32)
    vals = np.arange(10, dtype=np.int32)
    _, got = _run_both(ref_session, lambda bs: bs.GroupByKey(
        bs.Const(S, keys, vals), capacity=4))
    ((k, grp, cnt),) = _rows(got)
    assert int(cnt) == 10 and grp.shape == (4,)
    assert set(grp.tolist()) <= set(range(10))


@pytest.mark.parametrize("S", [1, 4, 8])
def test_groupby_random_truncated(ref_session, S):
    """Groups of 1 to about 30 at capacity 16: many truncated. Every
    column equal to the JAX package's, the kept values included."""
    rng = np.random.RandomState(S)
    n = 1200
    keys = rng.randint(0, 80, n).astype(np.int32)
    vals = rng.randint(0, 1000, n).astype(np.int32)
    _, got = _run_both(ref_session, lambda bs: bs.GroupByKey(
        bs.Const(S, keys, vals), capacity=16))
    oracle = _oracle(keys, vals)
    rows = _rows(got)
    assert len(rows) == len(oracle)
    assert any(int(c) > 16 for _, _, c in rows)
    for k, grp, cnt in rows:
        want = oracle[int(k)]
        assert cnt == len(want)
        kept = grp[: min(cnt, 16)].tolist()
        assert len(kept) == min(len(want), 16)
        assert set(kept) <= set(want)


def test_groupby_strict_overflow_raises():
    keys = np.zeros(40, np.int32)
    vals = np.arange(40, dtype=np.int32)
    g = bst.GroupByKey(bst.Const(2, keys, vals), capacity=4,
                       on_overflow="error")
    with pytest.raises(TaskError) as ei:
        _port_session().run(g)
    cause = ei.value.cause
    assert isinstance(cause, ValueError)
    assert "exceed the declared capacity" in str(cause)
    assert "on_overflow='error'" in str(cause)


def test_groupby_strict_within_capacity_runs(ref_session):
    keys = np.arange(40, dtype=np.int32) % 10
    vals = np.arange(40, dtype=np.int32)
    _run_both(ref_session, lambda bs: bs.GroupByKey(
        bs.Const(2, keys, vals), capacity=4, on_overflow="error"))


def test_groupby_empty_input(ref_session):
    e = np.zeros(0, np.int32)
    _, got = _run_both(ref_session, lambda bs: bs.GroupByKey(
        bs.Const(4, e, e), capacity=8))
    assert all(len(sh[0]) == 0 for sh in got)
    assert all(sh[1].shape == (0, 8) for sh in got)


def test_map_after_groupby(ref_session):
    """A device Map receives each row's [G] group vector under vmap
    (tests/test_groupby.py::test_groupby_on_mesh's shape)."""
    rng = np.random.RandomState(19)
    keys = rng.randint(0, 25, 400).astype(np.int32)
    vals = rng.randint(1, 100, 400).astype(np.int32)

    def build(bs):
        g = bs.GroupByKey(bs.Const(8, keys, vals), capacity=32)
        if bs is bst:
            return bs.Map(g, lambda k, grp, cnt: (k, grp.sum(), cnt))
        import jax.numpy as jnp

        return bs.Map(g, lambda k, grp, cnt: (k, jnp.sum(grp), cnt))

    _, got = _run_both(ref_session, build)
    sums, cnts = {}, {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        sums[k] = sums.get(k, 0) + v
        cnts[k] = cnts.get(k, 0) + 1
    assert {int(k): (int(s), int(c)) for k, s, c in _rows(got)} == \
        {k: (sums[k], cnts[k]) for k in sums}


def test_reduce_after_groupby_takes_vector_values(ref_session):
    """Vector columns through a shuffle and a combiner: regroup by
    k % 3 and add the [G] vectors elementwise (the hash lowering, whose
    table scatters the [G] rows whole, in both packages)."""
    rng = np.random.RandomState(7)
    keys = rng.randint(0, 30, 300).astype(np.int32)
    vals = rng.randint(0, 50, 300).astype(np.int32)

    def build(bs):
        g = bs.GroupByKey(bs.Const(4, keys, vals), capacity=8)
        m = bs.Map(g, lambda k, grp, cnt: (k % 3, grp))
        return bs.Reduce(m, lambda a, b: a + b)

    _, got = _run_both(ref_session, build)
    assert sum(len(sh[0]) for sh in got) == 3


def test_groupby_typechecks():
    from bigslice_tpu_torch.typecheck import TypecheckError

    src = bst.Const(2, np.arange(4, dtype=np.int32), np.ones(4, np.int32))
    with pytest.raises(TypecheckError, match="capacity must be >= 1"):
        bst.GroupByKey(src, capacity=0)
    with pytest.raises(TypecheckError, match="on_overflow must be"):
        bst.GroupByKey(src, capacity=4, on_overflow="drop")
    two = bst.Const(2, np.arange(4, dtype=np.int32), np.ones(4, np.int32),
                    np.ones(4, np.int32))
    with pytest.raises(TypecheckError, match="exactly one value column"):
        bst.GroupByKey(two, capacity=4)
    g = bst.GroupByKey(src, capacity=4)
    assert [str(ct) for ct in g.schema] == ["int32", "int32[4]", "int32"]
    with pytest.raises(TypecheckError, match="must be scalar"):
        bst.GroupByKey(bst.Map(g, lambda k, grp, c: (k, grp)), capacity=2)
