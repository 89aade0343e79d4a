"""The port's Fold against the JAX package's.

The same seeded numpy inputs go through the JAX package's Fold (its
``MeshExecutor`` on 8 virtual CPU devices with ``auto_dense=False``, and
its ``LocalExecutor``) and the port's (``MeshExecutor(device="cpu")``
and ``LocalExecutor(device="cpu")``), shard by shard. Integer
accumulators match bit for bit, the order-sensitive ``acc * 31 + v``
included (the same rows fold in the same order: source shard, then
row); float32 ones within ``rtol=1e-5, atol=1e-6``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.parallel import segment as ref_segment  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.parallel import segment  # noqa: E402
from bigslice_tpu_torch.typecheck import TypecheckError  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def poly(acc, v):
    """Order-sensitive, wraps in int32, not associative."""
    return acc * 31 + v


def halve(acc, v):
    return acc * 0.5 + v


def add(acc, v):
    return acc + v


@pytest.fixture(scope="module")
def ref_sessions():
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    mesh = Mesh(np.array(jax.devices()[:8]), ("shards",))
    return {"mesh": Session(executor=MeshExecutor(mesh, auto_dense=False)),
            "local": Session()}


def _port_session(kind):
    ex = (bst.MeshExecutor(device="cpu") if kind == "mesh"
          else bst.LocalExecutor(device="cpu"))
    return bst.Session(executor=ex)


def assert_same_shards(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [c.dtype for c in g] == [c.dtype for c in w]
        for gc, wc in zip(g, w):
            if gc.dtype.kind == "f":
                np.testing.assert_allclose(gc, wc, rtol=RTOL, atol=ATOL)
            else:
                np.testing.assert_array_equal(gc, wc)


def _run_both(ref_sessions, kind, build):
    """``build(bs)`` through both packages on executor ``kind``: the
    port's shards, held against the JAX package's."""
    want = bst.result_shard_rows(ref_sessions[kind].run(build(ref_bs)))
    got = bst.result_shard_rows(_port_session(kind).run(build(bst)))
    assert_same_shards(got, want)
    return got


def _numpy_fold(keys, vals, fn, init, dtype):
    """Each key's fold over its rows in input order."""
    acc = {}
    with np.errstate(over="ignore"):
        for k, v in zip(keys.tolist(), vals):
            acc[k] = dtype(fn(acc.get(k, dtype(init)), v))
    return acc


def _input(n, span, seed, dtype=np.int32):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, span, n).astype(np.int32)
    if dtype == np.float32:
        vals = rng.randn(n).astype(np.float32)
    else:
        vals = rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32)
    return keys, vals


# -- the fold core against the JAX package's -----------------------------


@pytest.mark.parametrize("nkeys", [1, 2])
@pytest.mark.parametrize("fn,dtype", [(poly, np.int32),
                                      (halve, np.float32)])
def test_sequential_fold_core_matches_reference(nkeys, fn, dtype):
    """The mask-chained core: the same survivors in the same sorted
    positions, the same keys, and each group's fold at its last row."""
    rng = np.random.RandomState(nkeys)
    n = 700
    keys = [rng.randint(0, 40, n).astype(np.int32) for _ in range(nkeys)]
    _, vals = _input(n, 1, nkeys, dtype)
    valid = rng.rand(n) < 0.8
    ref = ref_segment.make_sequential_fold_masked(nkeys, 1, fn, 7, dtype)
    r_keep, r_keys, (r_acc,) = ref(valid, tuple(keys), (vals,))
    core = segment.make_sequential_fold_masked(
        nkeys, 1, fn, 7, torch.from_numpy(np.zeros(0, dtype)).dtype)
    keep, s_keys, (acc,) = core(torch.from_numpy(valid),
                                tuple(map(torch.from_numpy, keys)),
                                (torch.from_numpy(vals),))
    r_keep = np.asarray(r_keep)
    np.testing.assert_array_equal(keep.numpy(), r_keep)
    for k, rk in zip(s_keys, r_keys):
        np.testing.assert_array_equal(k.numpy()[r_keep],
                                      np.asarray(rk)[r_keep])
    got, want = acc.numpy()[r_keep], np.asarray(r_acc)[r_keep]
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)


def test_fold_steps_are_the_longest_group():
    """One step a rank: a fold of groups of 1, 3 and 9 rows takes 9
    steps; an empty or all-invalid input takes none."""
    keys = np.repeat(np.array([5, 2, 8], np.int32), [1, 3, 9])
    vals = np.arange(len(keys), dtype=np.int32)
    kern = segment.DeviceSortedFold(poly, 1, 1, 0, torch.int32)
    segment.reset_fold_steps()
    got_k, (got_a,) = kern([torch.from_numpy(keys)],
                           [torch.from_numpy(vals)], len(keys))
    assert segment.FOLD_STEPS == {"steps": 9, "longest": 9, "folds": 1}
    want = _numpy_fold(keys, vals.tolist(), poly, 0, np.int32)
    assert dict(zip(got_k[0].tolist(), got_a.tolist())) == {
        k: int(v) for k, v in want.items()}
    core = segment.make_sequential_fold_masked(1, 1, poly, 0, torch.int32)
    for n, valid in ((0, False), (5, False)):
        segment.reset_fold_steps()
        keep, _, _ = core(torch.full((n,), valid),
                          (torch.zeros(n, dtype=torch.int32),),
                          (torch.zeros(n, dtype=torch.int32),))
        assert not bool(keep.any())
        assert segment.FOLD_STEPS["steps"] == 0


# -- Fold through both packages, both executors ----------------------------


@pytest.mark.parametrize("kind", ["mesh", "local"])
@pytest.mark.parametrize("fn,init,dtype", [(poly, 7, np.int32),
                                           (add, 0, np.int32),
                                           (halve, 0.0, np.float32)])
def test_fold_matches_reference(ref_sessions, kind, fn, init, dtype):
    keys, vals = _input(3000, 200, 3, dtype)

    def build(bs):
        return bs.Fold(bs.Const(4, keys, vals), fn, init=init)

    segment.reset_fold_steps()
    got = _run_both(ref_sessions, kind, build)
    want = _numpy_fold(keys, vals.tolist(), fn, init, dtype)
    rows = {int(k): a for s in got for k, a in zip(*s)}
    assert rows.keys() == want.keys()
    if dtype == np.int32:
        assert all(int(rows[k]) == int(want[k]) for k in want)
    # Each shard folds in as many steps as its longest group.
    assert segment.FOLD_STEPS["folds"] == 4
    assert segment.FOLD_STEPS["steps"] == sum(
        int(np.bincount(keys[np.isin(keys, s[0])]).max()) for s in got
        if len(s[0]))


@pytest.mark.parametrize("kind", ["mesh", "local"])
def test_fold_executor_parity_case(ref_sessions, kind):
    """tests/test_executor_parity.py's "fold" pipeline."""
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 23, 1000).astype(np.int32)
    vals = rng.randint(-50, 50, 1000).astype(np.int32)
    _run_both(ref_sessions, kind, lambda bs: bs.Fold(
        bs.Const(8, keys, vals), add, init=0, out_value=np.int32))


@pytest.mark.parametrize("kind", ["mesh", "local"])
def test_fold_in_a_chain(ref_sessions, kind):
    """A Filter before the Fold (its input's mask), two key columns and
    two value columns, a float accumulator of int values, and a Map and
    a Reduce after it (the fold's mask-chained output feeding a stage
    and a shuffle)."""
    rng = np.random.RandomState(5)
    n = 2500
    k1 = rng.randint(0, 30, n).astype(np.int32)
    k2 = rng.randint(0, 4, n).astype(np.int32)
    v1 = rng.randint(-9, 9, n).astype(np.int32)
    v2 = rng.randint(0, 5, n).astype(np.int32)

    def build(bs):
        s = bs.Prefixed(bs.Const(4, k1, k2, v1, v2), 2)
        s = bs.Filter(s, lambda a, b, x, y: y > 0)
        f = bs.Fold(s, lambda acc, x, y: acc * 0.75 + x * y, init=1.0,
                    out_value=np.float32)
        m = bs.Map(f, lambda a, b, acc: (a, acc * 2))
        return bs.Reduce(m, lambda x, y: x + y)

    _run_both(ref_sessions, kind, build)


@pytest.mark.parametrize("kind", ["mesh", "local"])
def test_fold_float_keys_and_empty_shards(ref_sessions, kind):
    """Float keys with -0.0 and +0.0 (one key), and three keys over
    eight shards (most shards empty)."""
    keys = np.array([0.0, -0.0, 1.5, 0.0, 1.5, -2.25] * 50, np.float32)
    vals = np.arange(len(keys), dtype=np.int32)
    _run_both(ref_sessions, kind,
              lambda bs: bs.Fold(bs.Const(8, keys, vals), poly, init=3))


@pytest.mark.parametrize("kind", ["mesh", "local"])
def test_fold_hot_key(ref_sessions, kind):
    """One key holds most rows: as many steps as its group."""
    keys, vals = _input(2000, 64, 9)
    keys = np.concatenate([keys, np.zeros(600, np.int32)])
    vals = np.concatenate([vals, np.arange(600, dtype=np.int32)])
    segment.reset_fold_steps()
    _run_both(ref_sessions, kind,
              lambda bs: bs.Fold(bs.Const(4, keys, vals), poly, init=1))
    assert segment.FOLD_STEPS["longest"] == int(np.bincount(keys).max())


def test_fold_host_tier_on_the_local_executor(ref_sessions):
    """tests/test_slice.py's test_fold: str keys take the host tier."""
    keys = ["a", "b", "a", "c", "b", "a"]
    vals = np.array([1, 2, 3, 4, 5, 6], dtype=np.int32)

    def build(bs):
        return bs.Fold(bs.Const(3, keys, vals), add, init=0,
                       out_value=np.int32)

    assert not build(bst).device
    got = _run_both(ref_sessions, "local", build)
    assert sorted((k, int(a)) for s in got for k, a in zip(*s)) == [
        ("a", 10), ("b", 7), ("c", 4)]


def test_fold_nonassociative_host_tier(ref_sessions):
    """tests/test_slice.py's test_fold_nonassociative: a mutable
    accumulator (a callable init) builds each key's list."""
    keys = np.array([1, 1, 2], dtype=np.int32)
    vals = np.array([10, 20, 30], dtype=np.int32)

    def build(bs):
        return bs.Fold(bs.Const(2, keys, vals), lambda acc, v: acc + [v],
                       init=list, out_value=object)

    f = build(bst)
    assert not f.device
    want = ref_sessions["local"].run(build(ref_bs)).rows()
    got = _port_session("local").run(f).rows()
    assert sorted((k, v) for k, v in got) == sorted((k, v) for k, v in want)
    assert sorted((k, v) for k, v in got) == [(1, [10, 20]), (2, [30])]


def test_dense_keys_fold_runs_on_the_local_executor(ref_sessions):
    """The local executor ignores ``dense_keys=``, as the JAX package's
    host path does."""
    keys, vals = _input(1000, 16, 4)
    _run_both(ref_sessions, "local", lambda bs: bs.Fold(
        bs.Const(4, keys, vals), add, init=0, dense_keys=16))


def test_device_executor_refuses_host_and_dense_folds_by_name():
    """A host-tier Fold (a callable init, a list accumulator) runs on the
    device executor's host tier; a dense Fold (``dense_keys=``, a
    classified fn) on the device path, its table folded with the init;
    both equal the JAX package's one-device MeshExecutor, and a fn that
    does not classify ignores the declaration."""
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    ref = Session(executor=MeshExecutor(
        Mesh(np.array(jax.devices()[:1]), ("shards",))))
    keys, vals = _input(64, 8, 1)
    host = bst.Fold(bst.Const(2, keys, vals),
                    lambda acc, v: acc + [int(v)], init=list,
                    out_value=object)
    assert not host.device
    got = sorted((int(k), sorted(a)) for k, a in
                 _port_session("mesh").run(host).rows())
    want = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        want.setdefault(k, []).append(v)
    assert got == sorted((k, sorted(v)) for k, v in want.items())
    keys, vals = _input(2000, 40, 2)
    for shards in (1, 4):
        def build(bs):
            mod = torch if bs is bst else __import__("jax").numpy
            return bs.Fold(bs.Const(shards, keys, vals),
                           lambda acc, v: mod.maximum(acc, v), init=-3,
                           dense_keys=40)

        f = build(bst)
        assert f.dense_keys == 40 and f.dense_op == "max"
        assert_same_shards(
            bst.result_shard_rows(_port_session("mesh").run(f)),
            bst.result_shard_rows(ref.run(build(ref_bs))))
    assert bst.Fold(bst.Const(2, keys, vals), poly, init=7,
                    dense_keys=40).dense_keys is None


def test_fold_typechecks_and_schema():
    src = bst.Const(2, np.arange(4, dtype=np.int32), np.ones(4, np.float32))
    f = bst.Fold(src, add)
    assert f.device and f.schema == src.schema and f.acc_dtype == np.float32
    assert f.deps()[0].shuffle and not f.deps()[0].expand
    g = bst.Fold(src, lambda acc, v: acc + (v > 0), out_value=np.int32)
    assert g.device and g.acc_dtype == np.int32
    nokey = bst.Const(2, np.arange(4, dtype=np.int32))
    with pytest.raises(TypecheckError, match="must have value columns"):
        bst.Fold(nokey, add)
    nokey.schema = bst.Schema(list(nokey.schema), prefix=0)
    with pytest.raises(TypecheckError, match="must have a key prefix"):
        bst.Fold(nokey, add)
    vec = bst.Const(2, np.zeros((4, 3), np.int32), np.ones(4, np.int32))
    with pytest.raises(TypecheckError, match="not partitionable"):
        bst.Fold(vec, add)

