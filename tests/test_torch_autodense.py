"""The port's auto-dense discovery against the JAX package's.

Each case of tests/test_autodense.py has its counterpart: the same
seeded numpy inputs go through the JAX package's ``MeshExecutor`` on a
one-device CPU mesh and the port's ``MeshExecutor(device="cpu")``, both
at ``auto_dense=True`` (the default) unless the case says otherwise.
Every shard's rows are equal, and so are what each executor decided: the
bound on the declarable object (a Reduce's combiner, a Fold), whether
it was discovered, and the op sites whose discovered bound was retracted
(``_auto_dense_off``). On one device a group's first wave holds its
first shard alone, so a bound probed there may miss a later shard's
keys: both executors then retract and rerun the group, which the 8-shard
cases show.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bigslice_tpu as ref_bs  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.exec.task import TaskError  # noqa: E402


@pytest.fixture(scope="module")
def mesh1():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:1]), ("shards",))


def _sessions(mesh1, **kw):
    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    return (bst.Session(executor=bst.MeshExecutor(device="cpu", **kw)),
            Session(executor=MeshExecutor(mesh1, **kw)))


def _decided(obj):
    return (obj.dense_keys, bool(getattr(obj, "_auto_declared", False)))


def run_both(mesh1, build, target=lambda s: s.frame_combiner, sessions=None,
             **kw):
    """``build(bs, mod)`` through both packages: equal shards, equal
    decisions on ``target(slice)`` and equal retracted sites. Returns
    (port rows, port decision, port retracted sites)."""
    port, ref = sessions or _sessions(mesh1, **kw)
    ps, rs = build(bst, torch), build(ref_bs, jnp)
    got = bst.result_shard_rows(port.run(ps))
    want = bst.result_shard_rows(ref.run(rs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            np.testing.assert_array_equal(gc, wc)
    assert _decided(target(ps)) == _decided(target(rs))
    off = port.executor.auto_dense_off
    assert off == frozenset(ref.executor._auto_dense_off)
    rows = {int(k): int(v) for sh in got for k, v in zip(*sh)}
    return rows, _decided(target(ps)), off


def oracle_sum(keys, vals):
    out = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        out[k] = out.get(k, 0) + v
    return out


def add(a, b):
    return a + b


@pytest.mark.parametrize("wave0", ["holds-max", "misses-max"])
def test_undeclared_reduce_discovers_dense(mesh1, wave0):
    """Wave 0 (shard 0) holding the largest key declares its bound for
    good; missing it, the bound is retracted by a later wave and both
    sites (producer and consumer) stay off."""
    rng = np.random.RandomState(7)
    keys = rng.randint(0, 400, 6000).astype(np.int32)
    vals = rng.randint(-50, 50, 6000).astype(np.int32)
    if wave0 == "holds-max":
        keys[0] = 399
    else:
        keys[:750][keys[:750] == 399] = 398
    rows, decided, off = run_both(mesh1, lambda bs, mod: bs.Reduce(
        bs.Const(8, keys, vals), add))
    assert rows == oracle_sum(keys, vals)
    if wave0 == "holds-max":
        assert decided == (400, True) and not off
    else:
        assert decided == (None, False) and len(off) == 2


def test_single_shard_reduce_discovers_at_the_consumer(mesh1):
    """One shard: the producer has no shuffle stage, so the consumer's
    combine stage probes and declares."""
    rng = np.random.RandomState(8)
    keys = rng.randint(0, 300, 3000).astype(np.int32)
    vals = rng.randint(-5, 5, 3000).astype(np.int32)
    rows, decided, off = run_both(mesh1, lambda bs, mod: bs.Reduce(
        bs.Const(1, keys, vals), add))
    assert rows == oracle_sum(keys, vals)
    assert decided == (int(keys.max()) + 1, True) and not off


def test_auto_dense_disabled_by_option(mesh1):
    rng = np.random.RandomState(8)
    keys = rng.randint(0, 100, 2000).astype(np.int32)
    vals = np.ones(2000, np.int32)
    rows, decided, off = run_both(mesh1, lambda bs, mod: bs.Reduce(
        bs.Const(8, keys, vals), add), auto_dense=False)
    assert rows == oracle_sum(keys, vals)
    assert decided == (None, False) and not off


def test_negative_keys_stay_on_sort_path(mesh1):
    rng = np.random.RandomState(9)
    keys = rng.randint(-50, 50, 2000).astype(np.int32)
    vals = np.ones(2000, np.int32)
    rows, decided, off = run_both(mesh1, lambda bs, mod: bs.Reduce(
        bs.Const(8, keys, vals), add))
    assert rows == oracle_sum(keys, vals)
    assert decided == (None, False) and not off


def test_sparse_keys_stay_on_sort_path(mesh1):
    # Range far beyond 2x capacity: the league guard must refuse.
    keys = (np.arange(2000, dtype=np.int64) * 1_000_000 % (1 << 30)
            ).astype(np.int32)
    vals = np.ones(2000, np.int32)
    rows, decided, off = run_both(mesh1, lambda bs, mod: bs.Reduce(
        bs.Const(8, keys, vals), add))
    assert rows == oracle_sum(keys, vals)
    assert decided == (None, False) and not off


def test_unclassifiable_fn_stays_on_sort_path(mesh1):
    keys = np.arange(100, dtype=np.int32) % 7
    vals = np.full(100, 2, np.int32)
    rows, decided, off = run_both(mesh1, lambda bs, mod: bs.Reduce(
        bs.Const(8, keys, vals), lambda a, b: a * b))
    assert rows == {k: 2 ** int((keys == k).sum()) for k in range(7)}
    assert decided == (None, False) and not off


def test_misprobe_retracts_and_recovers(mesh1):
    """20 shards: wave 0 shows keys in [0, 8); the last shard holds key
    500_000, outside the probed bound. The badrange signal retracts the
    declaration and the group reruns, right, on the sort path."""
    n_shards, per = 20, 64
    rows_n = n_shards * per
    rng = np.random.RandomState(11)
    keys = rng.randint(0, 8, rows_n).astype(np.int32)
    keys[-per:] = 500_000
    vals = np.ones(rows_n, np.int32)
    rows, decided, off = run_both(mesh1, lambda bs, mod: bs.Reduce(
        bs.Const(n_shards, keys, vals), add))
    assert rows == oracle_sum(keys, vals)
    assert decided == (None, False) and len(off) >= 1


def test_blacklisted_site_not_reprobed(mesh1):
    """After a retraction, a rebuilt slice at the same site does not
    declare again."""
    n_shards, per = 20, 64
    rows_n = n_shards * per

    def build(keys, vals):
        return lambda bs, mod: bs.Reduce(bs.Const(n_shards, keys, vals),
                                         add)

    rng = np.random.RandomState(13)
    keys = rng.randint(0, 8, rows_n).astype(np.int32)
    keys[-per:] = 400_000
    vals = np.ones(rows_n, np.int32)
    sessions = _sessions(mesh1)
    rows, decided, off1 = run_both(mesh1, build(keys, vals),
                                   sessions=sessions)
    assert rows == oracle_sum(keys, vals) and decided == (None, False)
    keys2 = rng.randint(0, 8, rows_n).astype(np.int32)
    rows, decided, off2 = run_both(mesh1, build(keys2, vals),
                                   sessions=sessions)
    assert rows == oracle_sum(keys2, vals) and decided == (None, False)
    assert off1 == off2


def test_fold_discovers_dense(mesh1):
    rng = np.random.RandomState(17)
    keys = rng.randint(0, 64, 3000).astype(np.int32)
    vals = rng.randint(0, 100, 3000).astype(np.int32)
    keys[0] = 63  # the consumer's first wave holds the largest key
    rows, decided, off = run_both(
        mesh1, lambda bs, mod: bs.Fold(bs.Const(1, keys, vals),
                                       lambda acc, v: mod.maximum(acc, v),
                                       init=0), target=lambda s: s)
    want = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        want[k] = max(want.get(k, 0), v)
    assert rows == want
    assert decided == (64, True) and not off


def test_map_before_shuffle_probes_transformed_keys(mesh1):
    """A map stage rewrites columns before the shuffle, so the producer
    does not probe; the consumer's input is post-map, and its probe
    measures the transformed keys (2 * 49 + 1 = 99 when wave 0 holds
    the largest)."""
    rng = np.random.RandomState(19)
    raw = rng.randint(0, 50, 2000).astype(np.int32)
    vals = np.ones(2000, np.int32)

    def build(bs, mod):
        m = bs.Map(bs.Const(1, raw, vals), lambda k, v: (k * 2, v))
        return bs.Reduce(bs.Prefixed(m, 1), add)

    rows, decided, off = run_both(mesh1, build)
    assert rows == oracle_sum(raw * 2, vals)
    assert decided == (int(raw.max()) * 2 + 1, True) and not off


def test_declared_out_of_range_still_fails_loudly(mesh1):
    """Discovery's retry does not soften a user's declared bound."""
    keys = np.array([0, 1, 2, 99], dtype=np.int32)
    r = bst.Reduce(bst.Const(4, keys, np.ones(4, np.int32)), add,
                   dense_keys=10)
    assert r.frame_combiner.dense_keys == 10
    port, ref = _sessions(mesh1)
    with pytest.raises(TaskError) as ei:
        port.run(r).rows()
    assert isinstance(ei.value.cause, ValueError)
    assert "dense_keys" in str(ei.value.cause)
    with pytest.raises(Exception) as ri:
        ref.run(ref_bs.Reduce(ref_bs.Const(4, keys, np.ones(4, np.int32)),
                              add, dense_keys=10)).rows()
    assert "dense_keys" in repr(ri.value) or "partitioner" in repr(ri.value)
    assert not port.executor.auto_dense_off
