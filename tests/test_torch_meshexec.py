"""tests/test_meshexec.py's cases on the port's one-slot executor.

The reference suite runs the JAX package's ``MeshExecutor`` on an
8-device CPU mesh. Each pipeline case here runs the same slice, built
from the same numpy inputs, through that executor and through the
port's ``MeshExecutor(device="cpu")`` (one device slot: shards beyond
it stream as waves), compares the two results shard for shard
(``result_shard_rows``: integers exact, floats within 1e-6, as the
reference's own local-versus-mesh checks), and then holds the port's
result to the reference case's assertions. The executor-internal cases
(the gather plan, the error classifiers, the threads a run leaves)
hold the port's counterparts to the same contracts. The multi-device
pipelines of the suite also run over ranks as
``tests/torch_spmd_scenarios.py`` scenarios. Where a case's mechanism
has no counterpart in the port, its docstring says what the port does
in its place (recorded in ROADMAP.md C3.12).
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bigslice_tpu as ref_bs  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.exec import meshexec as mx  # noqa: E402
from bigslice_tpu_torch.exec.meshexec import MeshExecutor  # noqa: E402
from bigslice_tpu_torch.exec.session import Session  # noqa: E402
from bigslice_tpu_torch.exec.task import TaskError  # noqa: E402


def _ref_exec(**kw):
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor as RefMesh

    return RefMesh(Mesh(np.array(jax.devices()[:8]), ("shards",)), **kw)


def _ref_session(**kw):
    from bigslice_tpu.exec.session import Session as RefSession

    return RefSession(executor=_ref_exec(**kw))


def _session(**kw):
    return Session(executor=MeshExecutor(device="cpu", **kw))


def _ordered_session():
    """A one-process session whose executor dispatches as over ranks:
    one dispatcher thread, groups in plan order. The port has no option
    for it (one process dispatches concurrently, ROADMAP C3.16), so the
    reference's ordered-mode cases set the executor's attribute."""
    sess = _session()
    sess.executor.ordered_dispatch = True
    return sess


def _same_shards(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for gc, wc in zip(g, w):
            if gc.dtype.kind == "f":
                np.testing.assert_allclose(gc, wc, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(gc, wc)


def _both(build, port=None, ref=None):
    """``build(bs)`` through the JAX package's 8-device executor and the
    port's: the shards equal. Returns (port session, port result)."""
    port = port or _session()
    ref = ref or _ref_session()
    res = port.run(build(bst))
    _same_shards(bst.result_shard_rows(res),
                 bst.result_shard_rows(ref.run(build(ref_bs))))
    return port, res


def rows_sorted(res):
    return sorted(res.rows())


def _oracle_sum(keys, vals):
    out = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        out[k] = out.get(k, 0) + v
    return out


def test_const_map_on_mesh():
    """tests/test_meshexec.py::test_const_map_on_mesh."""
    sess, res = _both(lambda bs: bs.Map(
        bs.Const(8, np.arange(64, dtype=np.int32)), lambda x: x * 2))
    assert rows_sorted(res) == [(2 * i,) for i in range(64)]
    assert sess.executor.device_group_count() >= 1


def test_reduce_on_mesh():
    """tests/test_meshexec.py::test_reduce_on_mesh."""
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 40, 800).astype(np.int32)
    vals = rng.randint(0, 10, 800).astype(np.int32)
    sess, res = _both(lambda bs: bs.Reduce(bs.Const(8, keys, vals),
                                           lambda a, b: a + b))
    assert dict(res.rows()) == _oracle_sum(keys, vals)
    assert sess.executor.device_group_count() >= 2


def test_filter_map_chain_on_mesh():
    """tests/test_meshexec.py::test_filter_map_chain_on_mesh."""
    _, res = _both(lambda bs: bs.Map(
        bs.Filter(bs.Const(8, np.arange(160, dtype=np.int32)),
                  lambda x: x % 3 == 0), lambda x: x + 1))
    assert rows_sorted(res) == [(i + 1,) for i in range(0, 160, 3)]


def test_reshuffle_on_mesh():
    """tests/test_meshexec.py::test_reshuffle_on_mesh."""
    _, res = _both(lambda bs: bs.Reshuffle(
        bs.Const(8, np.arange(80, dtype=np.int32))))
    assert rows_sorted(res) == [(i,) for i in range(80)]


def test_host_pipeline_falls_back():
    """tests/test_meshexec.py::test_host_pipeline_falls_back: str keys
    run on the host tier of the device executor."""
    words = np.array(["a", "b", "a", "c"] * 10, dtype=object)
    port = _session()
    res = port.run(bst.Reduce(bst.Const(8, words, np.ones(40, np.int32)),
                              lambda a, b: a + b))
    ref = _ref_session().run(ref_bs.Reduce(
        ref_bs.Const(8, list(words), np.ones(40, np.int32)),
        lambda a, b: a + b))
    assert dict(res.rows()) == dict(ref.rows()) == {"a": 20, "b": 10,
                                                    "c": 10}


def test_mesh_producer_host_consumer():
    """tests/test_meshexec.py::test_mesh_producer_host_consumer: a
    device producer feeding a host-tier Fold."""
    keys = np.arange(64, dtype=np.int32) % 4
    vals = np.ones(64, dtype=np.int32)
    _, res = _both(lambda bs: bs.Fold(
        bs.Map(bs.Const(8, keys, vals), lambda k, v: (k, v)),
        lambda acc, v: acc + int(v), init=0, out_value=np.int32))
    assert dict(res.rows()) == {0: 16, 1: 16, 2: 16, 3: 16}


def test_host_producer_mesh_consumer():
    """tests/test_meshexec.py::test_host_producer_mesh_consumer."""
    def gen(shard):
        yield ([shard % 4] * 10, [1] * 10)

    _, res = _both(lambda bs: bs.Reduce(
        bs.ReaderFunc(8, gen, out=[np.int32, np.int32]),
        lambda a, b: a + b))
    assert dict(res.rows()) == {0: 20, 1: 20, 2: 20, 3: 20}


@pytest.mark.parametrize("shards", [5, 11],
                         ids=["small_shard_count_runs_padded",
                              "large_shard_count_full_device"])
def test_shard_counts_off_the_mesh(shards):
    """tests/test_meshexec.py::test_small_shard_count_runs_padded and
    ::test_large_shard_count_full_device (5 and 11 shards: padded on
    the 8-device mesh, and waved; on the port's one slot both are
    waves), both groups on the device."""
    n = shards * 10
    keys = np.arange(n, dtype=np.int32) % 7
    sess, res = _both(lambda bs: bs.Reduce(
        bs.Const(shards, keys, np.ones(n, np.int32)), lambda a, b: a + b))
    assert dict(res.rows()) == {i: n // 7 + (1 if i < n % 7 else 0)
                                for i in range(7)}
    assert sess.executor.device_group_count() >= 2


def test_result_reuse_across_runs():
    """tests/test_meshexec.py::test_result_reuse_across_runs."""
    sess = _session()
    base = sess.run(bst.Const(8, np.arange(32, dtype=np.int32)))
    m = sess.run(bst.Map(base, lambda x: x + 100))
    assert rows_sorted(m) == [(i + 100,) for i in range(32)]


def test_map_with_args_on_mesh():
    """tests/test_meshexec.py::test_map_with_args_on_mesh."""
    _, res = _both(lambda bs: bs.Map(
        bs.Const(8, np.arange(16, dtype=np.float32)),
        lambda x, off: x + off, args=(np.float32(5.0),)))
    assert rows_sorted(res) == [(float(i) + 5.0,) for i in range(16)]


@pytest.mark.parametrize("what", ["mesh_matches_local_executor",
                                  "wave_matches_local"])
def test_matches_local_executor(what):
    """tests/test_meshexec.py::test_mesh_matches_local_executor and
    ::test_wave_matches_local: a filtered float max (8 shards) and a
    filtered float min resharded 24 -> 6, equal on the port's local and
    device executors and the JAX package's."""
    rng = np.random.RandomState(7 if what.startswith("mesh") else 17)
    n, span = (400, 25) if what.startswith("mesh") else (600, 50)
    keys = rng.randint(0, span, n).astype(np.int32)
    vals = rng.rand(n).astype(np.float32)

    def build(bs):
        mod = jnp if bs is ref_bs else torch
        if what.startswith("mesh"):
            f = bs.Filter(bs.Const(8, keys, vals), lambda k, v: k % 2 == 0)
            return bs.Reduce(f, lambda a, b: mod.maximum(a, b))
        f = bs.Filter(bs.Const(24, keys, vals), lambda k, v: k % 3 != 1)
        return bs.Reduce(bs.Reshard(bs.Prefixed(f, 1), 6),
                         lambda a, b: mod.minimum(a, b))

    _, res = _both(build)
    local = dict(Session(executor=bst.LocalExecutor(device="cpu")).run(
        build(bst)).rows())
    meshr = dict(res.rows())
    assert set(local) == set(meshr)
    for k in local:
        assert abs(local[k] - meshr[k]) < 1e-6


def _reduce_vs_reshuffle(bs, keys, vals):
    s = bs.Const(8, keys, vals)
    return bs.Cogroup(
        bs.Map(bs.Reduce(s, lambda a, b: a + b), lambda k, v: (k, v)),
        bs.Map(bs.Reshuffle(s), lambda k, v: (k, v)))


def test_same_op_different_configs_not_merged():
    """tests/test_meshexec.py::test_same_op_different_configs_not_merged."""
    keys = np.array([1, 1, 2, 2] * 16, dtype=np.int32)
    vals = np.ones(64, dtype=np.int32)
    res = _session().run(_reduce_vs_reshuffle(bst, keys, vals))
    ref = _ref_session().run(_reduce_vs_reshuffle(ref_bs, keys, vals))
    got = [(int(k), len(a), len(b)) for k, a, b in rows_sorted(res)]
    assert got == [(int(k), len(a), len(b))
                   for k, a, b in sorted(ref.rows())]
    assert got == [(1, 1, 32), (2, 1, 32)]


def test_head_on_mesh():
    """tests/test_meshexec.py::test_head_on_mesh."""
    sess, res = _both(lambda bs: bs.Head(bs.Filter(
        bs.Const(8, np.arange(800, dtype=np.int32)),
        lambda x: x % 2 == 0), 5))
    rows = res.rows()
    assert len(rows) == 40 and all(v % 2 == 0 for (v,) in rows)
    assert sess.executor.device_group_count() >= 1


def test_ordered_dispatch_mode():
    """tests/test_meshexec.py::test_ordered_dispatch_mode: one
    dispatcher, plan order, the same rows as concurrent mode, twice."""
    rng = np.random.RandomState(11)
    keys = rng.randint(0, 30, 640).astype(np.int32)
    vals = rng.randint(0, 5, 640).astype(np.int32)

    def build(bs):
        s = bs.Const(8, keys, vals)
        return bs.Reduce(bs.Filter(s, lambda k, v: k % 2 == 0),
                         lambda a, b: a + b)

    base = dict(_session().run(build(bst)).rows())
    sess, res = _both(build, port=_ordered_session())
    assert dict(res.rows()) == base
    assert sess.executor.device_group_count() >= 2
    assert dict(sess.run(build(bst)).rows()) == base


def test_concurrent_result_scans_on_mesh():
    """tests/test_meshexec.py::test_concurrent_result_scans_on_mesh:
    concurrent scans of a discarded result re-evaluate shared tasks
    without a deadlock."""
    sess = _session()
    base = sess.run(bst.Map(bst.Const(8, np.arange(80, dtype=np.int32)),
                            lambda x: x * 3))
    expect = sorted((3 * i,) for i in range(80))
    errs = []
    for _ in range(3):
        base.discard()

        def scan():
            try:
                assert rows_sorted(base) == expect
            except Exception as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=scan, daemon=True)
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "scan deadlocked"
        assert not errs, errs


def test_ordered_dispatch_slow_host_deps_no_deadlock():
    """tests/test_meshexec.py::test_ordered_dispatch_slow_host_deps_no_deadlock."""
    sess = _ordered_session()

    def slow_ident(k, v):
        time.sleep(0.05)
        return (k, v)

    def build():
        s = bst.Const(8, np.arange(64, dtype=np.int32) % 4,
                      np.ones(64, dtype=np.int32))
        m = bst.Map(s, slow_ident, out=[np.int32, np.int32], mode="host")
        return bst.Reduce(m, lambda a, b: a + b)

    out = {}

    def run():
        out["rows"] = dict(sess.run(build()).rows())

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "ordered dispatch deadlocked"
    assert out["rows"] == {0: 16, 1: 16, 2: 16, 3: 16}


def test_map_out_dtype_cast_on_mesh():
    """tests/test_meshexec.py::test_map_out_dtype_cast_on_mesh."""
    sess, res = _both(lambda bs: bs.Map(
        bs.Const(8, np.arange(32, dtype=np.int32)), lambda x: x,
        out=[np.float32]))
    assert sess.executor.device_group_count() >= 1
    for shard in bst.result_shard_rows(res):
        assert shard[0].dtype == np.float32
    assert rows_sorted(res) == [(float(i),) for i in range(32)]


def test_program_cache_guards_recycled_fn_ids():
    """tests/test_meshexec.py::test_program_cache_guards_recycled_fn_ids.
    The port keeps no executable keyed by a stage function's id: its
    wave program is rebuilt on every call (``MeshExecutor._program``),
    so a new function, whose id may be a dead one's, runs its own code.
    Three Maps of one site on one executor, each function dropped
    before the next is made."""
    import gc

    sess = _session()
    src = bst.Const(8, np.arange(16, dtype=np.int32))
    for add in (1, 7, 3):
        fn = eval(f"lambda x: x + {add}")  # a fresh function object
        assert rows_sorted(sess.run(bst.Map(src, fn))) == [
            (i + add,) for i in range(16)]
        del fn
        gc.collect()


def test_fixed_fanout_flatmap_on_mesh():
    """tests/test_meshexec.py::test_fixed_fanout_flatmap_on_mesh."""
    def build(bs):
        mod = jnp if bs is ref_bs else torch

        def dup(x):
            if mod is jnp:
                mask = jnp.array([True, True]) & jnp.array([True, False]) | (
                    jnp.array([False, True]) & (x % 2 == 0))
                return mask, jnp.stack([x, x + 1000])
            t = torch.tensor([True, True], device=x.device)
            f = torch.tensor([True, False], device=x.device)
            mask = t & f | (~f & (x % 2 == 0))
            return mask, torch.stack([x, x + 1000])

        fm = bs.Flatmap(bs.Const(8, np.arange(64, dtype=np.int32)), dup,
                        out=[np.int32], fanout=2)
        return bs.Reduce(bs.Map(fm, lambda x: (x % 4, x)),
                         lambda a, b: a + b)

    sess, res = _both(build)
    oracle = {}
    for x in range(64):
        for o in [x] + ([x + 1000] if x % 2 == 0 else []):
            oracle[o % 4] = oracle.get(o % 4, 0) + o
    assert dict(res.rows()) == oracle
    assert sess.executor.device_group_count() >= 2


def test_device_repartition_on_mesh():
    """tests/test_meshexec.py::test_device_repartition_on_mesh: shard s
    holds exactly the range block s."""
    sess, res = _both(lambda bs: bs.Repartition(
        bs.Const(8, np.arange(64, dtype=np.int32)),
        lambda k, nparts: (k * nparts) // 64))
    assert rows_sorted(res) == [(i,) for i in range(64)]
    assert sess.executor.device_group_count() >= 1
    for shard in range(8):
        vals = sorted(v for f in res.reader(shard, ()) for (v,) in f.rows())
        assert vals == list(range(shard * 8, (shard + 1) * 8))


def test_repartition_matches_local():
    """tests/test_meshexec.py::test_repartition_matches_local."""
    def build(bs):
        return bs.Repartition(bs.Const(8, np.arange(48, dtype=np.int32)),
                              lambda k, nparts: (k * 7 + 3) % nparts)

    _, rm = _both(build)
    rl = Session(executor=bst.LocalExecutor(device="cpu")).run(build(bst))
    for shard in range(8):
        lv = sorted(v for f in rl.reader(shard, ()) for (v,) in f.rows())
        mv = sorted(v for f in rm.reader(shard, ()) for (v,) in f.rows())
        assert lv == mv


def test_reshard_down_on_mesh():
    """tests/test_meshexec.py::test_reshard_down_on_mesh."""
    sess, res = _both(lambda bs: bs.Reshard(
        bs.Prefixed(bs.Const(8, np.arange(64, dtype=np.int32)), 1), 3))
    assert rows_sorted(res) == [(i,) for i in range(64)]
    assert res.num_shards == 3
    assert sess.executor.device_group_count() >= 2


def test_device_partitioner_range_error():
    """tests/test_meshexec.py::test_device_partitioner_range_error."""
    rp = bst.Repartition(bst.Const(8, np.arange(64, dtype=np.int32)),
                         lambda k, nparts: (k % nparts) + 1)
    with pytest.raises(TaskError, match="outside"):
        _session().run(rp)


def test_wave_scheduling_more_shards_than_devices():
    """tests/test_meshexec.py::test_wave_scheduling_more_shards_than_devices."""
    rng = np.random.RandomState(13)
    keys = rng.randint(0, 31, 20 * 40).astype(np.int32)
    vals = rng.randint(1, 5, 20 * 40).astype(np.int32)
    sess, res = _both(lambda bs: bs.Reduce(
        bs.Reshard(bs.Prefixed(bs.Const(20, keys, vals), 1), 8),
        lambda a, b: a + b))
    assert dict(res.rows()) == _oracle_sum(keys, vals)
    assert sess.executor.device_group_count() >= 2


def test_wave_unpartitioned_root():
    """tests/test_meshexec.py::test_wave_unpartitioned_root."""
    sess, res = _both(lambda bs: bs.Map(
        bs.Const(20, np.arange(200, dtype=np.int32)), lambda x: x * 3))
    assert rows_sorted(res) == [(3 * i,) for i in range(200)]
    assert sess.executor.device_group_count() >= 1
    got0 = sorted(v for f in res.reader(0, ()) for (v,) in f.rows())
    assert got0 == [3 * i for i in range(10)]
    got19 = sorted(v for f in res.reader(19, ()) for (v,) in f.rows())
    assert got19 == [3 * i for i in range(190, 200)]


def test_wave_aligned_chain():
    """tests/test_meshexec.py::test_wave_aligned_chain."""
    def build(bs):
        m = bs.Map(bs.Const(12, np.arange(120, dtype=np.int32)),
                   lambda x: x + 1)
        m.pragmas = (bs.Materialize(),)
        return bs.Map(m, lambda x: x * 2)

    sess, res = _both(build)
    assert rows_sorted(res) == [(2 * (i + 1),) for i in range(120)]
    assert sess.executor.device_group_count() >= 2


def test_wave_partitioned_shuffle_beyond_mesh():
    """tests/test_meshexec.py::test_wave_partitioned_shuffle_beyond_mesh:
    each of 20 shards holds the keys the host tier's hash % 20 names."""
    from bigslice_tpu_torch.frame.frame import Frame
    from bigslice_tpu_torch.slicetype import Schema

    rng = np.random.RandomState(41)
    keys = rng.randint(0, 71, 20 * 50).astype(np.int32)
    vals = rng.randint(1, 6, 20 * 50).astype(np.int32)
    sess, res = _both(lambda bs: bs.Reduce(bs.Const(20, keys, vals),
                                           lambda a, b: a + b))
    oracle = _oracle_sum(keys, vals)
    assert dict(res.rows()) == oracle
    assert sess.executor.device_group_count() >= 2
    uk = np.asarray(sorted(oracle), np.int32)
    part = np.asarray(Frame([uk], Schema([np.int32], prefix=1))
                      .partition_ids(20))
    for shard in (0, 7, 13, 19):
        got = sorted(k for f in res.reader(shard, ()) for k, _ in f.rows())
        assert got == sorted(uk[part == shard].tolist())


def test_wave_partitioned_reshuffle_roundtrip():
    """tests/test_meshexec.py::test_wave_partitioned_reshuffle_roundtrip."""
    sess, res = _both(lambda bs: bs.Reshuffle(
        bs.Const(24, np.arange(24 * 30, dtype=np.int32))))
    assert rows_sorted(res) == [(i,) for i in range(24 * 30)]
    assert sess.executor.device_group_count() >= 1


def test_infra_error_probation_falls_back_then_recovers():
    """tests/test_meshexec.py::test_infra_error_probation_falls_back_then_recovers:
    an infra failure (the card's out-of-memory class) reruns the op on
    the host tier under probation; once probation lapses the device
    path re-engages."""
    class OutOfMemoryError(RuntimeError):
        pass

    ex = MeshExecutor(device="cpu")
    sess = Session(executor=ex)
    real = ex._execute_group
    fails = {"n": 0}

    def flaky(*args, **kw):
        if fails["n"] == 0:
            fails["n"] += 1
            raise OutOfMemoryError("CUDA out of memory: injected")
        return real(*args, **kw)

    ex._execute_group = flaky
    keys = np.arange(64, dtype=np.int32) % 7
    vals = np.ones(64, np.int32)

    def add(a, b):
        return a + b

    def build():
        return bst.Reduce(bst.Const(8, keys, vals), add)

    got = dict(sess.run(build()).rows())
    assert got == {i: 10 if i < 64 % 7 else 9 for i in range(7)}
    assert fails["n"] == 1
    assert ex._probation, "op should be on probation"
    probed = set(ex._probation)
    before = ex.device_group_count()
    for op in list(ex._probation):
        ex._probation[op] = 0.0
    assert dict(sess.run(build()).rows()) == got
    assert not (set(ex._probation) & probed), "probation not lifted"
    assert ex.device_group_count() > before


def test_user_error_stays_fatal_on_mesh():
    """tests/test_meshexec.py::test_user_error_stays_fatal_on_mesh."""
    def boom(x):
        raise ValueError("user bug")

    with pytest.raises(TaskError):
        _session().run(bst.Map(bst.Const(4, np.arange(16, dtype=np.int32)),
                               boom, out=[np.int32]))


def _mk_task(op, shard, num_shard, group_key, deps=(), chain=None,
             num_partition=1):
    from bigslice_tpu_torch.exec.task import (Partitioner, Task, TaskDep,
                                              TaskName)
    from bigslice_tpu_torch.slicetype import Schema

    t = Task(TaskName(inv_index=1, op=op, shard=shard, num_shard=num_shard),
             None, [TaskDep(tasks=tuple(d), partition=0) for d in deps],
             Partitioner(num_partition=num_partition), Schema([np.int32]))
    t.group_key = group_key
    t.chain = chain  # None: host tier
    return t


class _FakeOut:
    def __init__(self):
        self.gather_calls = 0
        self.gathered = False

    def gather(self, mesh=None):
        self.gather_calls += 1
        self.gathered = True


def test_plan_gather_marks_and_pays_late_debt():
    """tests/test_meshexec.py::test_plan_gather_marks_and_pays_late_debt:
    producers a host-tier consumer reads and the run's roots are
    marked; a device-consumed partitioned producer is not; a resident
    output newly marked becomes a gather debt the dispatcher pays."""
    ex = MeshExecutor(device="cpu")
    ex.ordered_dispatch = True
    prods = [_mk_task("const-0", s, 2, "P", num_partition=2)
             for s in range(2)]
    cons = [_mk_task("map-0", s, 2, "C", deps=[prods]) for s in range(2)]
    out = _FakeOut()
    ex._outputs["P"] = out
    ex.plan_gather(cons, token="t1")
    assert "P" in ex._gather_marked and "C" in ex._gather_marked
    assert {"P", "C"} <= set(ex._gather_analyzed)
    deadline = time.monotonic() + 10.0
    while not out.gathered and time.monotonic() < deadline:
        time.sleep(0.01)
    assert out.gather_calls == 1
    with ex._lock:
        assert "P" not in ex._gather_pending
    prods2 = [_mk_task("const-1", s, 2, "P2", num_partition=2)
              for s in range(2)]
    chain = (bst.Const(2, np.arange(8, dtype=np.int32)),)
    dev_cons = [_mk_task("reduce-1", s, 2, "C2", deps=[prods2],
                         chain=chain) for s in range(2)]
    ex._eligible = lambda t, count=True: t.chain is not None
    ex.plan_gather([_mk_task("tail-1", 0, 1, "R", deps=[dev_cons])],
                   token="t2")
    assert "P2" not in ex._gather_marked
    assert "C2" in ex._gather_marked


def test_machine_combiners_ride_device_path():
    """tests/test_meshexec.py::test_machine_combiners_ride_device_path."""
    rng = np.random.RandomState(11)
    keys = rng.randint(0, 60, 1600).astype(np.int32)
    vals = rng.randint(0, 10, 1600).astype(np.int32)
    port = Session(executor=MeshExecutor(device="cpu"),
                   machine_combiners=True)
    from bigslice_tpu.exec.session import Session as RefSession

    ref = RefSession(executor=_ref_exec(), machine_combiners=True)
    sess, res = _both(lambda bs: bs.Reduce(bs.Const(8, keys, vals),
                                           lambda a, b: a + b),
                      port=port, ref=ref)
    assert dict(res.rows()) == _oracle_sum(keys, vals)
    assert sess.executor.device_group_count() >= 2
    assert not sess.executor.local._mc_keys_committed


def test_machine_combiners_waved_cross_wave_recombine():
    """tests/test_meshexec.py::test_machine_combiners_waved_cross_wave_recombine:
    16 machine-combined shards in waves; every merged partitioned output
    holds at most one row per (subid, key)."""
    rng = np.random.RandomState(12)
    keys = rng.randint(0, 30, 3200).astype(np.int32)
    ones = np.ones(3200, np.int32)
    sess = Session(executor=MeshExecutor(device="cpu"),
                   machine_combiners=True)
    got = dict(sess.run(bst.Reduce(bst.Const(16, keys, ones),
                                   lambda a, b: a + b)).rows())
    assert got == _oracle_sum(keys, ones)
    ex = sess.executor
    with ex._lock:
        merged = [o for o in ex._outputs.values()
                  if getattr(o, "partitioned", False)]
    assert merged
    for out in merged:
        chunks = out.host_chunks()
        for d in range(out.nmesh):
            cols = [np.asarray(c[d]) for c in chunks]
            if not len(cols[0]):
                continue
            pairs = list(zip(*[c.tolist() for c in
                               cols[:2 if out.subid else 1]]))
            assert len(pairs) == len(set(pairs))


def test_hbm_budget_splits_wave():
    """tests/test_meshexec.py::test_hbm_budget_splits_wave: a 2,000-byte
    budget splits each wave into K > 1 row slices, each slice's rows at
    most cap / K, rows exact and equal to the unbudgeted run's."""
    rng = np.random.RandomState(13)
    keys = rng.randint(0, 50, 4096).astype(np.int32)
    vals = rng.randint(0, 7, 4096).astype(np.int32)

    def build(bs):
        return bs.Reduce(bs.Const(8, keys, vals), lambda a, b: a + b)

    sess, res = _both(build, port=_session(device_budget_bytes=2_000))
    oracle = _oracle_sum(keys, vals)
    assert dict(res.rows()) == oracle
    ex = sess.executor
    assert ex.split_runs and max(ex.split_runs.values()) > 1
    assert dict(_session().run(build(bst)).rows()) == oracle


def test_wave_stress_64_shards():
    """tests/test_meshexec.py::test_wave_stress_64_shards: S = 64 in 64
    waves on one slot, under the reference's generous wall bound."""
    shards, per = 64, 512
    n = shards * per
    keys = np.random.RandomState(17).randint(0, 997, n).astype(np.int32)
    sess = _session()
    t0 = time.perf_counter()
    got = dict(sess.run(bst.Reduce(bst.Const(shards, keys,
                                             np.ones(n, np.int32)),
                                   lambda a, b: a + b)).rows())
    dt = time.perf_counter() - t0
    assert got == _oracle_sum(keys, np.ones(n, np.int64))
    assert sess.executor.device_group_count() >= 2
    assert dt < 60.0, f"wave-stress run took {dt:.1f}s"


def test_daemon_pool_recycles_and_survives_exceptions():
    """tests/test_meshexec.py::test_daemon_pool_recycles_and_survives_exceptions.
    The port keeps no thread pool for groups: each launched group runs
    on a thread of its own that ends with it. The contract the pool
    kept holds: runs do not accumulate threads, and a group that fails
    leaves the executor serving."""
    sess = _session()
    src = bst.Const(4, np.arange(64, dtype=np.int32) % 5,
                    np.ones(64, np.int32))
    sess.run(bst.Reduce(src, lambda a, b: a + b))
    before = threading.active_count()
    for i in range(5):
        with pytest.raises(TaskError):
            sess.run(bst.Map(src, lambda k, v: (k // 0, v), mode="host",
                             out=[np.int32, np.int32]))
        assert len(sess.run(bst.Reduce(src, lambda a, b: a + b))
                   .rows()) == 5
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


class OutOfMemoryError(RuntimeError):
    """Named as torch's allocator error: the classifier matches the
    class name along the MRO."""


class _OomSubclass(OutOfMemoryError):
    pass


def test_infra_error_classified_by_type():
    """tests/test_meshexec.py::test_infra_error_classified_by_type, with
    the card's infra class (torch's ``OutOfMemoryError``) in place of
    XLA's runtime error: by type, through the MRO and the chain."""
    assert mx._looks_like_infra_error(OutOfMemoryError("boom"))
    assert mx._looks_like_infra_error(_OomSubclass("wrapped"))
    try:
        try:
            raise OutOfMemoryError("device died")
        except OutOfMemoryError as inner:
            raise ValueError("wrapper") from inner
    except ValueError as outer:
        assert mx._looks_like_infra_error(outer)


def test_infra_error_string_fallback_and_negatives():
    """tests/test_meshexec.py::test_infra_error_string_fallback_and_negatives."""
    assert mx._looks_like_infra_error(
        RuntimeError("RESOURCE_EXHAUSTED: while allocating 2G"))
    assert mx._looks_like_infra_error(
        RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert not mx._looks_like_infra_error(
        ValueError("user asked about dma and memory budgets"))
    assert not mx._looks_like_infra_error(ValueError("plain user error"))
    # A sticky CUDA error poisons the context: never retried on the host.
    assert not mx._looks_like_infra_error(RuntimeError(
        "CUDA error: an illegal memory access was encountered; "
        "CUDA out of memory"))


def test_host_loss_classified_by_type_then_string():
    """tests/test_meshexec.py::test_host_loss_classified_by_type_then_string."""
    from bigslice_tpu_torch.utils.distributed import PeerLostError

    assert mx._looks_like_host_loss(PeerLostError("peer 3 gone"))
    assert mx._looks_like_host_loss(mx.HostLostError("already wrapped"))
    try:
        try:
            raise PeerLostError("peer lost mid-collective")
        except PeerLostError:
            raise RuntimeError("collective failed")
    except RuntimeError as outer:
        assert mx._looks_like_host_loss(outer)
    assert mx._looks_like_host_loss(
        RuntimeError("Gloo allreduce failed: connection reset by peer"))
    assert not mx._looks_like_host_loss(
        ValueError("peer review feedback pending"))


def test_exception_chain_is_cycle_safe():
    """tests/test_meshexec.py::test_exception_chain_is_cycle_safe."""
    a = ValueError("a")
    b = RuntimeError("b")
    a.__cause__ = b
    b.__cause__ = a
    assert {repr(e) for e in mx._exception_chain(a)} == {repr(a), repr(b)}


def test_task_error_cause_is_walked():
    """tests/test_meshexec.py::test_task_error_cause_is_walked."""
    import types

    from bigslice_tpu_torch.exec.task import TaskName

    t = types.SimpleNamespace(name=TaskName(1, "op", 0, 1))
    assert mx._looks_like_infra_error(TaskError(t, OutOfMemoryError("oom")))
