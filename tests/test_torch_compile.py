"""tests/test_compile.py's nineteen cases on the port.

Each case builds its slice in both packages from the same numpy inputs
and compiles it with each package's ``Compiler``: the task graphs
(``graph_string`` without locations) equal each other and, for the
golden cases, the files in tests/testdata; the structural cases'
assertions hold on the port's tasks with the same counts, names and
deps as the JAX package's; the running cases give the same rows. The
running cases use each package's ``LocalExecutor`` (the JAX package's
``Session()`` default), the port's on the CPU.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu import slicetest as ref_slicetest  # noqa: E402
from bigslice_tpu.exec import compile as ref_compile  # noqa: E402
from bigslice_tpu.exec.task import iter_tasks as ref_iter  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch import slicetest  # noqa: E402
from bigslice_tpu_torch.exec import compile as port_compile  # noqa: E402
from bigslice_tpu_torch.exec.task import iter_tasks  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "testdata")
PKGS = ((bst, port_compile, iter_tasks), (ref_bs, ref_compile, ref_iter))


def _local():
    return bst.Session(executor=bst.LocalExecutor(device="cpu"))


def _graphs(build, golden=None):
    """``build(bs)`` compiled by each package: the two graph strings are
    equal, and equal to the golden file's when named. Returns it."""
    got, want = (
        comp.graph_string(comp.Compiler(1).compile(build(bs)),
                          locations=False)
        for bs, comp, _ in PKGS)
    assert got == want
    if golden is not None:
        with open(os.path.join(GOLDEN_DIR, golden + ".graph")) as fh:
            assert fh.read() == got, f"golden mismatch for {golden}"
    return got


def _both_tasks(build):
    """``build(bs)`` compiled by each package: (port roots, port tasks,
    ref roots, ref tasks)."""
    out = []
    for bs, comp, it in PKGS:
        roots = comp.Compiler(1).compile(build(bs))
        out += [roots, it(roots)]
    return out


def _shape(tasks):
    return sorted((str(t.name), t.num_partition, len(t.deps))
                  for t in tasks)


def test_fusion_single_task_per_shard():
    """tests/test_compile.py::test_fusion_single_task_per_shard."""
    def build(bs):
        s = bs.Const(3, np.arange(10, dtype=np.int32))
        return bs.Map(bs.Filter(bs.Map(s, lambda x: x + 1),
                                lambda x: x > 2), lambda x: x * 2)

    tasks, all_tasks, rtasks, rall = _both_tasks(build)
    assert len(tasks) == len(rtasks) == 3
    assert all(not t.deps for t in tasks)
    assert all("map" in t.name.op and "filter" in t.name.op
               and "const" in t.name.op for t in tasks)
    assert _shape(all_tasks) == _shape(rall)


def test_shuffle_breaks_pipeline():
    """tests/test_compile.py::test_shuffle_breaks_pipeline."""
    def build(bs):
        s = bs.Const(2, np.arange(10, dtype=np.int32),
                     np.ones(10, dtype=np.int32))
        return bs.Reduce(s, lambda a, b: a + b)

    tasks, all_tasks, _, rall = _both_tasks(build)
    assert len(tasks) == 2 and len(all_tasks) == 4
    producers = [t for t in all_tasks if t.num_partition == 2]
    assert len(producers) == 2
    assert all(t.combiner is not None for t in producers)
    for shard, t in enumerate(tasks):
        assert len(t.deps) == 1
        assert t.deps[0].partition == shard
        assert t.deps[0].expand
        assert len(t.deps[0].tasks) == 2
    assert _shape(all_tasks) == _shape(rall)


def test_memoization_diamond():
    """tests/test_compile.py::test_memoization_diamond: the shared
    producer chain compiles once per (partition, combiner) config."""
    def build(bs):
        s = bs.Const(2, np.arange(10, dtype=np.int32))
        m = bs.Map(s, lambda x: (x % 2, x))
        add = lambda x, y: x + y  # noqa: E731 — shared: combiners equal
        return bs.Cogroup(bs.Reduce(m, add), bs.Reduce(m, add))

    _, all_tasks, _, rall = _both_tasks(build)
    prod = [(t.name.op, t.name.shard) for t in all_tasks
            if "const" in t.name.op]
    assert len(prod) == len(set(prod))
    assert _shape(all_tasks) == _shape(rall)


def _reduce_vs_reshuffle(bs, s):
    r = bs.Reduce(s, lambda a, b: a + b)
    p = bs.Reshuffle(s)
    return bs.Cogroup(bs.Map(r, lambda k, v: (k, v)),
                      bs.Map(p, lambda k, v: (k, v)))


def _cells(rows):
    return [(int(k), sorted(int(x) for x in a), sorted(int(x) for x in b))
            for k, a, b in rows]


def test_no_memo_collision_between_reduce_and_reshuffle():
    """tests/test_compile.py::test_no_memo_collision_between_reduce_and_reshuffle."""
    keys = np.array([1, 1, 2, 2] * 5, dtype=np.int32)
    vals = np.ones(20, dtype=np.int32)
    got = _cells(slicetest.sorted_rows(
        _reduce_vs_reshuffle(bst, bst.Const(2, keys, vals)),
        session=_local()))
    want = _cells(ref_slicetest.sorted_rows(
        _reduce_vs_reshuffle(ref_bs, ref_bs.Const(2, keys, vals))))
    assert got == want
    assert [(k, len(a), len(b)) for k, a, b in got] == [(1, 1, 10),
                                                        (2, 1, 10)]
    assert got[0][1] == [10] and got[1][1] == [10]


def test_materialize_breaks_pipeline():
    """tests/test_compile.py::test_materialize_breaks_pipeline."""
    def build(bs):
        m = bs.Map(bs.Const(2, np.arange(4, dtype=np.int32)),
                   lambda x: x + 1)
        m.pragmas = (bs.Materialize(),)
        return bs.Map(m, lambda x: x * 2)

    _, all_tasks, _, rall = _both_tasks(build)
    assert len(all_tasks) == len(rall) == 4
    _graphs(build)


def test_golden_trivial():
    """tests/test_compile.py::test_golden_trivial."""
    _graphs(lambda bs: bs.Map(bs.Const(2, np.arange(4, dtype=np.int32)),
                              lambda x: x + 1), "trivial")


def test_golden_shuffle():
    """tests/test_compile.py::test_golden_shuffle."""
    _graphs(lambda bs: bs.Reduce(
        bs.Const(2, np.arange(4, dtype=np.int32), np.ones(4, np.int32)),
        lambda a, b: a + b), "shuffle")


def test_golden_attend_chain():
    """tests/test_compile.py::test_golden_attend_chain."""
    q = np.random.RandomState(0).randn(32, 8).astype(np.float32)

    def build(bs):
        s = bs.Const(4, q, q, q)
        att = bs.SelfAttend(bs.Map(s, lambda a, b, c: (a, b, c * 2)),
                            causal=True)
        return bs.Map(att, lambda o: (o,))

    _graphs(build, "attend-chain")


def test_golden_cogroup():
    """tests/test_compile.py::test_golden_cogroup."""
    _graphs(lambda bs: bs.Cogroup(
        bs.Const(3, np.arange(8, dtype=np.int32),
                 np.arange(8, dtype=np.int32)),
        bs.Const(3, np.arange(6, dtype=np.int32),
                 np.arange(6, dtype=np.float32))), "cogroup")


def test_golden_waved_reduce():
    """tests/test_compile.py::test_golden_waved_reduce."""
    _graphs(lambda bs: bs.Reduce(
        bs.Const(12, np.arange(48, dtype=np.int32), np.ones(48, np.int32)),
        lambda a, b: a + b), "waved-reduce")


def test_golden_branch_shuffle():
    """tests/test_compile.py::test_golden_branch_shuffle."""
    def build(bs):
        s = bs.Const(2, np.arange(4, dtype=np.int32), np.ones(4, np.int32))
        return bs.Cogroup(s, bs.Reduce(s, lambda x, y: x + y))

    _graphs(build, "branch-shuffle")


def test_golden_reshuffle_chain():
    """tests/test_compile.py::test_golden_reshuffle_chain."""
    _graphs(lambda bs: bs.Map(
        bs.Reshuffle(bs.Const(3, np.arange(9, dtype=np.int32))),
        lambda x: x + 1), "reshuffle-chain")


def test_distinct_configs_get_distinct_task_names():
    """tests/test_compile.py::test_distinct_configs_get_distinct_task_names."""
    def build(bs):
        s = bs.Const(2, np.array([1, 1, 2, 2], np.int32),
                     np.ones(4, dtype=np.int32))
        return _reduce_vs_reshuffle(bs, s)

    _, all_tasks, _, rall = _both_tasks(build)
    names = [str(t.name) for t in all_tasks]
    assert len(names) == len(set(names)), names
    assert sorted(names) == sorted(str(t.name) for t in rall)


def test_result_reuse_adapters_distinct_names():
    """tests/test_compile.py::test_result_reuse_adapters_distinct_names:
    a Result read at two partition configs."""
    from bigslice_tpu.exec.session import Session as RefSession

    keys = np.array([1, 1, 2, 2] * 8, np.int32)
    ones = np.ones(32, dtype=np.int32)
    out = []
    for bs, sess in ((bst, _local()), (ref_bs, RefSession())):
        res = sess.run(bs.Const(2, keys, ones))
        out.append(_cells(sorted(sess.run(
            _reduce_vs_reshuffle(bs, res)).rows(), key=lambda r: int(r[0]))))
    assert out[0] == out[1]
    assert [(k, len(a), len(b)) for k, a, b in out[0]] == [(1, 1, 16),
                                                           (2, 1, 16)]


def test_device_boundary_rebatch_once_per_chain():
    """tests/test_compile.py::test_device_boundary_rebatch_once_per_chain:
    1000 one-row host batches are re-chunked before the device stage,
    and a Head chain stays lazy."""
    for bs, sess_kw, st in ((bst, dict(session=_local()), slicetest),
                            (ref_bs, {}, ref_slicetest)):
        pulls = []

        def gen(shard, pulls=pulls):
            for i in range(1000):
                pulls.append(i)
                yield ([i],)

        src = bs.ReaderFunc(1, gen, out=[np.int32])
        rows = st.scan_all(bs.Map(src, lambda x: x + 1), **sess_kw)
        assert sorted((int(r[0]),) for r in rows) == [
            (i + 1,) for i in range(1000)]
        assert len(pulls) == 1000
        pulls.clear()
        src2 = bs.ReaderFunc(1, gen, out=[np.int32])
        h = bs.Head(bs.Map(src2, lambda x: x + 1), 5)
        assert len(st.scan_all(h, **sess_kw)) == 5
        assert len(pulls) < 100


def _two_dep_slice(bs, base, slicetype, a, b):
    schema = slicetype.Schema([slicetype.ColType(np.dtype(np.int32)),
                               slicetype.ColType(np.dtype(np.int32))],
                              prefix=1)

    def combine(x, y):
        return x + y

    class TwoDepCombining(base.Slice):
        def __init__(self):
            super().__init__(schema, a.num_shards, base.make_name("twodep"))

        def deps(self):
            return (base.Dep(a, shuffle=True), base.Dep(b, shuffle=True))

        def combiner(self):
            return base.Combiner(combine)

        def reader(self, shard, deps):  # pragma: no cover - not run
            raise NotImplementedError

    return TwoDepCombining()


def test_multi_dep_combine_keys_attach_per_dep():
    """tests/test_compile.py::test_multi_dep_combine_keys_attach_per_dep:
    each shuffle dep carries its own machine-combine key."""
    from bigslice_tpu import slicetype as ref_slicetype
    from bigslice_tpu.ops import base as ref_base

    from bigslice_tpu_torch import slicetype
    from bigslice_tpu_torch.ops import base

    for bs, b_, st, comp in ((bst, base, slicetype, port_compile),
                             (ref_bs, ref_base, ref_slicetype,
                              ref_compile)):
        a = bs.Const(2, np.arange(8, dtype=np.int32), np.ones(8, np.int32))
        b = bs.Const(2, np.arange(8, dtype=np.int32), np.ones(8, np.int32))
        tasks = comp.Compiler(1, machine_combiners=True).compile(
            _two_dep_slice(bs, b_, st, a, b))
        for t in tasks:
            ka, kb = t.deps[0].combine_key, t.deps[1].combine_key
            assert ka and kb and ka != kb
            assert f"-{id(a)}-" in ka
            assert f"-{id(b)}-" in kb


def test_golden_branch_materialize():
    """tests/test_compile.py::test_golden_branch_materialize."""
    def build(bs):
        s = bs.Const(2, np.arange(4, dtype=np.int32), np.ones(4, np.int32))
        m = bs.Map(s, lambda k, v: (k, v + 1))
        m.pragmas = (bs.Materialize(),)
        return bs.Cogroup(bs.Map(m, lambda k, v: (k, v * 2)),
                          bs.Filter(m, lambda k, v: k > 0))

    _graphs(build, "branch-materialize")


def test_golden_different_partitions():
    """tests/test_compile.py::test_golden_different_partitions."""
    def build(bs):
        s = bs.Const(2, np.arange(8, dtype=np.int32), np.ones(8, np.int32))
        a = bs.Reduce(s, lambda x, y: x + y)
        b = bs.Reshard(bs.Prefixed(s, 1), 3)
        return bs.Cogroup(a, bs.Map(b, lambda k, v: (k, v)))

    _graphs(build, "different-partitions")


def test_golden_join_aggregate():
    """tests/test_compile.py::test_golden_join_aggregate."""
    _graphs(lambda bs: bs.JoinAggregate(
        bs.Const(2, np.arange(4, dtype=np.int32), np.ones(4, np.int32)),
        bs.Const(2, np.arange(4, dtype=np.int32), np.ones(4, np.int32)),
        lambda x, y: x + y, lambda x, y: x * y), "join-aggregate")
