"""The rest of the port's user API against the JAX package's.

Reshard, Prefixed / Unwrap, Scan, MapBatches, the Func registry and
``Session.run(func, ...)``, the exclusive invocation gate, the
``Procs`` / ``Exclusive`` / ``Materialize`` pragmas and the golden task
graphs. Where both packages run a slice, the same seeded numpy inputs
go through the JAX package (its ``MeshExecutor`` on 8 virtual CPU
devices with ``auto_dense=False``, or its ``LocalExecutor``) and the
port (``MeshExecutor(device="cpu")`` or ``LocalExecutor(device="cpu")``)
and every shard's rows compare exactly.
"""

import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.exec import compile as ref_compile  # noqa: E402
from bigslice_tpu.models import maxint as ref_maxint  # noqa: E402
from bigslice_tpu.models import wordcount as ref_wordcount  # noqa: E402
from bigslice_tpu.ops import func as ref_func  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.exec import compile as port_compile  # noqa: E402
from bigslice_tpu_torch.exec.task import TaskError, iter_tasks  # noqa: E402
from bigslice_tpu_torch.models import maxint as port_maxint  # noqa: E402
from bigslice_tpu_torch.models import wordcount as port_wordcount  # noqa: E402
from bigslice_tpu_torch.ops import func as port_func  # noqa: E402
from bigslice_tpu_torch.typecheck import TypecheckError  # noqa: E402


def add(a, b):
    return a + b


@pytest.fixture(scope="module")
def ref_sessions():
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    mesh = Mesh(np.array(jax.devices()[:8]), ("shards",))
    return {"mesh": Session(executor=MeshExecutor(mesh, auto_dense=False)),
            "local": Session()}


def _port_session(kind, **kw):
    ex = (bst.MeshExecutor(device="cpu", **kw) if kind == "mesh"
          else bst.LocalExecutor(device="cpu", **kw))
    return bst.Session(executor=ex)


def assert_same_shards(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [c.dtype for c in g] == [c.dtype for c in w]
        for gc, wc in zip(g, w):
            if gc.dtype == np.dtype(object):
                assert list(gc) == list(wc)
            else:
                np.testing.assert_array_equal(gc, wc)


def _run_both(ref_sessions, kind, build, *args):
    want = bst.result_shard_rows(
        ref_sessions[kind].run(build(ref_bs), *args))
    got = bst.result_shard_rows(_port_session(kind).run(build(bst), *args))
    assert_same_shards(got, want)
    return got


def _keys(n=2000, span=150, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, span, n).astype(np.int32),
            rng.randint(-100, 100, n).astype(np.int32))


# -- Reshard --------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mesh", "local"])
def test_reshard(ref_sessions, kind):
    """tests/test_slice.py's test_reshard, then a Reduce over a Reshard
    to more shards, each shard equal to the JAX package's."""
    s = bst.Const(2, np.arange(10, dtype=np.int32))
    r = bst.Reshard(s, 5)
    assert r.num_shards == 5 and r.deps()[0].shuffle
    assert bst.Reshard(s, 2) is s  # the identity
    assert sorted(_port_session(kind).run(r).rows()) == [
        (i,) for i in range(10)]
    keys, _ = _keys()
    got = _run_both(ref_sessions, kind, lambda bs: bs.Reduce(
        bs.Reshard(bs.Const(4, keys, np.ones(len(keys), np.int32)), 16),
        add))
    assert len(got) == 16
    bc = np.bincount(keys)
    assert {int(k): int(v) for sh in got for k, v in zip(*sh)} == {
        int(k): int(bc[k]) for k in np.nonzero(bc)[0]}


def test_reshard_typechecks():
    with pytest.raises(TypecheckError, match="num_shards must be >= 1"):
        bst.Reshard(bst.Const(2, np.arange(4, dtype=np.int32)), 0)


# -- Prefixed / Unwrap ------------------------------------------------------


def test_prefixed_unwrap():
    """tests/test_slice.py's test_prefixed_unwrap."""
    s = bst.Const(2, np.array([1, 2], np.int32), np.array([3, 4], np.int32),
                  np.array([5, 6], np.int32))
    p = bst.Prefixed(s, 2)
    assert p.schema.prefix == 2 and list(p.schema) == list(s.schema)
    assert bst.Unwrap(p) is s
    assert bst.Unwrap(bst.Prefixed(p, 3)) is s
    assert bst.Unwrap(s) is s
    with pytest.raises(TypecheckError, match="at least one column"):
        bst.Prefixed(s, 0)
    with pytest.raises(TypecheckError, match="greater than number"):
        bst.Prefixed(s, 4)


@pytest.mark.parametrize("kind", ["mesh", "local"])
def test_reduce_over_prefixed(ref_sessions, kind):
    """A two-column key: routed and combined by both columns."""
    keys, vals = _keys()
    k2 = (keys * 7 + vals) % 5

    def build(bs):
        return bs.Reduce(bs.Prefixed(bs.Const(4, keys, k2, vals), 2), add)

    got = _run_both(ref_sessions, kind, build)
    assert sum(len(sh[0]) for sh in got) == len(set(zip(keys.tolist(),
                                                        k2.tolist())))


@pytest.mark.parametrize("kind", ["mesh", "local"])
def test_prefixed_result_is_reused(kind):
    """A Prefixed over a Result reuses the Result's tasks."""
    sess = _port_session(kind)
    keys, vals = _keys(200)
    res = sess.run(bst.Const(2, keys, vals))
    out = sess.run(bst.Map(bst.Prefixed(res, 2), lambda k, v: (k, v * 2)))
    tasks = iter_tasks(out.tasks)
    assert set(res.tasks) <= set(tasks)
    assert len(tasks) == len(res.tasks) + 2
    assert sorted(out.rows()) == sorted(zip(keys.tolist(),
                                            (vals * 2).tolist()))


# -- Scan -----------------------------------------------------------------


def test_scan_sink(ref_sessions):
    """tests/test_slice.py's test_scan_sink: each shard's rows reach the
    sink, and the slice is empty."""
    counts = {"port": {}, "ref": {}}

    def sink(tag):
        def fn(shard, reader):
            counts[tag][shard] = sum(len(f) for f in reader)
        return fn

    keys, _ = _keys(40)
    assert _port_session("local").run(
        bst.Scan(bst.Const(4, keys), sink("port"))).rows() == []
    assert ref_sessions["local"].run(
        ref_bs.Scan(ref_bs.Const(4, keys), sink("ref"))).rows() == []
    assert counts["port"] == counts["ref"]
    assert sum(counts["port"].values()) == 40 and len(counts["port"]) == 4


@pytest.mark.parametrize("drain", [True, False])
def test_scan_drain(ref_sessions, drain):
    """A sink that returns without reading: by default the stream is
    drained, so an upstream WriterFunc sees every row; ``drain=False``
    leaves it unread, so the WriterFunc sees nothing."""
    seen = {"port": [], "ref": []}
    for tag, bs, sess in (("port", bst, _port_session("local")),
                          ("ref", ref_bs, ref_sessions["local"])):
        w = bs.WriterFunc(bs.Const(3, np.arange(30, dtype=np.int32)),
                          lambda shard, frame, tag=tag:
                          seen[tag].extend(frame.rows()))
        assert sess.run(bs.Scan(w, lambda shard, reader: None,
                                drain=drain)).rows() == []
    assert sorted(seen["port"]) == sorted(seen["ref"])
    assert len(seen["port"]) == (30 if drain else 0)


def test_device_executor_refuses_scan_and_mapbatches_by_name(ref_sessions):
    """Scan and MapBatches, which only the local executor lowers, run on
    the device executor's host tier (its inner LocalExecutor), as on the
    JAX package's MeshExecutor: a MapBatches feeding a device Reduce
    (host output staged onto the device) equals the JAX package's
    shards, and a Scan over a device Reduce (device output read through
    the store bridge) sees every shard's rows."""
    keys, vals = _keys()
    _run_both(ref_sessions, "mesh", lambda bs: bs.Reduce(bs.MapBatches(
        bs.Const(4, keys, vals), lambda f: (f.cols[0], f.cols[1] * 2),
        out=[np.int32, np.int32]), add))
    seen = {"port": {}, "ref": {}}

    def sink(tag):
        def fn(shard, reader):
            seen[tag][shard] = sorted(
                tuple(int(x) for x in r) for f in reader for r in f.rows())
        return fn

    for tag, bs, sess in (("port", bst, _port_session("mesh")),
                          ("ref", ref_bs, ref_sessions["mesh"])):
        red = bs.Reduce(bs.Const(4, keys, vals), add)
        assert sess.run(bs.Scan(red, sink(tag))).rows() == []
    assert seen["port"] == seen["ref"]
    sums = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        sums[k] = sums.get(k, 0) + v
    assert sorted(r for rows in seen["port"].values() for r in rows) == \
        sorted(sums.items())


# -- MapBatches -------------------------------------------------------------


def test_mapbatches(ref_sessions):
    """A vectorized host function over whole frames: a device column
    cast to its declared dtype, and a str column that a Reduce then
    combines on the host."""
    keys, vals = _keys()

    def build(bs):
        m = bs.MapBatches(bs.Const(4, keys, vals),
                          lambda f: (f.cols[0], f.cols[1] * 2),
                          out=[np.int32, np.float32])
        return bs.Reduce(m, add)

    _run_both(ref_sessions, "local", build)

    def words(f):
        return (np.array([f"w{k % 13}" for k in np.asarray(f.cols[0])],
                         dtype=object), f.cols[1])

    _run_both(ref_sessions, "local", lambda bs: bs.Reduce(
        bs.MapBatches(bs.Const(4, keys, vals), words, out=[str, np.int32]),
        add))


def test_mapbatches_frame_is_on_the_host_and_columns_conform():
    seen = []

    def fn(f):
        seen.append(all(c.device.type == "cpu" for c in f.cols))
        return bst.Frame([f.cols[0].numpy().astype(np.int64)])

    res = _port_session("local").run(bst.MapBatches(
        bst.Const(2, np.arange(6, dtype=np.int32)), fn, out=[np.int16]))
    assert all(seen) and seen
    for f in res.frames():
        assert f.cols[0].dtype == torch.int16
    bad = bst.MapBatches(bst.Const(2, np.arange(6, dtype=np.int32)),
                         lambda f: (f.cols[0], f.cols[0]), out=[np.int32])
    with pytest.raises(TaskError) as ei:
        _port_session("local").run(bad)
    assert isinstance(ei.value.cause, TypecheckError)
    assert "returned 2 columns but out= declares 1" in str(ei.value.cause)


# -- the Func registry and Session.run(func, ...) ---------------------------


@pytest.mark.parametrize("kind", ["mesh", "local"])
def test_func_registry_and_run(ref_sessions, kind):
    """tests/test_slice.py's test_func_registry_and_run, in both
    packages: each keeps its own registry."""
    n_ref = len(ref_func.registered())

    def define(bs):
        @bs.func
        def pipeline(n):
            return bs.Map(bs.Const(2, np.arange(n, dtype=np.int32)),
                          lambda x: x + 1)
        return pipeline

    port_pipeline = define(bst)
    assert isinstance(port_pipeline, bst.Func)
    assert port_func.registered()[-1] is port_pipeline
    assert len(ref_func.registered()) == n_ref  # not the JAX package's
    res = _port_session(kind).run(port_pipeline, 5)
    assert sorted(res.rows()) == [(i + 1,) for i in range(5)]
    want = ref_sessions[kind].run(define(ref_bs), 5)
    assert sorted(res.rows()) == sorted(want.rows())


def test_func_invocations():
    @bst.func
    def twice(n):
        return bst.Map(bst.Const(1, np.arange(n, dtype=np.int32)),
                       lambda x: x * 2)

    inv = twice.invocation(3)
    assert isinstance(inv, bst.Invocation) and inv.args == (3,)
    assert repr(inv) == f"Invocation#{inv.index}(twice)"
    assert twice.invocation(3).index > inv.index
    assert isinstance(twice(3), bst.Slice)  # a direct call builds the DAG
    res = _port_session("local").run(twice, 3)
    assert res.tasks[0].name.inv_index > inv.index
    assert sorted(res.rows()) == [(0,), (2,), (4,)]

    @bst.func
    def not_a_slice():
        return 3

    with pytest.raises(TypecheckError, match="returned int, expected a Slice"):
        _port_session("local").run(not_a_slice)
    with pytest.raises(TypecheckError, match="expected Func, Slice or "
                                             "callable"):
        _port_session("local").run(3)


def test_registry_digest_locations_and_diff():
    before = port_func.registry_digest()
    locs = port_func.func_locations()

    @bst.func(exclusive=True)
    def registered_late():
        return bst.Const(1, np.arange(2, dtype=np.int32))

    assert registered_late.exclusive
    assert registered_late.index == len(port_func.registered()) - 1
    assert port_func.registry_digest() != before
    mine = port_func.func_locations()
    assert mine[:-1] == locs
    assert mine[-1].endswith(": registered_late")
    assert mine[-1].split(":")[0].endswith("test_torch_api.py")
    assert port_func.registry_diff(mine, mine) == ""
    diff = port_func.registry_diff(mine, locs)
    want = ref_func.registry_diff(mine, locs)
    assert diff == want
    assert f"+ [{len(mine) - 1}] {mine[-1]}  (only on this process)" in diff
    # One process agrees with itself.
    assert port_func.process_count() == 1
    assert port_func.verify_registry_across_hosts() is None


def test_int_max_func_matches_reference(ref_sessions):
    keys, vals = _keys(3000, 300, 7)
    want = bst.result_shard_rows(ref_sessions["mesh"].run(
        ref_maxint.int_max_func, 4, keys, vals))
    got = bst.result_shard_rows(_port_session("mesh").run(
        port_maxint.int_max_func, 4, keys, vals))
    assert_same_shards(got, want)
    mx = np.full(300, np.iinfo(np.int32).min, np.int32)
    np.maximum.at(mx, keys, vals)
    assert {int(k): int(v) for sh in got for k, v in zip(*sh)} == {
        int(k): int(mx[k]) for k in np.unique(keys)}


def test_wordcount_func_matches_reference(ref_sessions, tmp_path):
    path = tmp_path / "corpus.txt"
    rng = np.random.RandomState(3)
    path.write_text("".join(" ".join(f"w{j}" for j in rng.zipf(1.5, 6) % 50)
                            + "\n" for _ in range(300)))
    want = bst.result_shard_rows(ref_sessions["local"].run(
        ref_wordcount.wordcount_func, 3, str(path)))
    got = bst.result_shard_rows(_port_session("local").run(
        port_wordcount.wordcount_func, 3, str(path)))
    assert_same_shards(got, want)


def test_exclusive_func_isolates_invocation():
    """tests/test_slice.py's test_exclusive_func_isolates_invocation on
    the port's local executor: an exclusive Func's run overlaps no other
    run of the session, its own shards still run in parallel, and the
    shared slice is untouched."""
    shared = bst.Const(2, np.array([1, 2, 1, 2], np.int32),
                       np.ones(4, dtype=np.int32))
    intervals = {}
    ilock = threading.Lock()

    def track(tag):
        def fn(k, v):
            t0 = time.perf_counter()
            time.sleep(0.05)
            with ilock:
                intervals.setdefault(tag, []).append(
                    (t0, time.perf_counter()))
            return (int(k), int(v))
        return fn

    @bst.func(exclusive=True)
    def excl():
        return bst.Map(shared, track("excl"), out=[np.int32, np.int32],
                       mode="host")

    sess = _port_session("local")
    results = {}

    def normal_run():
        results["normal"] = sess.run(
            bst.Map(shared, track("norm"), out=[np.int32, np.int32],
                    mode="host")).rows()

    threads = [threading.Thread(target=normal_run) for _ in range(2)]
    for t in threads:
        t.start()
    results["excl"] = sess.run(excl).rows()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert sorted(results["excl"]) == [(1, 1), (1, 1), (2, 1), (2, 1)]
    assert sorted(results["normal"]) == sorted(results["excl"])
    for es, ee in intervals["excl"]:
        for ns, ne in intervals.get("norm", []):
            assert ee <= ns or ne <= es, "exclusive run overlapped normal"
    assert not shared.exclusive


# -- pragmas ------------------------------------------------------------------


def test_pragmas_compose_and_stamp_tasks():
    s = bst.Const(2, np.array([1, 2], np.int32))
    m = bst.Map(s, lambda x: x + 1)
    assert m.procs == 1 and not m.exclusive and not m.materialize
    s.pragmas = (bst.Procs(3), bst.Procs(2))
    r = bst.Reduce(bst.Map(s, lambda x: (x, x)), add)
    assert r.procs == 3 and not r.exclusive
    r.pragmas = r.pragmas + (bst.Exclusive(),)
    assert r.exclusive and r.procs == 3
    assert bst.Procs(0).procs == 1
    tasks = port_compile.Compiler(1).compile(r)
    assert all(t.procs == 3 and t.exclusive for t in tasks)
    producers = [t for t in iter_tasks(tasks) if t not in tasks]
    assert all(t.procs == 3 and not t.exclusive for t in producers)


def test_materialize_breaks_the_pipeline():
    s = bst.Const(2, np.arange(4, dtype=np.int32))
    m = bst.Map(s, lambda x: x + 1)
    m.pragmas = (bst.Materialize(),)
    m2 = bst.Map(m, lambda x: x * 2)
    tasks = port_compile.Compiler(1).compile(m2)
    assert len(iter_tasks(tasks)) == 4  # two levels of 2 shards
    for kind in ("mesh", "local"):
        assert sorted(_port_session(kind).run(m2).rows()) == [
            (2,), (4,), (6,), (8,)]


#: How long a task of the concurrency test waits for its peers.
RENDEZVOUS_S = 5.0


@pytest.mark.parametrize("pragma,most", [(None, 4), (bst.Procs(2), 2),
                                         (bst.Procs(9), 1),
                                         (bst.Exclusive(), 1)])
def test_procs_and_exclusive_bound_concurrency(pragma, most):
    """Eight one-row tasks on ``LocalExecutor(procs=4)``: the most that
    run at once is ``procs`` over each task's permits.

    The overlap is proved by a bounded rendezvous, not by timing: each
    task waits (up to ``RENDEZVOUS_S``) until ``min(most, 2)`` tasks have
    been inside at once, so a loaded machine that schedules the worker
    threads late cannot keep them apart. Each then holds its permits
    for 0.1 s, as before the rendezvous, so that a run past the bound
    would overlap and show."""
    cond = threading.Condition()
    state = {"now": 0, "peak": 0}
    target = min(most, 2)

    def slow(x):
        with cond:
            state["now"] += 1
            state["peak"] = max(state["peak"], state["now"])
            cond.notify_all()
            cond.wait_for(lambda: state["peak"] >= target,
                          timeout=RENDEZVOUS_S)
        time.sleep(0.1)
        with cond:
            state["now"] -= 1
        return (x,)

    m = bst.Map(bst.Const(8, np.arange(8, dtype=np.int32)), slow,
                out=[np.int32], mode="host")
    if pragma is not None:
        m.pragmas = (pragma,)
    res = _port_session("local", procs=4).run(m)
    assert sorted(res.rows()) == [(i,) for i in range(8)]
    assert 1 <= state["peak"] <= most
    if most > 1:
        assert state["peak"] > 1


# -- the golden task graphs -------------------------------------------------


def _golden_builders():
    def trivial(bs):
        return bs.Map(bs.Const(2, np.arange(4, dtype=np.int32)),
                      lambda x: x + 1)

    def shuffle(bs):
        return bs.Reduce(bs.Const(2, np.arange(4, dtype=np.int32),
                                  np.ones(4, dtype=np.int32)), add)

    def waved_reduce(bs):
        return bs.Reduce(bs.Const(12, np.arange(48, dtype=np.int32),
                                  np.ones(48, dtype=np.int32)), add)

    def branch_shuffle(bs):
        s = bs.Const(2, np.arange(4, dtype=np.int32),
                     np.ones(4, dtype=np.int32))
        return bs.Cogroup(s, bs.Reduce(s, add))

    def reshuffle_chain(bs):
        return bs.Map(bs.Reshuffle(bs.Const(3, np.arange(9, dtype=np.int32))),
                      lambda x: x + 1)

    def branch_materialize(bs):
        s = bs.Const(2, np.arange(4, dtype=np.int32),
                     np.ones(4, dtype=np.int32))
        m = bs.Map(s, lambda k, v: (k, v + 1))
        m.pragmas = (bs.Materialize(),)
        return bs.Cogroup(bs.Map(m, lambda k, v: (k, v * 2)),
                          bs.Filter(m, lambda k, v: k > 0))

    def different_partitions(bs):
        s = bs.Const(2, np.arange(8, dtype=np.int32),
                     np.ones(8, dtype=np.int32))
        b = bs.Reshard(bs.Prefixed(s, 1), 3)
        return bs.Cogroup(bs.Reduce(s, add),
                          bs.Map(b, lambda k, v: (k, v)))

    def attend_chain(bs):
        # The attend stage breaks the pipeline once (its broadcast dep)
        # and keeps the maps before and after it fused.
        q = np.random.RandomState(0).randn(32, 8).astype(np.float32)
        s = bs.Const(4, q, q, q)
        att = bs.SelfAttend(bs.Map(s, lambda a, b, c: (a, b, c * 2)),
                            causal=True)
        return bs.Map(att, lambda o: (o,))

    return {"trivial": trivial, "shuffle": shuffle,
            "attend-chain": attend_chain,
            "waved-reduce": waved_reduce, "branch-shuffle": branch_shuffle,
            "reshuffle-chain": reshuffle_chain,
            "branch-materialize": branch_materialize,
            "different-partitions": different_partitions}


def test_golden_cases_cover_the_testdata():
    """Every golden graph has a case here or in the Cogroup and join
    tests."""
    names = {f[: -len(".graph")] for f in os.listdir(
        os.path.join(os.path.dirname(__file__), "testdata"))
        if f.endswith(".graph")}
    assert names == set(_golden_builders()) | {"attend-chain", "cogroup",
                                               "join-aggregate"}


@pytest.mark.parametrize("name", sorted(_golden_builders()))
def test_golden_graph(name):
    """The port's task graph equals the golden file and the JAX
    package's ``graph_string``."""
    build = _golden_builders()[name]
    got = port_compile.graph_string(
        port_compile.Compiler(1).compile(build(bst)), locations=False)
    want = ref_compile.graph_string(
        ref_compile.Compiler(1).compile(build(ref_bs)), locations=False)
    with open(os.path.join(os.path.dirname(__file__), "testdata",
                           f"{name}.graph")) as fh:
        golden = fh.read()
    assert got == golden == want
