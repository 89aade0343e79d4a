"""User metrics through the port, held to the JAX package: counters
merged task → Result.scope on both executors, the tier verdict of a
function that touches a counter, the loud refusal of an explicit device
mode, and the small stats and top-n helpers (tests/test_aux.py's
metrics, stats and topn cases)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu import slicetest as ref_slicetest  # noqa: E402
from bigslice_tpu.exec.session import Session as RefSession  # noqa: E402
from bigslice_tpu.typecheck import TypecheckError as RefTypecheckError  # noqa: E402,E501
from bigslice_tpu.utils import metrics as ref_metrics  # noqa: E402
from bigslice_tpu.utils import stats as ref_stats  # noqa: E402
from bigslice_tpu.utils import topn as ref_topn  # noqa: E402

import bigslice_tpu_torch as bs  # noqa: E402
from bigslice_tpu_torch import slicetest  # noqa: E402
from bigslice_tpu_torch.typecheck import TypecheckError  # noqa: E402
from bigslice_tpu_torch.utils import metrics, stats, topn  # noqa: E402

N = 1000


def _ref_mesh_session():
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor

    mesh = Mesh(np.array(jax.devices()[:4]), ("shards",))
    return RefSession(executor=MeshExecutor(mesh))


PORT_SESSIONS = {
    "local": lambda: bs.Session(executor=bs.LocalExecutor(device="cpu")),
    "mesh": lambda: bs.Session(executor=bs.MeshExecutor(device="cpu")),
}
REF_SESSIONS = {
    "local": RefSession,
    "mesh": _ref_mesh_session,
}


def _counting_map(mod, bsmod, counter, vals):
    def count_row(x):
        counter.incr()
        return (x, x * np.int32(2))

    return bsmod.Map(bsmod.Const(4, vals), count_row,
                     out=[np.int32, np.int32])


def test_metrics_flow_task_to_result():
    """A host Map over str rows: each row's increment lands in the
    result's scope, as in the JAX package."""
    words = ["a", "b", "c", "d", "e"]
    got = {}
    for name, bsmod, mmod, run in (
            ("port", bs, metrics,
             lambda s: slicetest.run(s, session=PORT_SESSIONS["local"]())),
            ("ref", ref_bs, ref_metrics, ref_slicetest.run)):
        counter = mmod.new_counter(f"rows_seen_{name}")

        def count_row(x, counter=counter):
            counter.incr()
            return (x,)

        res = run(bsmod.Map(bsmod.Const(3, words), count_row, out=[str]))
        got[name] = counter.value(res.scope)
    assert got["port"] == got["ref"] == len(words)


@pytest.mark.parametrize("executor", sorted(PORT_SESSIONS))
def test_metrics_exact_counts_device_columns(executor):
    """A counter inside a Map over device columns counts rows exactly on
    both executors: the trace probe sends the function to the host tier
    in both packages, and the counts and the data agree."""
    vals = np.arange(N, dtype=np.int32)
    c_port = metrics.new_counter(f"device_rows_{executor}")
    c_ref = ref_metrics.new_counter(f"device_rows_{executor}")
    m_port = _counting_map(torch, bs, c_port, vals)
    m_ref = _counting_map(np, ref_bs, c_ref, vals)
    assert m_port.mode == m_ref.mode == "host"
    res_port = PORT_SESSIONS[executor]().run(m_port)
    res_ref = REF_SESSIONS[executor]().run(m_ref)
    assert c_port.value(res_port.scope) == c_ref.value(res_ref.scope) == N
    assert res_port.scope.snapshot() == res_ref.scope.snapshot()
    total_port = sum(r[1] for r in res_port.rows())
    total_ref = sum(int(r[1]) for r in res_ref.rows())
    assert total_port == total_ref == 2 * sum(range(N))


@pytest.mark.parametrize("out", [None, [np.int32]], ids=["auto", "out"])
def test_metrics_tier_verdict_matches_the_jax_package(out):
    """A function that touches a counter is host tier in both packages
    (and without out= it is refused, with the metrics reason in the
    port); one that does not stays device tier."""
    c_port = metrics.new_counter("verdict_port")
    c_ref = ref_metrics.new_counter("verdict_ref")

    def touches(c):
        def fn(x):
            c.incr()
            return x * 2
        return fn

    vals = np.arange(8, dtype=np.int32)
    if out is None:
        with pytest.raises(TypecheckError, match="metrics"):
            bs.Map(bs.Const(2, vals), touches(c_port))
        with pytest.raises(RefTypecheckError):
            ref_bs.Map(ref_bs.Const(2, vals), touches(c_ref))
    else:
        assert bs.Map(bs.Const(2, vals), touches(c_port),
                      out=out).mode == "host"
        assert ref_bs.Map(ref_bs.Const(2, vals), touches(c_ref),
                          out=out).mode == "host"
    assert bs.Map(bs.Const(2, vals), lambda x: x * 2).mode == "device"
    assert ref_bs.Map(ref_bs.Const(2, vals), lambda x: x * 2).mode == "jax"


def test_metrics_explicit_device_mode_rejected_loudly():
    """mode="device" with a counter raises a TypecheckError that names
    metrics, as the JAX package's mode="jax" does."""
    c_port = metrics.new_counter("loud_port")
    c_ref = ref_metrics.new_counter("loud_ref")

    def touches(c):
        def fn(x):
            c.incr()
            return x * 2
        return fn

    vals = np.arange(8, dtype=np.int32)
    with pytest.raises(TypecheckError, match="metrics"):
        bs.Map(bs.Const(2, vals), touches(c_port), mode="device")
    with pytest.raises(RefTypecheckError, match="metrics"):
        ref_bs.Map(ref_bs.Const(2, vals), touches(c_ref), mode="jax")


def test_counter_outside_a_task_counts_nothing():
    c = metrics.new_counter("loose")
    c.incr(5)  # no scope installed: dropped, as in the JAX package
    rc = ref_metrics.new_counter("loose_ref")
    rc.incr(5)
    assert metrics.current_scope() is None
    assert ref_metrics.current_scope() is None


def test_metrics_merge():
    for mod in (metrics, ref_metrics):
        c = mod.new_counter("m")
        s1, s2 = mod.Scope(), mod.Scope()
        s1.incr(c, 2)
        s2.incr(c, 3)
        s1.merge(s2)
        assert s1.value(c) == 5
        assert s1.snapshot()["m"] == 5
        s1.reset()
        assert s1.value(c) == 0


def test_trace_probe_records_touch_and_counts_nothing():
    c = metrics.new_counter("probe")
    probe = metrics.TraceProbe()
    with metrics.scope_context(probe):
        c.incr(3)
    assert probe.touched and probe.value(c) == 0


def test_stats_map():
    for mod in (stats, ref_stats):
        m = mod.Map()
        m.incr("read", 10)
        m.incr("read", 5)
        assert m.get("read") == 15
        assert m.snapshot() == {"read": 15}
    assert repr(stats.Map()) == repr(ref_stats.Map())


def test_topn():
    rng = np.random.RandomState(7)
    pairs = [(float(s), f"item{i}") for i, s in
             enumerate(rng.randint(0, 50, 200))]
    assert topn.top_n(pairs, 5) == ref_topn.top_n(pairs, 5)
    t = topn.TopN(3)
    for s, it in pairs[:10]:
        t.add(s, it)
    assert len(t.items()) == 3
