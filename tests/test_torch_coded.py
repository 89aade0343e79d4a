"""The port's coded k-of-n combines (``exec/codedplan.py``) and deadline
ladder on the CPU, held against the JAX package's: the planner, the
stripe and the cover names equal the reference's on a grid of k and r;
an engaged run equals the uncoded one and the JAX package's fault-free
result; r losses complete silently, r + 1 recompute loudly, a stuck
member is cancelled once coverage settles; and ``Session.run(
deadline_s=)`` cancels, drains and raises ``DeadlineExceeded`` with the
JAX package's message. With ``BIGSLICE_CODED`` unset nothing of it
runs."""

import itertools
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu.exec import codedplan as ref_coded  # noqa: E402
from bigslice_tpu.exec.evaluate import \
    DeadlineExceeded as RefDeadlineExceeded  # noqa: E402
from bigslice_tpu.exec.session import Session as RefSession  # noqa: E402
from bigslice_tpu_torch.exec import codedplan  # noqa: E402
from bigslice_tpu_torch.exec.evaluate import DeadlineExceeded  # noqa: E402
from bigslice_tpu_torch.exec.local import LocalExecutor  # noqa: E402
from bigslice_tpu_torch.exec.session import Session  # noqa: E402
from bigslice_tpu_torch.exec.task import TaskState, iter_tasks  # noqa: E402
from bigslice_tpu_torch.utils import faultinject  # noqa: E402


def _add(a, b):
    return a + b


def _keyed(rows=2000, nkeys=37, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, nkeys, rows).astype(np.int32),
            rng.randint(1, 5, rows).astype(np.int32))


def _ref(shards, keys, vals):
    res = RefSession().run(ref_bs.Reduce(ref_bs.Const(shards, keys, vals),
                                         _add))
    return {int(k): int(v) for k, v in res.rows()}


def _rows(res):
    return {int(k): int(v) for k, v in res.rows()}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("BIGSLICE_CODED", "BIGSLICE_CODED_REDUNDANCY",
              "BIGSLICE_ADAPTIVE", "BIGSLICE_CHAOS", "BIGSLICE_SHUFFLE"):
        monkeypatch.delenv(k, raising=False)
    faultinject.clear()
    yield
    faultinject.clear()


# -- the planner, against the reference ------------------------------------


@pytest.mark.parametrize("env", ["", "off", "combine", " COMBINE ",
                                 "parity", "on"])
def test_plan_mode_equals_the_jax_package(env):
    try:
        want = ref_coded.plan_mode(env)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            codedplan.plan_mode(env)
        assert str(got.value) == str(e)
        return
    assert codedplan.plan_mode(env) == want


@pytest.mark.parametrize("env", ["", "1", "3", "0", "-2", "nope"])
def test_redundancy_equals_the_jax_package(env):
    for k in range(1, 70):
        try:
            want = ref_coded.redundancy(k, env)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                codedplan.redundancy(k, env)
            assert str(got.value) == str(e)
            continue
        assert codedplan.redundancy(k, env) == want


@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("k", range(2, 17))
def test_striped_coverage_equals_the_jax_package(k, r):
    grp = codedplan.CoverageGroup(3, "reduce@x:8", k, r)
    ref = ref_coded.CoverageGroup(3, "reduce@x:8", k, r)
    assert grp.n == ref.n == k + r
    for u in range(k):
        assert grp.owners(u) == ref.owners(u)
        assert len(set(grp.owners(u))) == r + 1
    for i in range(grp.n):
        assert grp.covers(i) == ref.covers(i)
        for u in grp.covers(i):
            a, b = grp.cover_name(u, i), ref.cover_name(u, i)
            assert (a.inv_index, a.op, a.shard, a.num_shard) == \
                (b.inv_index, b.op, b.shard, b.num_shard)
    assert sum(len(grp.covers(i)) for i in range(grp.n)) == k * (r + 1)
    # Any r losses leave every unit a live owner.
    pats = [set(range(s, s + r)) for s in range(grp.n - r + 1)]
    pats += [set(p) for p in itertools.islice(
        itertools.combinations(range(grp.n), r), 64)]
    for lost in pats:
        for u in range(k):
            assert any(i not in lost for i in grp.owners(u))


def test_group_for_respects_mode_and_min_k():
    assert codedplan.planner_from_env() is None
    planner = codedplan.CodedPlanner(mode="combine")
    assert planner.group_for(1, "op", 1) is None
    grp = planner.group_for(1, "op", 8)
    assert (grp.k, grp.r) == (8, 1)
    assert planner.stats.count("group") == 1
    assert codedplan.CodedPlanner(mode="off").group_for(1, "op", 8) is None


# -- the knob unset leaves no trace ----------------------------------------


def test_unset_knob_leaves_no_trace():
    sess = Session(executor=LocalExecutor(device="cpu", procs=4))
    assert sess.coded is None and sess.telemetry.coded is None
    keys, vals = _keyed()
    res = sess.run(bst.Reduce(bst.Const(8, keys, vals), _add))
    assert _rows(res) == _ref(8, keys, vals)
    for t in iter_tasks(res.tasks):
        assert getattr(t, "coded_group", None) is None
        assert not any(str(c).startswith("coded:")
                       for c in getattr(t, "partition_config", ()))
        assert "~k" not in t.name.op and "~cov" not in t.name.op
    doc = sess.telemetry.summary()
    assert "coded" not in doc and "deadline" not in doc
    text = sess.telemetry.prometheus_text()
    assert "bigslice_coded" not in text and "bigslice_deadline" not in text


# -- engaged: parity and the lifecycle -------------------------------------


def test_coded_combine_is_bit_identical_to_off(monkeypatch):
    keys, vals = _keyed()

    def run():
        sess = Session(executor=LocalExecutor(device="cpu", procs=4))
        return sess, sorted(sess.run(bst.Reduce(bst.Const(8, keys, vals),
                                                _add)).rows())

    _, off_rows = run()
    monkeypatch.setenv("BIGSLICE_CODED", "combine")
    sess, coded_rows = run()
    assert coded_rows == off_rows
    assert {int(k): int(v) for k, v in coded_rows} == _ref(8, keys, vals)
    st = sess.telemetry.coded
    assert st is not None and st.mode == "combine"
    assert st.count("group") == 1 and st.count("covered") == 1
    assert 8 <= st.count("unit") <= 16
    doc = sess.telemetry.summary()["coded"]
    assert doc["mode"] == "combine" and doc["counts"]["covered"] == 1
    text = sess.telemetry.prometheus_text()
    assert 'bigslice_coded_mode{mode="combine"} 1' in text
    assert 'bigslice_coded_events_total{action="covered"} 1' in text


def test_coded_members_carry_plan_marked_config(monkeypatch):
    monkeypatch.setenv("BIGSLICE_CODED", "combine")
    monkeypatch.setenv("BIGSLICE_CODED_REDUNDANCY", "2")
    keys, vals = _keyed()
    sess = Session(executor=LocalExecutor(device="cpu", procs=4))
    res = sess.run(bst.Reduce(bst.Const(8, keys, vals), _add))
    assert _rows(res) == _ref(8, keys, vals)
    members = [t for t in iter_tasks(res.tasks)
               if getattr(t, "coded_group", None) is not None]
    assert len(members) == 10
    assert (members[0].coded_group.k, members[0].coded_group.r) == (8, 2)
    for t in members:
        assert t.partition_config[-1] == "coded:k8r2"
        assert t.spill_ineligible == "coded coverage partials"


def test_stragglers_cancelled_not_computed(monkeypatch):
    monkeypatch.setenv("BIGSLICE_CODED", "combine")
    keys, vals = _keyed()
    sess = Session(executor=LocalExecutor(device="cpu", procs=2))
    res = sess.run(bst.Reduce(bst.Const(8, keys, vals), _add))
    assert _rows(res) == _ref(8, keys, vals)
    st = sess.telemetry.coded
    members = [t for t in iter_tasks(res.tasks)
               if getattr(t, "coded_group", None) is not None]
    assert {t.state for t in members} <= {TaskState.OK, TaskState.CANCELLED}
    cancelled = sum(t.state == TaskState.CANCELLED for t in members)
    assert st.count("cancelled") >= cancelled
    assert st.count("recovered") == 0


def _coded_reduce(procs=4, shards=8, seed=13):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 41, 1600).astype(np.int32)
    vals = rng.randint(1, 5, 1600).astype(np.int32)
    sess = Session(executor=LocalExecutor(device="cpu", procs=procs))
    res = sess.run(bst.Reduce(bst.Const(shards, keys, vals), _add))
    return sess, res, _ref(shards, keys, vals)


def test_coded_completes_with_exactly_r_losses(monkeypatch):
    monkeypatch.setenv("BIGSLICE_CODED", "combine")
    plan = faultinject.install(faultinject.parse_plan(
        "5:coded.cover=1.0x1~lose"))
    sess, res, want = _coded_reduce()
    assert _rows(res) == want
    assert plan.snapshot()["injected"] == {"coded.cover": 1}
    st = sess.telemetry.coded
    assert st.count("covered") == 1 and st.count("recovered") == 0
    lost = [t for t in iter_tasks(res.tasks)
            if getattr(t, "coded_group", None) is not None
            and t.state == TaskState.LOST]
    assert len(lost) == 1


def test_coded_recomputes_loudly_past_r(monkeypatch):
    monkeypatch.setenv("BIGSLICE_CODED", "combine")
    plan = faultinject.install(faultinject.parse_plan(
        "5:coded.cover=1.0x12~lose"))
    sess, res, want = _coded_reduce()
    assert _rows(res) == want
    assert plan.snapshot()["injected"] == {"coded.cover": 12}
    st = sess.telemetry.coded
    assert st.count("covered") >= 1 and st.count("recovered") > 0


def test_coded_stuck_member_cancelled_on_coverage(monkeypatch):
    monkeypatch.setenv("BIGSLICE_CODED", "combine")
    faultinject.install(faultinject.parse_plan("5:coded.cover=1.0x1~stuck"))
    t0 = time.monotonic()
    sess, res, want = _coded_reduce()
    assert _rows(res) == want
    assert time.monotonic() - t0 < faultinject.STUCK_MAX_S / 2
    st = sess.telemetry.coded
    assert st.count("covered") == 1 and st.count("cancelled") >= 1
    assert any(t.state == TaskState.CANCELLED for t in iter_tasks(res.tasks)
               if getattr(t, "coded_group", None) is not None)


def test_combine_input_lands_in_skew_of_op(monkeypatch):
    keys = np.arange(2000, dtype=np.int32) % 37
    vals = np.ones(2000, dtype=np.int32)

    def run():
        sess = Session(executor=LocalExecutor(device="cpu", procs=4))
        sess.run(bst.Reduce(bst.Const(8, keys, vals), _add))
        ops = [op for op in sess.telemetry._ops
               if "~" not in op and "reduce" not in op]
        assert len(ops) == 1
        return sess.telemetry.skew_of_op(ops[0])

    off = run()
    assert off["combine_input_rows"] == 2000
    assert off["distinct_key_ratio"] == pytest.approx((8 * 37) / 2000)
    monkeypatch.setenv("BIGSLICE_CODED", "combine")
    coded = run()
    assert coded["combine_input_rows"] >= 2000
    assert coded["distinct_key_ratio"] == pytest.approx(
        off["distinct_key_ratio"], rel=0.05)


# -- the deadline ladder ---------------------------------------------------


def test_deadline_message_equals_the_jax_package():
    for d, p in ((0.05, 4), (1.0, 0), (123.456789, 17)):
        assert str(DeadlineExceeded(d, p)) == str(RefDeadlineExceeded(d, p))
        e = DeadlineExceeded(d, p)
        assert (e.deadline_s, e.pending) == (d, p)


def test_deadline_exceeded_cancels_and_raises():
    sess = Session(executor=LocalExecutor(device="cpu", procs=2))

    def slow(k, v):
        time.sleep(0.4)
        return (int(k), int(v))

    keys, vals = _keyed(rows=8)
    sl = bst.Map(bst.Const(4, keys, vals), slow, out=[np.int32, np.int32],
                 mode="host")
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceeded) as ei:
        sess.run(sl, deadline_s=0.05)
    assert ei.value.pending > 0
    assert time.monotonic() - t0 < 15.0
    assert sess.telemetry.deadline.count("expired") == 1
    doc = sess.telemetry.summary()["deadline"]
    assert doc["by_source"].get("session", 0) == 1
    text = sess.telemetry.prometheus_text()
    assert ('bigslice_deadline_outcomes_total{tenant="_session",'
            'outcome="expired"} 1') in text
    # A fresh run with no deadline on the same session completes.
    res = sess.run(bst.Const(2, keys))
    assert sorted(int(r[0]) for r in res.rows()) == sorted(keys.tolist())


def test_deadline_stuck_task_is_cancelled_and_drained(monkeypatch):
    """A stuck task.run under a deadline: the deadline's cancel wakes it
    (an event, not a sleep margin), it lands CANCELLED, and the pending
    census counts every unfinished task."""
    keys, vals = _keyed(rows=400)
    faultinject.install(faultinject.parse_plan("5:task.run=1.0x1~stuck"))
    sess = Session(executor=LocalExecutor(device="cpu", procs=1))
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceeded) as ei:
        sess.run(bst.Reduce(bst.Const(4, keys, vals), _add),
                 deadline_s=0.3)
    assert time.monotonic() - t0 < 0.3 + 10.0
    assert ei.value.pending == 8  # 4 producers and 4 reducers
    faultinject.clear()
    res = sess.run(bst.Reduce(bst.Const(4, keys, vals), _add))
    assert _rows(res) == _ref(4, keys, vals)


def test_deadline_met_and_validation():
    sess = Session(executor=LocalExecutor(device="cpu", procs=4))
    keys, vals = _keyed(rows=400)
    res = sess.run(bst.Reduce(bst.Const(4, keys, vals), _add),
                   deadline_s=120.0)
    assert _rows(res) == _ref(4, keys, vals)
    assert sess.telemetry.deadline.count("met") == 1
    for bad in (0.0, -1):
        with pytest.raises(Exception):
            sess.run(bst.Const(2, keys), deadline_s=bad)
