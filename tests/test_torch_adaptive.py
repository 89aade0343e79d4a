"""The port's adaptive execution (``exec/adaptive.py``) on the CPU, held
against the JAX package's: ``policies_from_env``, ``skew_split_k`` and
``cost_wave_budget`` equal the reference's on the same inputs; the skew
split's row-slice lanes, the cost policy's measured budget and the spec
policy's speculative race each equal the JAX package's fault-free
result; speculation never races an exclusive, machine-combined or coded
task; and the task state machine's RUNNING → OK / CANCELLED race is
first-wins. With ``BIGSLICE_ADAPTIVE`` unset nothing of it runs."""

import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu.exec import adaptive as ref_adaptive  # noqa: E402
from bigslice_tpu.exec.session import Session as RefSession  # noqa: E402
from bigslice_tpu_torch.exec import adaptive as adaptive_mod  # noqa: E402
from bigslice_tpu_torch.exec.local import LocalExecutor  # noqa: E402
from bigslice_tpu_torch.exec.meshexec import MeshExecutor  # noqa: E402
from bigslice_tpu_torch.exec.session import Session  # noqa: E402
from bigslice_tpu_torch.exec.task import (Task, TaskName,  # noqa: E402
                                          TaskState, iter_tasks)
from bigslice_tpu_torch.utils import faultinject  # noqa: E402


def _add(a, b):
    return a + b


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("BIGSLICE_ADAPTIVE", "BIGSLICE_CODED", "BIGSLICE_CHAOS",
              "BIGSLICE_ADAPTIVE_MAX_SPLIT", "BIGSLICE_ADAPTIVE_HEADROOM",
              "BIGSLICE_SHUFFLE", "BIGSLICE_DEVICE_BUDGET_BYTES"):
        monkeypatch.delenv(k, raising=False)
    faultinject.clear()
    yield
    faultinject.clear()


def _count_oracle(keys):
    res = RefSession().run(ref_bs.Reduce(
        ref_bs.Const(4, keys, np.ones(len(keys), np.int32)), _add))
    return {int(k): int(v) for k, v in res.rows()}


def _skewed_keys(rows=6000, nkeys=64, hot_frac=0.7, seed=7):
    rng = np.random.RandomState(seed)
    return np.where(rng.rand(rows) < hot_frac, 0,
                    rng.randint(0, nkeys, rows)).astype(np.int32)


# -- the planner, against the reference ------------------------------------


@pytest.mark.parametrize("env", ["", "off", "skew", "skew,cost", "spec+cost",
                                 "all", "ALL", " spec ", "frobnicate",
                                 "skew,frobnicate", "skew,,cost"])
def test_policies_from_env_equal_the_jax_package(env):
    try:
        want = ref_adaptive.policies_from_env(env)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            adaptive_mod.policies_from_env(env)
        assert str(got.value) == str(e)
        return
    assert adaptive_mod.policies_from_env(env) == want


def test_planner_from_env_chicken_bit(monkeypatch):
    assert adaptive_mod.planner_from_env() is None
    monkeypatch.setenv("BIGSLICE_ADAPTIVE", "off")
    assert adaptive_mod.planner_from_env() is None
    monkeypatch.setenv("BIGSLICE_ADAPTIVE", "all")
    assert adaptive_mod.planner_from_env().policies == {"skew", "spec",
                                                        "cost"}


class _FakeHub:
    def __init__(self, skew=None, limit=None):
        self._skew = skew or {}
        self.events = []

        class _Dev:
            def hbm_budget(_self):
                return limit

        self.device = _Dev()

    def skew_of_op(self, op):
        return self._skew.get(op)

    def _emit(self, name, **fields):
        self.events.append((name, fields))


def _skew_grid():
    out = []
    for ratio in (1.0, 1.9, 2.0, 3.7, 5.4, 8.0, 23.1, 60.0):
        for flagged in (True, False):
            for max_shard in (0, 2):
                out.append({"prod": {
                    "ratio": ratio, "max_shard": max_shard,
                    "median_rows": 10.0, "total_rows": 9000,
                    "max_rows": 600, "flagged": flagged}})
    return out


@pytest.mark.parametrize("max_split", [None, "4", "2", "16"])
def test_skew_split_k_equals_the_jax_package(max_split, monkeypatch):
    if max_split is not None:
        monkeypatch.setenv("BIGSLICE_ADAPTIVE_MAX_SPLIT", max_split)
    for skew in _skew_grid():
        for policies in ({"skew"}, {"cost"}, {"skew", "spec"}):
            p = adaptive_mod.AdaptivePlanner(_FakeHub(skew=skew), policies)
            r = ref_adaptive.AdaptivePlanner(_FakeHub(skew=skew), policies)
            for cap in (1, 2, 6, 8, 16, 64, 1024):
                for ops in (["prod"], ["other"], ["other", "prod"]):
                    assert p.skew_split_k(ops, cap) == \
                        r.skew_split_k(ops, cap)
            assert p.stats.skew_splits == r.stats.skew_splits


@pytest.mark.parametrize("headroom", [None, 0.5, 0.25, 1.0, 2.0, 0.001])
def test_cost_wave_budget_equals_the_jax_package(headroom):
    for limit in (None, 0, 1 << 15, 1 << 20, 80 * (1 << 30), 12345):
        for policies in ({"cost"}, {"skew"}, {"cost", "spec"}):
            p = adaptive_mod.AdaptivePlanner(_FakeHub(limit=limit),
                                             policies, headroom=headroom)
            r = ref_adaptive.AdaptivePlanner(_FakeHub(limit=limit),
                                             policies, headroom=headroom)
            for op in ("op", "op", None, "other"):
                assert p.cost_wave_budget(op) == r.cost_wave_budget(op)
            assert p.stats.summary()["counts"] == \
                r.stats.summary()["counts"]


def test_stats_bounded_decisions_and_summary():
    st = adaptive_mod.AdaptiveStats({"skew", "spec"})
    for i in range(adaptive_mod.MAX_DECISIONS + 40):
        st.record("skew", "split", op=f"op{i}", k=2)
    st.record("spec", "launched", task="t")
    st.record("spec", "won", task="t")
    doc = st.summary()
    assert doc["policies"] == ["skew", "spec"]
    assert doc["counts"]["skew"]["split"] == adaptive_mod.MAX_DECISIONS + 40
    assert doc["speculative"] == {"launched": 1, "won": 1, "wasted": 0}
    assert len(doc["decisions"]) <= adaptive_mod.MAX_DECISIONS + 2


def test_disengaged_by_default_no_samples():
    sess = Session(executor=LocalExecutor(device="cpu", procs=2))
    assert sess.adaptive is None and sess.telemetry.adaptive is None
    assert getattr(sess.executor, "adaptive", None) is None
    res = sess.run(bst.Const(2, np.arange(64, dtype=np.int32)))
    assert len(res.rows()) == 64
    assert "adaptive" not in sess.telemetry_summary()
    assert "bigslice_adaptive" not in sess.telemetry.prometheus_text()


def test_slow_store_read_degrades_nothing(monkeypatch):
    monkeypatch.setenv("BIGSLICE_CHAOS_SLOW_S", "0.01")
    faultinject.install(faultinject.parse_plan("5:store.read=1.0x3~slow"))
    sess = Session(executor=LocalExecutor(device="cpu", procs=2))
    keys = np.arange(800, dtype=np.int32) % 13
    res = sess.run(bst.Reduce(bst.Const(4, keys, np.ones(800, np.int32)),
                              _add))
    assert {int(k): int(v) for k, v in res.rows()} == _count_oracle(keys)
    assert sess.telemetry_summary().get("recovery") is None


# -- the skew split: parity through the row-slice substrate ---------------


def _skew_pipeline(keys):
    return bst.Reduce(
        bst.Map(bst.Reshuffle(bst.Const(8, keys,
                                        np.ones(len(keys), np.int32))),
                lambda k, v: (k, v + 0)),
        _add)


@pytest.mark.parametrize("arena", [True, False], ids=["arena", "noarena"])
@pytest.mark.parametrize("prefetch", [0, 2], ids=["pf0", "pf2"])
def test_skew_split_bit_parity(arena, prefetch, monkeypatch):
    keys = _skewed_keys()

    def run():
        sess = Session(executor=MeshExecutor(
            device="cpu", staging_arena=arena, prefetch_depth=prefetch))
        return sorted(map(tuple, sess.run(_skew_pipeline(keys)).rows())), \
            sess

    base, base_sess = run()
    assert {int(k): int(v) for k, v in base} == _count_oracle(keys)
    assert base_sess.adaptive is None
    monkeypatch.setenv("BIGSLICE_ADAPTIVE", "skew")
    got, sess = run()
    assert got == base
    st = sess.adaptive.stats
    assert st.skew_splits >= 1
    split = [d for d in st.summary()["decisions"] if d["action"] == "split"]
    assert split[0]["k"] >= 2
    assert split[0]["ratio"] >= sess.telemetry.skew_ratio
    assert any(k >= 2 for k in sess.executor.split_runs.values())
    assert sess.telemetry_summary()["adaptive"]["counts"]["skew"][
        "split"] >= 1
    assert ('bigslice_adaptive_decisions_total{policy="skew",'
            'action="split"}') in sess.telemetry.prometheus_text()


# -- the cost policy ---------------------------------------------------------


def test_cost_budget_shapes_waves_and_prefetch(monkeypatch):
    monkeypatch.setenv("BIGSLICE_ADAPTIVE", "cost")
    sess = Session(executor=MeshExecutor(device="cpu", prefetch_depth=2))
    sess.telemetry.device.record_hbm(0, 0, limit_bytes=1 << 15,
                                     source="test")
    keys = np.random.RandomState(5).randint(0, 97, 20000).astype(np.int32)
    res = sess.run(bst.Reduce(bst.Const(16, keys, np.ones(20000, np.int32)),
                              _add))
    want = RefSession().run(ref_bs.Reduce(ref_bs.Const(
        16, keys, np.ones(20000, np.int32)), _add))
    assert sorted(map(tuple, res.rows())) == sorted(
        (int(k), int(v)) for k, v in want.rows())
    counts = sess.adaptive.stats.summary()["counts"]["cost"]
    assert counts["wave_budget"] >= 1 and counts["wave_split"] >= 1
    assert counts["prefetch_clip"] >= 1
    assert any(k >= 2 for k in sess.executor.split_runs.values())
    budget = [d for d in sess.adaptive.stats.summary()["decisions"]
              if d["action"] == "wave_budget"][0]
    assert budget["budget_bytes"] == 1 << 14
    assert budget["hbm_limit_bytes"] == 1 << 15


def test_static_budget_knob_wins_over_adaptive(monkeypatch):
    monkeypatch.setenv("BIGSLICE_ADAPTIVE", "cost")
    ex = MeshExecutor(device="cpu", device_budget_bytes=1 << 26)
    sess = Session(executor=ex)
    sess.telemetry.device.record_hbm(0, 0, limit_bytes=1 << 15,
                                     source="test")
    res = sess.run(bst.Const(4, np.arange(64, dtype=np.int32)))
    assert len(res.rows()) == 64
    assert ex._wave_budget(res.tasks[0]) == (1 << 26, False)
    assert MeshExecutor(device="cpu")._wave_budget(res.tasks[0]) == \
        (None, False)


# -- speculative stragglers under injected slow reads ---------------------


def _wait(cond, bound=10.0):
    deadline = time.monotonic() + bound
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def _settle(sess, bound=30.0):
    """Wait (bounded) until every permit of the session's pool is back:
    a slowed original finishes its (losing) body on its own thread, and
    must not outlive the test."""
    lim = sess.executor._limiter
    assert _wait(lambda: lim._avail == lim.capacity, bound)


def _spec_session(procs=16):
    sess = Session(executor=LocalExecutor(device="cpu", procs=procs))
    sess.telemetry.straggler_factor = 1.5
    sess.telemetry.straggler_min_secs = 0.05
    sess.telemetry.straggler_min_siblings = 2
    return sess


def test_speculative_race_under_slow_chaos(monkeypatch):
    """Two reads slowed 2-4 s make two stragglers; the watcher races a
    duplicate of each on a free permit (16 permits for 8 tasks: one is
    always free, whatever the machine's load), the atomic RUNNING → OK
    picks the winner, the result equals the JAX package's, and every
    race is attributed."""
    monkeypatch.setenv("BIGSLICE_ADAPTIVE", "spec")
    monkeypatch.setenv("BIGSLICE_ADAPTIVE_POLL_S", "0.005")
    monkeypatch.setenv("BIGSLICE_CHAOS_SLOW_S", "2.0")
    faultinject.install(faultinject.parse_plan("11:store.read=1.0x2~slow"))
    sess = _spec_session()
    keys = np.random.RandomState(3).randint(0, 97, 4000).astype(np.int32)
    res = sess.run(bst.Reduce(bst.Const(8, keys, np.ones(4000, np.int32)),
                              _add))
    want = RefSession().run(ref_bs.Reduce(ref_bs.Const(
        8, keys, np.ones(4000, np.int32)), _add))
    assert {int(k): int(v) for k, v in res.rows()} == \
        {int(k): int(v) for k, v in want.rows()}
    st = sess.adaptive.stats
    assert _wait(lambda: st.speculative_launched >= 1
                 and st.speculative_won + st.speculative_wasted
                 >= st.speculative_launched)
    assert st.speculative_won + st.speculative_wasted == \
        st.speculative_launched
    assert st.speculative_won >= 1
    assert sess.telemetry_summary()["adaptive"]["speculative"][
        "launched"] >= 1
    assert 'bigslice_adaptive_speculative_total{outcome="won"}' in \
        sess.telemetry.prometheus_text()
    _settle(sess)


def test_speculate_refuses_unsafe_tasks():
    ex = LocalExecutor(device="cpu", procs=2)
    sess = Session(executor=ex)
    res = sess.run(bst.Const(2, np.arange(32, dtype=np.int32)))
    task = res.tasks[0]
    assert task.state == TaskState.OK
    assert ex.speculate(task) is False          # not RUNNING
    task._local_tier = False
    assert ex.speculate(task) is False          # not this pool's
    t = Task(TaskName(0, "op", 0, 1), do=None, deps=(),
             partitioner=res.tasks[1].partitioner, schema=None,
             exclusive=True)
    t._local_tier = True
    t.set_state(TaskState.RUNNING)
    assert ex.speculate(t) is False             # exclusive
    # The device executor delegates to its host tier.
    mesh = MeshExecutor(device="cpu")
    assert mesh.speculate(task) is False


def test_executor_speculate_refuses_coded_members(monkeypatch):
    monkeypatch.setenv("BIGSLICE_CODED", "combine")
    sess = Session(executor=LocalExecutor(device="cpu", procs=2))
    keys = np.random.RandomState(5).randint(0, 31, 800).astype(np.int32)
    res = sess.run(bst.Reduce(bst.Const(6, keys, np.ones(800, np.int32)),
                              _add))
    members = [t for t in iter_tasks(res.tasks)
               if getattr(t, "coded_group", None) is not None]
    assert members
    for m in members:
        m._lock.acquire()
        m._state = TaskState.RUNNING  # as if still running
        m._lock.release()
        assert not sess.executor.speculate(m)


def test_spec_watcher_skips_coded_members(monkeypatch):
    monkeypatch.setenv("BIGSLICE_ADAPTIVE", "spec")
    monkeypatch.setenv("BIGSLICE_ADAPTIVE_POLL_S", "0.005")
    monkeypatch.setenv("BIGSLICE_CODED", "combine")
    monkeypatch.setenv("BIGSLICE_CHAOS_SLOW_S", "0.4")
    faultinject.install(faultinject.parse_plan("11:coded.cover=1.0x2~slow"))
    sess = _spec_session()
    keys = np.random.RandomState(3).randint(0, 97, 4000).astype(np.int32)
    res = sess.run(bst.Reduce(bst.Const(8, keys, np.ones(4000, np.int32)),
                              _add))
    assert {int(k): int(v) for k, v in res.rows()} == \
        {int(k): int(v) for k, v in RefSession().run(ref_bs.Reduce(
            ref_bs.Const(8, keys, np.ones(4000, np.int32)), _add)).rows()}
    targets = [d.get("task", "") for d in sess.adaptive.stats.decisions
               if d["policy"] == "spec"]
    assert not any("~k" in t for t in targets), targets
    assert sess.telemetry.coded.count("covered") == 1
    _settle(sess)


def test_cancel_vs_finish_transition_is_first_wins():
    for _ in range(200):
        t = Task(TaskName(0, "op", 0, 1), do=None, deps=[],
                 partitioner=None, schema=None)
        t.set_state(TaskState.RUNNING)
        outcomes = []
        bar = threading.Barrier(2)

        def flip(to, outcomes=outcomes, t=t, bar=bar):
            bar.wait(10)
            outcomes.append((to, t.transition_if(TaskState.RUNNING, to)))

        th = [threading.Thread(target=flip, args=(s,))
              for s in (TaskState.OK, TaskState.CANCELLED)]
        for x in th:
            x.start()
        for x in th:
            x.join(10)
        wins = [to for to, won in outcomes if won]
        assert len(wins) == 1 and t.state == wins[0]


def test_reset_for_retry_clears_the_loss_count():
    """A fatal task returned to INIT for a fresh evaluation starts its
    consecutive-loss count anew (reference exec/task.py:229-236)."""
    t = Task(TaskName(0, "op", 0, 1), do=None, deps=[], partitioner=None,
             schema=None)
    for _ in range(3):
        t.mark_lost(RuntimeError("gone"))
    t.set_state(TaskState.ERR, RuntimeError("fatal"))
    assert t.consecutive_lost == 3
    t.reset_for_retry()
    assert t.state == TaskState.INIT and t.consecutive_lost == 0
