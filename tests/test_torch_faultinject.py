"""The port's fault-injection plane (``bigslice_tpu_torch/utils/
faultinject.py``) against the JAX package's: the same seed and spec fire
at the same invocation ids, ``parse_plan`` accepts and refuses the same
specs with the same messages, and the injected errors, the ``slow`` and
``stuck`` kinds and the environment switch behave alike. Both modules
are the standard library only; no run of either package is needed."""

import threading
import time

import pytest

pytest.importorskip("torch")

from bigslice_tpu.utils import faultinject as ref_fi  # noqa: E402
from bigslice_tpu_torch.exec.task import (Task, TaskCancelled,  # noqa: E402
                                          TaskName, TaskState)
from bigslice_tpu_torch.utils import faultinject  # noqa: E402


@pytest.fixture(autouse=True)
def _clear():
    faultinject.clear()
    yield
    faultinject.clear()


def _decisions(mod, spec, seq):
    plan = mod.parse_plan(spec)
    out = []
    for site in seq:
        f = plan.fire(site)
        out.append(None if f is None else (f.site, f.kind, f.inv_id))
    return out, plan


SPECS = [
    "7:store.read=0.3x50,io.read=0.2",
    "5:mesh.dispatch=1.0x1~infra,staging.assemble=1.0x2,"
    "shuffle.upload=1.0x2,store.read=0.25x4,eval.resubmit=0.15x2",
    "7:store.read=0.15x5,codec.read=0.2x3~flip,io.read=0.3x4,"
    "store.put=0.3x3,eval.resubmit=0.1x2",
    "9:store.*=0.5x7,codec.*=0.25~truncate,task.run=0.4x3~stuck",
    "11:spill.read=0.5x2,spill.write=0.5x2,coded.cover=0.3~slow",
]


@pytest.mark.parametrize("seed", [0, 1, 7, 13, 12345])
@pytest.mark.parametrize("spec", SPECS)
def test_decisions_equal_the_jax_package(spec, seed):
    """Over a grid of seeds, specs, sites and invocation ids, the port's
    plan fires exactly where the JAX package's does (the decision is
    sha256 of ``seed:site:inv_id``, byte for byte)."""
    spec = f"{seed}:{spec.split(':', 1)[1]}"
    sites = sorted(faultinject.SITES)
    seq = [sites[(i * 7 + i // 3) % len(sites)] for i in range(600)]
    got, plan = _decisions(faultinject, spec, seq)
    want, ref_plan = _decisions(ref_fi, spec, seq)
    assert got == want and any(got)
    strip = [(e["site"], e["kind"], e["inv_id"])
             for e in plan.snapshot()["log"]]
    assert strip == [(e["site"], e["kind"], e["inv_id"])
                     for e in ref_plan.snapshot()["log"]]
    assert plan.snapshot()["calls"] == ref_plan.snapshot()["calls"]


@pytest.mark.parametrize("site", sorted(ref_fi.SITES))
def test_unit_draws_equal_the_jax_package(site):
    for seed in (0, 3, 99):
        for inv in range(0, 2000, 37):
            assert faultinject._unit(seed, site, inv) == \
                ref_fi._unit(seed, site, inv)
            assert faultinject._unit(seed, site + "#slow", inv) == \
                ref_fi._unit(seed, site + "#slow", inv)


def test_site_registry_equals_the_jax_package():
    assert set(faultinject.SITES) == set(ref_fi.SITES)
    assert len(faultinject.SITES) == 14
    for name, info in faultinject.SITES.items():
        assert info["kinds"] == ref_fi.SITES[name]["kinds"]
        assert info["default"] == ref_fi.SITES[name]["default"]


BAD = ["nocolon", "x:io.read=0.5", "7:io.read", "7:frobnicate=0.5",
       "7:io.read=2.0", "7:io.read=0.5~frob", "7:io.read=0.5x-1",
       "7:=0.5", "7:store.read=0.5~slowish", "3:eval.resubmit=0.5~slow"]
GOOD = ["7:store.*=1.0x1", "7:io.read=0.5", "3:peer.lost=1.0x1",
        "3:mesh.dispatch=0.5~hostloss", "3:store.read=0.5~slow",
        "3:task.run=1.0x1~stuck", "4:", "4:io.read=0.5,,", "1:*=0.0"]


@pytest.mark.parametrize("spec", BAD)
def test_bad_specs_fail_with_the_jax_package_message(spec):
    with pytest.raises(ValueError) as got:
        faultinject.parse_plan(spec)
    with pytest.raises(ValueError) as want:
        ref_fi.parse_plan(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", GOOD)
def test_good_specs_parse_as_the_jax_package(spec):
    plan = faultinject.parse_plan(spec)
    ref = ref_fi.parse_plan(spec)
    assert plan.seed == ref.seed
    assert [tuple(r) for r in plan.rules] == [tuple(r) for r in ref.rules]


def test_budget_caps_fires_and_globs_resolve_kinds():
    plan = faultinject.parse_plan("3:io.read=1.0x2")
    fired = [plan.fire("io.read") for _ in range(10)]
    assert sum(f is not None for f in fired) == 2
    assert plan.snapshot()["calls"]["io.read"] == 10
    assert faultinject.parse_plan("7:store.*=1.0x1").fire(
        "store.read").kind == "lose"


def test_injected_errors_carry_their_site():
    e = faultinject.injected_error(faultinject.Fault("io.read", "io", 3))
    assert isinstance(e, IOError) and e.fault_site == "io.read"
    wrapped = RuntimeError("outer")
    wrapped.__cause__ = e
    assert faultinject.fault_site_of(wrapped) == "io.read"
    assert faultinject.fault_site_of(RuntimeError("clean")) is None
    infra = faultinject.injected_error(
        faultinject.Fault("mesh.dispatch", "infra", 0))
    assert isinstance(infra, faultinject.InjectedInfraError)
    assert "resource_exhausted" in str(infra)
    lose = faultinject.injected_error(
        faultinject.Fault("store.read", "lose", 0))
    assert isinstance(lose, faultinject.InjectedLoss)
    # No multi-host plane: a peer loss is a loss, attributed to its site.
    for site, kind in (("peer.lost", "lost"), ("mesh.dispatch",
                                                "hostloss")):
        e = faultinject.injected_error(faultinject.Fault(site, kind, 0))
        assert isinstance(e, faultinject.InjectedLoss)
        assert faultinject.fault_site_of(e) == site
    # The message text is the JAX package's.
    f = faultinject.Fault("io.read", "io", 3)
    assert str(faultinject.injected_error(f)) == \
        str(ref_fi.injected_error(ref_fi.Fault("io.read", "io", 3)))


def test_install_from_env(monkeypatch):
    monkeypatch.setenv("BIGSLICE_CHAOS", "5:io.read=0.5x1")
    plan = faultinject.install_from_env()
    assert plan is not None and plan.seed == 5
    assert faultinject.active_plan() is plan and faultinject.ENABLED
    faultinject.clear()
    assert faultinject.active_plan() is None and not faultinject.ENABLED
    monkeypatch.delenv("BIGSLICE_CHAOS")
    assert faultinject.install_from_env() is None


def test_fire_without_a_plan_is_none_and_counts_calls():
    before = faultinject.CALLS
    assert faultinject.fire("io.read") is None
    faultinject.maybe_raise("io.read")
    assert faultinject.CALLS == before + 2


def test_slow_delays_equal_the_jax_package(monkeypatch):
    monkeypatch.setenv("BIGSLICE_CHAOS_SLOW_S", "0.05")
    faultinject.install(faultinject.parse_plan("7:store.read=1.0x2~slow"))
    ref_fi.install(ref_fi.parse_plan("7:store.read=1.0x2~slow"))
    try:
        for inv in range(20):
            d = faultinject.slow_delay_s(
                faultinject.Fault("store.read", "slow", inv))
            assert d == ref_fi.slow_delay_s(
                ref_fi.Fault("store.read", "slow", inv))
            assert 0.05 <= d <= 0.1
    finally:
        ref_fi.clear()


def test_absorb_slow_sleeps_and_clears(monkeypatch):
    monkeypatch.setenv("BIGSLICE_CHAOS_SLOW_S", "0.02")
    fault = faultinject.Fault("store.read", "slow", 0)
    t0 = time.monotonic()
    assert faultinject.absorb_slow(fault) is None
    assert time.monotonic() - t0 >= 0.02
    lose = faultinject.Fault("store.read", "lose", 0)
    assert faultinject.absorb_slow(lose) is lose
    assert faultinject.absorb_slow(None) is None


def _task():
    t = Task(TaskName(0, "op", 0, 1), do=None, deps=(), partitioner=None,
             schema=None)
    t.set_state(TaskState.RUNNING)
    return t


def test_stuck_parks_until_cancelled():
    """A stuck fault waits on the task's cancel event: cancellation
    wakes it into TaskCancelled (no sleep margin: an event)."""
    task = _task()
    out = []
    parked = threading.Event()

    def body():
        parked.set()
        try:
            faultinject.absorb_slow_or_stuck(
                faultinject.Fault("task.run", "stuck", 0), task)
        except TaskCancelled as e:
            out.append(e)

    th = threading.Thread(target=body)
    th.start()
    assert parked.wait(10)
    task.request_cancel()
    th.join(10)
    assert not th.is_alive() and len(out) == 1


def test_stuck_times_out_to_a_loss(monkeypatch):
    monkeypatch.setattr(faultinject, "STUCK_MAX_S", 0.01)
    with pytest.raises(faultinject.InjectedLoss) as ei:
        faultinject.absorb_slow_or_stuck(
            faultinject.Fault("task.run", "stuck", 0), _task())
    assert ei.value.fault_site == "task.run"
    # A slow fault on a cancelled task wakes at once.
    task = _task()
    task.request_cancel()
    with pytest.raises(TaskCancelled):
        faultinject.absorb_slow_or_stuck(
            faultinject.Fault("task.run", "slow", 0), task)
