"""The port's chaos and recovery plane on the CPU, mirroring the JAX
package's ``tests/test_chaos.py`` (without the elastic mesh recovery,
which the port does not have): seeded plans over the seams of the
stores, the codec, the staging arena and its upload, the device
executor's dispatch and the evaluator; the store tier's quarantine and
retries; the mesh chaos matrix; the spill exchange's sites; the infra
classifier and probation; cooperative cancellation between waves; and
the ``chaosslice`` CLI. Every run under a plan equals the JAX package's
fault-free result on the same seeded numpy inputs."""

import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu.exec.session import Session as RefSession  # noqa: E402
from bigslice_tpu_torch.exec import store as store_mod  # noqa: E402
from bigslice_tpu_torch.exec.local import LocalExecutor  # noqa: E402
from bigslice_tpu_torch.exec.meshexec import (  # noqa: E402
    HostLostError, MeshExecutor, _looks_like_infra_error)
from bigslice_tpu_torch.exec.session import Session  # noqa: E402
from bigslice_tpu_torch.exec.task import (TaskError, TaskName,  # noqa: E402
                                          TaskState, iter_tasks)
from bigslice_tpu_torch.utils import faultinject  # noqa: E402


def _add(a, b):
    return a + b


@pytest.fixture
def chaos():
    """Install a seeded plan for the test; always cleared after."""
    def _install(spec):
        return faultinject.install(faultinject.parse_plan(spec))

    faultinject.clear()
    yield _install
    faultinject.clear()


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("BIGSLICE_SHUFFLE", "BIGSLICE_CODED", "BIGSLICE_ADAPTIVE",
              "BIGSLICE_CHAOS", "BIGSLICE_SPILL_DIR"):
        monkeypatch.delenv(k, raising=False)


def _keyed(rows=800, nkeys=41, seed=11):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, nkeys, rows).astype(np.int32),
            rng.randint(0, 100, rows).astype(np.int32))


_REF = {}


def _ref_reduce(shards, keys, vals):
    """The JAX package's fault-free Reduce on its default session (its
    local executor): a key -> sum dict."""
    k = (shards, keys.tobytes(), vals.tobytes())
    if k not in _REF:
        res = RefSession().run(
            ref_bs.Reduce(ref_bs.Const(shards, keys, vals), _add))
        _REF[k] = {int(a): int(b) for a, b in res.rows()}
    return _REF[k]


def _rows(res):
    return {int(a): int(b) for a, b in res.rows()}


# -- the store tier: quarantine, retries, prefetch isolation --------------


def _put_one(store, name, rows=64):
    frames = list(bst.Const(1, np.arange(rows, dtype=np.int32)).reader(0, []))
    store.put(name, 0, frames)
    return [tuple(r) for f in frames for r in f.rows()]


def test_injected_codec_corruption_quarantines(tmp_path, chaos):
    store = store_mod.FileStore(str(tmp_path))
    name = TaskName(0, "op", 0, 1)
    _put_one(store, name)
    chaos("3:codec.read=1.0x1~truncate")
    with pytest.raises(store_mod.Missing):
        list(store.read(name, 0))
    assert store.quarantined == 1
    assert not store.committed(name, 0)


def test_io_read_transient_retried(tmp_path, chaos):
    store = store_mod.FileStore(str(tmp_path))
    name = TaskName(0, "op", 0, 1)
    rows = _put_one(store, name)
    chaos("3:io.read=1.0x2")
    got = [tuple(r) for f in store.read(name, 0) for r in f.rows()]
    assert got == rows


def test_io_retries_exhaust(tmp_path, chaos, monkeypatch):
    monkeypatch.setenv("BIGSLICE_IO_RETRIES", "0")
    monkeypatch.setenv("BIGSLICE_IO_BACKOFF", "0")
    store = store_mod.FileStore(str(tmp_path))
    name = TaskName(0, "op", 0, 1)
    _put_one(store, name)
    chaos("3:io.read=1.0x1")
    with pytest.raises(faultinject.InjectedIOError):
        list(store.read(name, 0))


@pytest.mark.parametrize("site", ["store.put", "io.commit"])
def test_write_transients_retried(tmp_path, chaos, site):
    plan = chaos(f"3:{site}=1.0x2")
    store = store_mod.FileStore(str(tmp_path))
    name = TaskName(0, "op", 0, 1)
    rows = _put_one(store, name)
    got = [tuple(r) for f in store.read(name, 0) for r in f.rows()]
    assert got == rows and plan.snapshot()["injected"] == {site: 2}


def test_memory_store_read_loss_is_missing(chaos):
    store = store_mod.MemoryStore()
    name = TaskName(0, "op", 0, 1)
    _put_one(store, name)
    chaos("3:store.read=1.0x1")
    with pytest.raises(store_mod.Missing) as ei:
        store.read(name, 0)
    assert ei.value.fault_site == "store.read"
    assert not store.committed(name, 0)


def _wait_warm(store, key, bound=10.0):
    """Wait (bounded) for the prefetch worker to settle ``key``."""
    deadline = time.monotonic() + bound
    while time.monotonic() < deadline:
        with store._warm_lock:
            if key in store._warm and not store._warm_pending:
                return True
        time.sleep(0.005)
    return False


def test_prefetch_worker_survives_poisoned_item(tmp_path):
    store = store_mod.FileStore(str(tmp_path))
    bad = TaskName(0, "bad", 0, 1)
    good = TaskName(0, "good", 0, 1)
    _put_one(store, bad)
    rows = _put_one(store, good)
    orig = store._prefetch_one

    def poisoned(key, gen):
        if key[0] == bad:
            raise RuntimeError("poisoned prefetch bookkeeping")
        return orig(key, gen)

    store._prefetch_one = poisoned
    store.prefetch(bad, 0)
    store.prefetch(good, 0)
    assert _wait_warm(store, (good, 0))
    got = [tuple(r) for f in store.read(good, 0) for r in f.rows()]
    assert got == rows
    assert list(store.read(bad, 0))
    store._prefetch_one = orig
    store.discard(good)
    _put_one(store, good)
    store.prefetch(good, 0)
    assert _wait_warm(store, (good, 0))


# -- full-plan runs: the local executor -----------------------------------


LOCAL_SPEC = ("7:store.read=0.15x5,codec.read=0.2x3~flip,io.read=0.3x4,"
              "store.put=0.3x3,eval.resubmit=0.1x2")


def test_local_chaos_plan_recovers_bit_identical(tmp_path, chaos):
    keys, vals = _keyed(rows=4000, nkeys=97)
    want = _ref_reduce(8, keys, vals)

    def run(store_dir):
        sess = Session(executor=LocalExecutor(
            device="cpu", procs=4, store=store_mod.FileStore(str(store_dir))))
        return _rows(sess.run(bst.Reduce(bst.Const(8, keys, vals), _add))), \
            sess

    base, _ = run(tmp_path / "base")
    assert base == want
    plan = chaos(LOCAL_SPEC)
    got, sess = run(tmp_path / "chaos")
    assert got == want
    snap = plan.snapshot()
    assert sum(snap["injected"].values()) > 0
    summary = sess.telemetry_summary()
    rec = summary["recovery"]
    assert rec["recovered_total"] > 0 and rec["fatal_total"] == 0
    assert "store.read" in rec["by_site"]
    assert summary["chaos"]["injected"] == snap["injected"]
    assert sess.executor.store.quarantined > 0
    text = sess.telemetry.prometheus_text()
    assert "bigslice_fault_injected_total" in text
    assert 'bigslice_task_recovered_total{site="store.read"}' in text
    assert "bigslice_task_recovery_seconds" in text
    flight = sess.telemetry.flight_doc()
    assert flight["chaos"]["seed"] == 7


class FlakyStore(store_mod.MemoryStore):
    """Drops committed outputs on read at random (the chaos monkey of
    the reference's test): the run must recover by resubmission."""

    def __init__(self, rng, loss_rate=0.04, max_losses=8):
        super().__init__()
        self.rng = rng
        self.loss_rate = loss_rate
        self.losses = 0
        self.max_losses = max_losses
        self._flock = threading.Lock()

    def read(self, name, partition):
        with self._flock:
            sabotage = (self.losses < self.max_losses
                        and self.rng.rand() < self.loss_rate)
            if sabotage:
                self.losses += 1
        if sabotage:
            self.discard(name)
        return super().read(name, partition)


def test_reduce_survives_random_output_loss(monkeypatch):
    from bigslice_tpu_torch.exec import evaluate as evaluate_mod

    monkeypatch.setattr(evaluate_mod, "MAX_CONSECUTIVE_LOST", 25)
    store = FlakyStore(np.random.RandomState(0))
    sess = Session(executor=LocalExecutor(device="cpu", procs=4,
                                          store=store))
    keys = np.arange(2000, dtype=np.int32) % 97
    vals = np.ones(2000, dtype=np.int32)
    res = sess.run(bst.Reduce(bst.Const(10, keys, vals), _add))
    assert _rows(res) == _ref_reduce(10, keys, vals)
    assert store.losses > 0
    assert sess.telemetry_summary()["recovery"]["by_site"]["organic"][
        "recovered"] > 0


# -- full-plan runs: the device executor (the chaos matrix) ---------------


MESH_CHAOS_SPEC = ("5:mesh.dispatch=1.0x1~infra,staging.assemble=1.0x2,"
                   "shuffle.upload=1.0x2,store.read=0.25x4,"
                   "eval.resubmit=0.15x2")


def _mesh_run(prefetch, arena, keys, vals, **ex):
    sess = Session(executor=MeshExecutor(
        device="cpu", prefetch_depth=prefetch, staging_arena=arena, **ex))
    res = sess.run(bst.Reduce(bst.Const(8, keys, vals), _add))
    return _rows(res), sess


@pytest.mark.parametrize("arena", [True, False], ids=["arena", "noarena"])
@pytest.mark.parametrize("prefetch", [0, 2], ids=["pf0", "pf2"])
def test_mesh_chaos_matrix(prefetch, arena, chaos):
    """An infra fault at dispatch (probation: the op's resubmissions run
    on the host tier), staging and upload transients, memory-store
    losses and lost submissions: every setting completes equal to the
    fault-free run and to the JAX package's."""
    keys, vals = _keyed()
    want = _ref_reduce(8, keys, vals)
    base, _ = _mesh_run(prefetch, arena, keys, vals)
    assert base == want
    plan = chaos(MESH_CHAOS_SPEC)
    got, sess = _mesh_run(prefetch, arena, keys, vals)
    assert got == want
    snap = plan.snapshot()
    assert snap["injected"].get("mesh.dispatch") == 1
    assert snap["injected"].get("shuffle.upload") == 2
    if arena:
        assert snap["injected"].get("staging.assemble") == 2
    rec = sess.telemetry_summary()["recovery"]
    assert rec["fatal_total"] == 0
    assert rec["by_site"]["mesh.dispatch"]["recovered"] > 0
    prob = sess.executor.probation
    assert len(prob) == 1
    assert next(iter(prob.values()))["host_runs"] >= 8
    assert sess.executor.staging_arena.stats()["outstanding"] == 0


def test_mesh_chaos_deterministic_replay(chaos):
    """Same seed: the same sorted (site, kind, inv_id) log and results."""
    keys, vals = _keyed()

    def one_run():
        plan = chaos(MESH_CHAOS_SPEC)
        got, _ = _mesh_run(0, True, keys, vals)
        faultinject.clear()
        return got, sorted((e["site"], e["kind"], e["inv_id"])
                           for e in plan.snapshot()["log"])

    got1, log1 = one_run()
    got2, log2 = one_run()
    assert got1 == got2 == _ref_reduce(8, keys, vals)
    assert log1 == log2 and log1


def test_upload_retries_exhausted_return_the_arena_buffers(chaos,
                                                           monkeypatch):
    """With no retries left the upload's error fails the task; the
    arena's buffers come back first (recycle mode, as on the card)."""
    monkeypatch.setenv("BIGSLICE_IO_RETRIES", "0")
    keys, vals = _keyed()
    ex = MeshExecutor(device="cpu", prefetch_depth=0)
    ex.staging_arena.mode = "recycle"
    monkeypatch.setattr(ex.staging_arena, "_alloc",
                        lambda dtype, shape: torch.empty(shape, dtype=dtype))
    chaos("3:shuffle.upload=1.0x1")
    with pytest.raises(TaskError) as ei:
        Session(executor=ex).run(bst.Reduce(bst.Const(4, keys, vals), _add))
    assert faultinject.fault_site_of(ei.value) == "shuffle.upload"
    assert ex.staging_arena.stats()["outstanding"] == 0


def test_hostloss_surfaces_by_name(chaos):
    keys, vals = _keyed()
    plan = chaos("9:mesh.dispatch=1.0x1~hostloss")
    sess = Session(executor=MeshExecutor(device="cpu"))
    with pytest.raises(TaskError) as ei:
        sess.run(bst.Reduce(bst.Const(8, keys, vals), _add))
    assert isinstance(ei.value.cause, HostLostError)
    assert plan.snapshot()["injected"] == {"mesh.dispatch": 1}


def test_slow_dispatch_is_latency_not_loss(chaos, monkeypatch):
    monkeypatch.setenv("BIGSLICE_CHAOS_SLOW_S", "0.01")
    keys, vals = _keyed()
    chaos("4:mesh.dispatch=1.0x2~slow")
    got, sess = _mesh_run(1, True, keys, vals)
    assert got == _ref_reduce(8, keys, vals)
    assert sess.telemetry_summary().get("recovery") is None
    assert sess.executor.probation == {}


# -- the infra classifier (strings as torch prints them) ------------------


INFRA = [
    "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
    "capacity of 79.11 GiB of which 1.06 GiB is free. Of the allocated "
    "memory 76.47 GiB is allocated by PyTorch, and 1.01 GiB is reserved "
    "by PyTorch but unallocated.",
    "CUDA error: out of memory\nCUDA kernel errors might be "
    "asynchronously reported at some other API call, so the stacktrace "
    "below might be incorrect.",
    "injected device fault: resource_exhausted (mesh.dispatch#0~infra)",
]
STICKY = [
    "CUDA error: an illegal memory access was encountered\nCUDA kernel "
    "errors might be asynchronously reported at some other API call, so "
    "the stacktrace below might be incorrect.\nFor debugging consider "
    "passing CUDA_LAUNCH_BLOCKING=1\nCompile with `TORCH_USE_CUDA_DSA` to "
    "enable device-side assertions.",
    "CUDA error: unspecified launch failure\nCUDA kernel errors might be "
    "asynchronously reported at some other API call",
    "CUDA error: device-side assert triggered\nCompile with "
    "`TORCH_USE_CUDA_DSA` to enable device-side assertions.",
    "CUDA error: misaligned address",
    "CUDA error: an illegal instruction was encountered",
]
USER = ["partitioner returned ids outside [0, 4)", "roadmap dma memory",
        "ValueError: out of range"]


@pytest.mark.parametrize("text", INFRA)
def test_infra_errors_classify(text):
    assert _looks_like_infra_error(RuntimeError(text))
    wrapped = TaskError.__new__(TaskError)
    Exception.__init__(wrapped, "task failed")
    wrapped.cause = RuntimeError(text)
    assert _looks_like_infra_error(wrapped)


@pytest.mark.parametrize("text", STICKY + USER)
def test_sticky_and_user_errors_do_not(text):
    assert not _looks_like_infra_error(RuntimeError(text))


def test_out_of_memory_type_classifies_anywhere_in_the_chain():
    oom = torch.cuda.OutOfMemoryError("allocator said no")
    assert _looks_like_infra_error(oom)
    outer = RuntimeError("wave failed")
    outer.__cause__ = oom
    assert _looks_like_infra_error(outer)
    # A sticky error in the same chain wins: the context is poisoned.
    sticky = RuntimeError("CUDA error: an illegal memory access was "
                          "encountered")
    sticky.__cause__ = oom
    assert not _looks_like_infra_error(sticky)
    # A handled infra error on __context__ does not classify what the
    # handler raised next.
    try:
        try:
            raise oom
        except RuntimeError:
            raise ValueError("a user error")
    except ValueError as e:
        assert not _looks_like_infra_error(e)


def test_real_infra_error_takes_probation(monkeypatch):
    """An out-of-memory error inside a wave: the op goes on probation
    and its tasks rerun on the host tier, equal to the JAX package."""
    keys, vals = _keyed()
    ex = MeshExecutor(device="cpu")
    calls = []
    orig = ex._execute_group

    def oom_once(key, tasks):
        if not calls:
            calls.append(1)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return orig(key, tasks)

    monkeypatch.setattr(ex, "_execute_group", oom_once)
    sess = Session(executor=ex)
    got = _rows(sess.run(bst.Reduce(bst.Const(8, keys, vals), _add)))
    assert got == _ref_reduce(8, keys, vals)
    assert len(ex.probation) == 1
    rec = sess.telemetry_summary()["recovery"]
    assert rec["fatal_total"] == 0 and "organic" in rec["by_site"]


def test_sticky_error_is_fatal_not_probation(monkeypatch):
    keys, vals = _keyed()
    ex = MeshExecutor(device="cpu")

    def sticky(key, tasks):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(ex, "_execute_group", sticky)
    with pytest.raises(TaskError) as ei:
        Session(executor=ex).run(bst.Reduce(bst.Const(8, keys, vals), _add))
    assert "illegal memory access" in str(ei.value.cause)
    assert ex.probation == {}


# -- cooperative cancellation between waves --------------------------------


@pytest.mark.parametrize("prefetch", [0, 2], ids=["pf0", "pf2"])
def test_wave_boundary_cancel_settles_cancelled_then_reruns(prefetch,
                                                            monkeypatch):
    """A cancel asked for mid-group stops it at the next wave boundary
    (CANCELLED, resubmittable); the evaluation's sweep reruns it and the
    result equals the JAX package's. The arena's buffers all return."""
    from bigslice_tpu_torch.exec import evaluate as evaluate_mod
    from bigslice_tpu_torch.exec.compile import compile_slice

    keys, vals = _keyed(rows=1600)
    ex = MeshExecutor(device="cpu", prefetch_depth=prefetch)
    roots = compile_slice(bst.Reduce(bst.Const(8, keys, vals), _add))
    seen = []
    orig = ex._telemetry_compute

    def settled(task0, wave, dur_s):
        # After wave 2 of the first group settles, once: every RUNNING
        # task is asked to stop.
        if wave == 2 and not seen:
            seen.append(task0.name.op)
            for t in iter_tasks(roots):
                if t.state == TaskState.RUNNING:
                    t.request_cancel()
        return orig(task0, wave, dur_s)

    monkeypatch.setattr(ex, "_telemetry_compute", settled)
    monkeypatch.setattr(evaluate_mod, "SWEEP_SECS", 0.05)
    states = []
    evaluate_mod.evaluate(ex, roots,
                          monitor=lambda t, st: states.append(st))
    assert seen and TaskState.CANCELLED in states
    got = {}
    for t in roots:
        for f in ex.reader(t, 0):
            for k, v in f.rows():
                got[int(k)] = int(v)
    assert got == _ref_reduce(8, keys, vals)
    assert ex.staging_arena.stats()["outstanding"] == 0


# -- the spill exchange's sites --------------------------------------------


def _spill_run(keys, vals, **ex):
    sess = Session(executor=MeshExecutor(device="cpu", **ex))
    res = sess.run(bst.Reduce(bst.Const(16, keys, vals), _add))
    return list(map(tuple, res.rows())), sess


@pytest.fixture
def spill_mode(monkeypatch):
    monkeypatch.setenv("BIGSLICE_SHUFFLE", "spill")


def test_spill_write_transient_retried(spill_mode, chaos):
    keys, vals = _keyed()
    base, _ = _spill_run(keys, vals)
    assert dict(base) == _ref_reduce(16, keys, vals)
    plan = chaos("3:spill.write=1.0x2")
    got, sess = _spill_run(keys, vals)
    assert got == base  # raw order included: retried, not degraded
    assert plan.snapshot()["injected"] == {"spill.write": 2}
    assert sess.telemetry_summary().get("recovery") is None
    sess.shutdown()


def test_spill_read_loss_recomputes_bit_identical(spill_mode, chaos):
    keys, vals = _keyed()
    base, _ = _spill_run(keys, vals)
    plan = chaos("5:spill.read=1.0x1")
    got, sess = _spill_run(keys, vals)
    assert got == base and dict(got) == _ref_reduce(16, keys, vals)
    assert plan.snapshot()["injected"] == {"spill.read": 1}
    rec = sess.telemetry_summary()["recovery"]
    assert rec["fatal_total"] == 0
    assert rec["by_site"]["spill.read"]["recovered"] > 0
    sess.shutdown()


def test_spill_corruption_quarantined_and_recovers(spill_mode, chaos):
    keys, vals = _keyed()
    base, _ = _spill_run(keys, vals)
    chaos("9:codec.read=1.0x1~flip")
    got, sess = _spill_run(keys, vals, prefetch_depth=0)
    assert got == base
    assert sess.executor._spill.quarantined >= 1
    sess.shutdown()


# -- the stuck kind without a coded plane ----------------------------------


def test_stuck_task_times_out_to_loss(chaos, monkeypatch):
    """Nothing cancels a stuck task.run with the coded plane off: the
    park ends at STUCK_MAX_S as an injected loss and the run recovers by
    resubmission."""
    monkeypatch.setattr(faultinject, "STUCK_MAX_S", 0.3)
    keys, vals = _keyed(rows=1600, nkeys=41, seed=13)
    plan = chaos("5:task.run=1.0x1~stuck")
    sess = Session(executor=LocalExecutor(device="cpu", procs=4))
    res = sess.run(bst.Reduce(bst.Const(8, keys, vals), _add))
    assert _rows(res) == _ref_reduce(8, keys, vals)
    assert plan.snapshot()["injected"] == {"task.run": 1}
    assert sess.telemetry.coded is None
    rec = sess.telemetry_summary()["recovery"]
    assert rec["by_site"]["task.run"]["recovered"] == 1


def test_no_plan_reaches_no_seam():
    """With no plan, every seam stops at the module flag: ``fire`` and
    ``maybe_raise`` are never called, and the summary and Prometheus
    carry no chaos, coded, adaptive or deadline sample."""
    faultinject.clear()
    before = faultinject.CALLS
    keys, vals = _keyed()
    got, sess = _mesh_run(2, True, keys, vals)
    assert got == _ref_reduce(8, keys, vals)
    local = Session(executor=LocalExecutor(device="cpu"))
    local.run(bst.Reduce(bst.Const(4, keys, vals), _add))
    assert faultinject.CALLS == before
    for s in (sess, local):
        doc = s.telemetry_summary()
        assert not {"chaos", "coded", "adaptive", "deadline"} & set(doc)
        text = s.telemetry.prometheus_text()
        for fam in ("bigslice_fault_injected", "bigslice_coded",
                    "bigslice_adaptive", "bigslice_deadline"):
            assert fam not in text


# -- the chaosslice CLI -----------------------------------------------------


def test_chaosslice_cli_local(tmp_path, capsys):
    from bigslice_tpu_torch.tools import chaosslice

    out_json = tmp_path / "matrix.json"
    rc = chaosslice.main([
        "-chaos", "7:store.read=0.2x3,io.read=0.5x2,codec.read=0.3x1~flip",
        "-rows", "2000", "-shards", "4", "-device", "cpu",
        "-json", str(out_json),
    ])
    captured = capsys.readouterr().out
    assert rc == 0, captured
    assert "recovery matrix" in captured and "bit-identical" in captured
    doc = json.loads(out_json.read_text())
    assert doc["ok"] and doc["bit_identical"] and doc["device"] == "cpu"
    assert any(r["site"] == "store.read" for r in doc["matrix"])
    assert faultinject.active_plan() is None


def test_chaosslice_cli_spill(tmp_path, capsys, monkeypatch):
    from bigslice_tpu_torch.tools import chaosslice

    monkeypatch.setenv("BIGSLICE_SHUFFLE", "spill")
    out_json = tmp_path / "spill-matrix.json"
    rc = chaosslice.main([
        "-chaos", "7:spill.read=0.5x2,spill.write=0.5x2",
        "-rows", "4000", "-shards", "16", "-mesh", "-device", "cpu",
        "-shuffle", "spill", "-json", str(out_json),
    ])
    captured = capsys.readouterr().out
    assert rc == 0, captured
    doc = json.loads(out_json.read_text())
    assert doc["ok"] and doc["bit_identical"] and doc["shuffle"] == "spill"
    assert {r["site"] for r in doc["matrix"]} & {"spill.read", "spill.write"}
    assert os.environ.get("BIGSLICE_SHUFFLE") == "spill"


def test_chaosslice_cli_lists_sites_and_refuses_bad_plans(capsys):
    from bigslice_tpu_torch.tools import chaosslice

    assert chaosslice.main(["-list-sites"]) == 0
    out = capsys.readouterr().out
    assert all(site in out for site in faultinject.SITES)
    assert chaosslice.main(["-chaos", "7:frobnicate=0.5"]) == 2
