"""The telemetry hub through the port (tests/test_telemetry.py's cases).

Held to the JAX package on the same seeded inputs: the local tier's
per-partition shuffle vectors (rows routed before the combine), the
device tier's per-partition vectors (rows out of the map side's
combine) against a JAX ``MeshExecutor`` with one CPU device a
partition, the skew ratio, hot partition and flag on a hot-key and a
balanced workload, the combine's input counts, and the key set of
``telemetry_summary()``. The straggler, flight-recorder, disabled-hub,
overlap and monitor cases have no JAX value to compare and test the
port alone.
"""

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.exec.session import Session as RefSession  # noqa: E402

import bigslice_tpu_torch as bs  # noqa: E402
from bigslice_tpu_torch.exec.task import TaskName, TaskState  # noqa: E402
from bigslice_tpu_torch.utils import telemetry as telemetry_mod  # noqa: E402

N = 20000


def _ref_mesh(ndev=4, **kw):
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor

    mesh = Mesh(np.array(jax.devices()[:ndev]), ("shards",))
    return RefSession(executor=MeshExecutor(mesh, **kw))


def _hot_keys(n=N):
    keys = np.zeros(n, dtype=np.int32)  # ~90% of rows on key 0
    keys[: n // 10] = np.arange(n // 10, dtype=np.int32) % 97 + 1
    return keys


def _balanced_keys(n=N):
    return np.random.RandomState(3).randint(0, 1 << 14, n).astype(np.int32)


def _skew(summary):
    """The one op of a run that crossed a shuffle boundary."""
    ops = [(op, e["skew"]) for op, e in summary["ops"].items()
           if "skew" in e]
    assert len(ops) == 1, summary["ops"].keys()
    return ops[0]


def _same_verdict(a, b):
    for k in ("rows", "bytes", "total_rows", "median_rows", "ratio",
              "max_shard", "flagged", "boundaries", "per_shard"):
        assert a[k] == b[k], (k, a[k], b[k])


# ------------------------------------------------------------- skew


@pytest.mark.parametrize("workload", ["hot", "balanced"])
def test_local_tier_skew_matches_the_jax_package(workload):
    """Rows routed a partition before the combine, by the local tier of
    both packages, on the same keys: equal vectors, bytes, ratio, hot
    partition and flag; the hot key is flagged, the balanced run not."""
    keys = _hot_keys() if workload == "hot" else _balanced_keys()
    ones = np.ones(N, np.int32)
    sess = bs.Session(executor=bs.LocalExecutor(device="cpu"))
    sess.run(bs.Reduce(bs.Const(8, keys, ones), lambda a, b: a + b))
    ref = RefSession()
    ref.run(ref_bs.Reduce(ref_bs.Const(8, keys, ones), lambda a, b: a + b))
    got, want = sess.telemetry_summary(), ref.telemetry_summary()
    (op, skew), (_, ref_skew) = _skew(got), _skew(want)
    _same_verdict(skew, ref_skew)
    assert sum(skew["rows"]) == N
    if workload == "hot":
        assert got["skew_flagged_ops"] == [op]
        hot = skew["max_shard"]
        assert skew["rows"][hot] >= 0.8 * N
        assert skew["ratio"] >= telemetry_mod.DEFAULT_SKEW_RATIO
    else:
        assert got["skew_flagged_ops"] == [] == want["skew_flagged_ops"]
        assert skew["ratio"] < 2.0


def test_local_tier_combine_input_matches_the_jax_package():
    keys = _hot_keys()
    ones = np.ones(N, np.int32)
    sess = bs.Session(executor=bs.LocalExecutor(device="cpu"))
    sess.run(bs.Reduce(bs.Const(8, keys, ones), lambda a, b: a + b))
    ref = RefSession()
    ref.run(ref_bs.Reduce(ref_bs.Const(8, keys, ones), lambda a, b: a + b))
    op, _ = _skew(sess.telemetry_summary())
    ref_op, _ = _skew(ref.telemetry_summary())
    got = sess.telemetry.skew_of_op(op)
    want = ref.telemetry.skew_of_op(ref_op)
    assert got["combine_input_rows"] == want["combine_input_rows"] == N
    assert got["distinct_key_ratio"] == want["distinct_key_ratio"]
    # Rows out: each shard's distinct keys, summed over the 8 shards.
    distinct = sum(len(np.unique(s)) for s in np.array_split(keys, 8))
    assert got["distinct_key_ratio"] == distinct / N


@pytest.mark.parametrize("workload", ["hot-reduce", "balanced-reduce",
                                      "hot-reshuffle"])
def test_mesh_tier_vectors_match_the_jax_package(workload):
    """The device tier's per-partition vector: rows out of the map
    side's combine (or routed, for a Reshuffle), equal to the JAX
    MeshExecutor's per-device vector on a mesh of one CPU device a
    partition."""
    keys = _balanced_keys() if workload.startswith("balanced") \
        else _hot_keys()
    ones = np.ones(N, np.int32)

    def make(mod):
        src = mod.Const(4, keys, ones)
        if workload.endswith("reshuffle"):
            return mod.Reshuffle(src)
        return mod.Reduce(src, lambda a, b: a + b)

    sess = bs.Session(executor=bs.MeshExecutor(device="cpu",
                                               auto_dense=False))
    res = sess.run(make(bs))
    ref = _ref_mesh(auto_dense=False)
    ref_res = ref.run(make(ref_bs))
    assert sorted(res.rows()) == sorted(
        tuple(int(v) for v in r) for r in ref_res.rows())
    (_, skew), (_, ref_skew) = (_skew(sess.telemetry_summary()),
                                _skew(ref.telemetry_summary()))
    _same_verdict(skew, ref_skew)
    if workload == "hot-reshuffle":
        assert sum(skew["rows"]) == N and skew["flagged"]
    else:
        distinct = sum(len(np.unique(s)) for s in np.array_split(keys, 4))
        assert sum(skew["rows"]) == distinct


def test_hub_record_shuffle_accumulates_elementwise():
    hub = telemetry_mod.TelemetryHub()
    hub.record_shuffle("op1", 1, [10, 10, 10], [80, 80, 80])
    hub.record_shuffle("op1", 1, [90, 10, 10], [720, 80, 80])
    skew = hub.summary()["ops"]["op1"]["skew"]
    assert skew["rows"] == [100, 20, 20]
    assert skew["bytes"] == [800, 160, 160]
    assert skew["max_shard"] == 0
    assert skew["boundaries"] == 2


def test_hub_bounds_op_records():
    hub = telemetry_mod.TelemetryHub()
    for i in range(telemetry_mod.MAX_OPS + 50):
        hub.record_shuffle(f"op{i}", i, [1, 2], [8, 16])
    assert len(hub._ops) == telemetry_mod.MAX_OPS
    assert "op0" not in hub._ops
    assert f"op{telemetry_mod.MAX_OPS + 49}" in hub._ops


def test_status_render_carries_skew_annotation():
    sess = bs.Session(executor=bs.LocalExecutor(device="cpu"))
    sess.run(bs.Reduce(bs.Const(8, _hot_keys(), np.ones(N, np.int32)),
                       lambda a, b: a + b))
    rendered = sess.status.render()
    assert "skew" in rendered and "hot shard" in rendered


# ------------------------------------------------------- stragglers


class _FakeTask:
    def __init__(self, op, shard, num_shard=8, inv=1):
        self.name = TaskName(inv, op, shard, num_shard)
        self.state_times = {}


def test_straggler_flagged_deterministic():
    hub = telemetry_mod.TelemetryHub()
    now = time.monotonic()
    for shard in range(6):
        t = _FakeTask("slowop", shard)
        dur = 1.0 if shard == 5 else 0.1
        t.state_times[TaskState.RUNNING] = now - dur
        hub(t, TaskState.RUNNING)
        hub(t, TaskState.OK)
    s = hub.summary()
    rec = s["ops"]["slowop"]
    assert s["straggler_total"] == 1
    assert rec["stragglers"][0]["shard"] == 5
    assert rec["stragglers"][0]["duration_s"] > 0.9
    assert rec["tasks"]["n"] == 6


def test_straggler_flagged_end_to_end():
    def gen(shard):
        if shard == 5:
            time.sleep(0.5)
        yield ([np.int32(shard)],)

    sess = bs.Session(executor=bs.LocalExecutor(device="cpu"))
    res = sess.run(bs.ReaderFunc(6, gen, out=[np.int32]))
    assert len(res.rows()) == 6
    stragglers = [s for e in sess.telemetry_summary()["ops"].values()
                  for s in e.get("stragglers", ())]
    assert any(s["shard"] == 5 for s in stragglers)


def test_live_straggler_detection():
    hub = telemetry_mod.TelemetryHub()
    now = time.monotonic()
    for shard in range(5):
        t = _FakeTask("liveop", shard)
        t.state_times[TaskState.RUNNING] = now - 0.01
        hub(t, TaskState.RUNNING)
        hub(t, TaskState.OK)
    hung = _FakeTask("liveop", 7)
    hung.state_times[TaskState.RUNNING] = now - 5.0
    hub(hung, TaskState.RUNNING)
    live = hub.live_stragglers()
    assert len(live) == 1 and live[0]["shard"] == 7
    assert any("straggler" in ln for ln in hub.status_lines())


# ----------------------------------------------------- wave overlap


@pytest.mark.parametrize("depth", [0, 1])
def test_wave_overlap_equals_staging_seconds(depth):
    """A waved reduce's staging records: all exposed on the serial loop,
    a valid fraction hidden when pipelined, and the hub's totals equal
    MeshExecutor.staging_seconds() over the same waves."""
    n = 1 << 13
    keys = np.random.RandomState(42).randint(0, 1 << 18, n).astype(np.int32)
    ex = bs.MeshExecutor(device="cpu", prefetch_depth=depth,
                         auto_dense=False)
    sess = bs.Session(executor=ex)
    res = sess.run(bs.Reduce(bs.Const(16, keys, np.ones(n, np.int32)),
                             lambda a, b: a + b))
    assert sum(len(f) for f in res.frames()) == len(np.unique(keys))
    s = sess.telemetry_summary()
    waves = [e["waves"] for e in s["ops"].values() if "waves" in e]
    assert waves and all(w["n_waves"] == 16 for w in waves)
    clock = ex.staging_seconds()
    assert sum(w["staged"] for w in waves) == clock["waves"]
    assert sum(w["staging_s"] for w in waves) == pytest.approx(
        clock["staged_s"], abs=1e-5)
    assert sum(w["exposed_s"] for w in waves) == pytest.approx(
        clock["exposed_s"], abs=1e-5)
    assert sum(w["hidden_s"] for w in waves) == pytest.approx(
        clock["hidden_s"], abs=1e-5)
    for w in waves:
        assert w["compute_s"] > 0
        if depth == 0:
            assert w["overlap_efficiency"] == 0.0
            assert w["phases"] == {}
        else:
            assert 0.0 <= w["overlap_efficiency"] <= 1.0
            assert w["phases"]["waveCompute"] == 16
            assert w["phases"]["wavePrefetch"] == 15
    assert s["overlap_efficiency"] is not None


# ------------------------------------------------ monitor hardening


def test_raising_monitor_does_not_break_evaluation(capsys):
    class BadMonitor:
        def __call__(self, task, state):
            raise RuntimeError("broken monitor")

        def on_phase(self, task, phase, wave):
            raise RuntimeError("broken phase monitor")

    sess = bs.Session(executor=bs.LocalExecutor(device="cpu"),
                      monitor=BadMonitor())
    res = sess.run(bs.Const(4, np.arange(8, dtype=np.int32)))
    assert len(res.rows()) == 8
    assert sess.telemetry_summary()["task_states"].get("OK") == 4
    assert "4/4 done" in sess.status.render()
    err = capsys.readouterr().err
    assert "broken monitor" in err
    assert err.count("raised (suppressed") == 1


def test_raising_phase_monitor_does_not_break_waved_run():
    class BadPhase:
        def __call__(self, task, state):
            pass

        def on_phase(self, task, phase, wave):
            raise RuntimeError("phase boom")

    sess = bs.Session(executor=bs.MeshExecutor(device="cpu"),
                      monitor=BadPhase())
    n = 1 << 12
    keys = np.arange(n, dtype=np.int32) % 257
    res = sess.run(bs.Reduce(bs.Const(16, keys, np.ones(n, np.int32)),
                             lambda a, b: a + b))
    assert sum(len(f) for f in res.frames()) == 257


# ------------------------------------------------------- the summary


def test_summary_keys_match_the_jax_package():
    """The summary's key set equals the JAX package's on the same run,
    less the keys that wait for later slices (none on a plain run: the
    deadline stats stay absent; the fleet merge is a scope of its
    own)."""
    keys = _hot_keys()
    ones = np.ones(N, np.int32)
    sess = bs.Session(executor=bs.LocalExecutor(device="cpu"))
    sess.run(bs.Reduce(bs.Const(4, keys, ones), lambda a, b: a + b))
    ref = RefSession()
    ref.run(ref_bs.Reduce(ref_bs.Const(4, keys, ones), lambda a, b: a + b))
    got, want = sess.telemetry_summary(), ref.telemetry_summary()
    waiting = {"deadline", "chaos"}  # A8: the deadline ladder, faults
    assert set(got) == set(want) - waiting
    assert set(want["device"]) <= set(got["device"])
    json.dumps(got)
    (_, skew), (_, ref_skew) = _skew(got), _skew(want)
    assert set(skew) == set(ref_skew)


def test_disabled_hub_is_noop(monkeypatch):
    monkeypatch.setenv("BIGSLICE_TELEMETRY", "0")
    ex = bs.MeshExecutor(device="cpu")
    sess = bs.Session(executor=ex)
    assert sess.telemetry is None
    n = 4096
    res = sess.run(bs.Reduce(
        bs.Const(16, np.arange(n, dtype=np.int32) % 531,
                 np.ones(n, np.int32)),
        lambda a, b: a + b))
    assert sum(len(f) for f in res.frames()) == 531
    assert sess.telemetry_summary() == {}
    # The programs were built without the per-partition counts.
    assert all(getattr(o, "part_rows", None) is None
               for o in ex._outputs.values())


def test_prometheus_text_carries_the_families():
    sess = bs.Session(executor=bs.MeshExecutor(device="cpu"))
    n = 4096
    sess.run(bs.Reduce(bs.Const(8, np.arange(n, dtype=np.int32) % 97,
                                np.ones(n, np.int32)),
                       lambda a, b: a + b))
    text = sess.telemetry.prometheus_text()
    for family in ("bigslice_task_state_total",
                   "bigslice_op_skew_ratio",
                   "bigslice_shuffle_partition_rows_bucket",
                   "bigslice_wave_overlap_efficiency",
                   "bigslice_kernel_launches_total", "bigslice_hbm_bytes",
                   "bigslice_host_rss_bytes"):
        assert family in text, family


def test_flight_recorder_dump_on_fatal(tmp_path, monkeypatch):
    import glob

    monkeypatch.setenv("BIGSLICE_FLIGHTREC_DIR", str(tmp_path))

    def boom(x):
        raise ValueError("injected fatal for flightrec")

    sess = bs.Session(executor=bs.LocalExecutor(device="cpu"))
    with pytest.raises(Exception):
        sess.run(bs.Map(bs.Const(2, np.arange(8, dtype=np.int32)),
                        boom, out=[np.int32]))
    dumps = glob.glob(str(tmp_path / "flightrec-*.json"))
    assert dumps
    with open(dumps[0]) as fp:
        doc = json.load(fp)
    assert "injected fatal for flightrec" in doc["reason"]
    assert doc["task_states"]
    assert isinstance(doc["events"], list)


def test_flight_recorder_noop_without_dir(monkeypatch):
    monkeypatch.delenv("BIGSLICE_FLIGHTREC_DIR", raising=False)
    hub = telemetry_mod.TelemetryHub()
    hub._emit("bigslice:test", op="x")
    assert hub.dump_flight_record(inv=1, reason="r") is None


def test_flight_recorder_ring_is_bounded(tmp_path):
    hub = telemetry_mod.TelemetryHub()
    for i in range(telemetry_mod.FLIGHT_MAX_EVENTS + 100):
        hub._emit("bigslice:test", inv=i % 3, i=i)
    doc = hub.flight_doc()
    assert len(doc["events"]) == telemetry_mod.FLIGHT_MAX_EVENTS
    assert doc["events"][-1]["i"] == telemetry_mod.FLIGHT_MAX_EVENTS + 99
    only1 = hub.flight_doc(inv=1)["events"]
    assert only1 and all(e["inv"] == 1 for e in only1)
    path = hub.dump_flight_record(inv=1, reason="x", out_dir=str(tmp_path))
    # Deduped per invocation: a second dump returns the first file.
    assert hub.dump_flight_record(inv=1, reason="y",
                                  out_dir=str(tmp_path)) == path


def test_drain_timeout_reaches_the_hub():
    hub = telemetry_mod.TelemetryHub()
    hub.on_drain_timeout([{"task": "inv1/x@1:0", "state": "RUNNING"}])
    s = hub.summary()
    assert s["drain"]["timeouts"] == 1
    assert s["drain"]["wedged"][0]["state"] == "RUNNING"
