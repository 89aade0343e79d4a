"""Status, Chrome trace, eventer and monitor chaining through the port
(tests/test_aux.py's status and trace cases, tests/test_telemetry.py's
tracer and printer cases), held to the JAX package where a run gives
both the same numbers: the task-state counts and the trace's complete
events."""

import io
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.exec.session import Session as RefSession  # noqa: E402
from bigslice_tpu.utils.status import Status as RefStatus  # noqa: E402

import bigslice_tpu_torch as bs  # noqa: E402
from bigslice_tpu_torch.utils import status as status_mod  # noqa: E402
from bigslice_tpu_torch.utils.status import Status, StatusPrinter  # noqa: E402
from bigslice_tpu_torch.utils.trace import Tracer  # noqa: E402


def _local():
    return bs.Session(executor=bs.LocalExecutor(device="cpu"))


@pytest.mark.parametrize("shards", [1, 4])
def test_status_counts_match_the_jax_package(shards):
    """The per-op counts a Status monitor holds after a run: one op,
    every task OK, in both packages; a Reduce adds its second op."""
    vals = np.arange(8, dtype=np.int32)
    counts = {}
    for name, mod, st_cls, make in (
            ("port", bs, Status, lambda m: bs.Session(
                executor=bs.LocalExecutor(device="cpu"), monitor=m)),
            ("ref", ref_bs, RefStatus, lambda m: RefSession(monitor=m))):
        status = st_cls()
        sess = make(status)
        sess.run(mod.Const(shards, vals))
        sess.run(mod.Reduce(mod.Const(shards, vals % 3, vals),
                            lambda a, b: a + b))
        counts[name] = sorted(
            (sorted(states.items())) for states in status.counts().values())
        rendered = status.render()
        assert f"{shards}/{shards} done" in rendered
    assert counts["port"] == counts["ref"]
    assert counts["port"] == [[("OK", shards)]] * 3


def test_session_status_sees_every_task():
    sess = _local()
    sess.run(bs.Const(4, np.arange(8, dtype=np.int32)))
    (op, states), = sess.status.counts().items()
    assert states == {"OK": 4}
    assert sess.status.elapsed(op) >= 0.0


def test_tracer_records_task_events_like_the_jax_package(tmp_path):
    """One complete event a task and the sessionStart instant, in both
    packages' trace files."""
    docs = {}
    for name, mod, make in (
            ("port", bs, lambda p: bs.Session(
                executor=bs.LocalExecutor(device="cpu"), trace_path=p)),
            ("ref", ref_bs, lambda p: RefSession(trace_path=p))):
        path = str(tmp_path / f"{name}.json")
        sess = make(path)
        sess.run(mod.Map(mod.Const(3, np.arange(9, dtype=np.int32)),
                         lambda x: x + 1))
        sess.shutdown()
        with open(path) as fp:
            docs[name] = json.load(fp)
    for doc in docs.values():
        xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        assert len(xs) == 3 and all(e["dur"] >= 0 for e in xs)
        assert any(e["name"] == "bigslice:sessionStart"
                   for e in doc["traceEvents"])
    names = {name: sorted(e["args"]["shard"] for e in doc["traceEvents"]
                          if e["ph"] == "X") for name, doc in docs.items()}
    assert names["port"] == names["ref"] == [0, 1, 2]


def test_mesh_trace_holds_one_event_a_task_and_the_hub_instants(tmp_path):
    path = str(tmp_path / "mesh.json")
    sess = bs.Session(executor=bs.MeshExecutor(device="cpu"),
                      trace_path=path)
    n = 4096
    res = sess.run(bs.Reduce(bs.Const(4, np.arange(n, dtype=np.int32) % 97,
                                      np.ones(n, np.int32)),
                             lambda a, b: a + b))
    assert len(res.rows()) == 97
    sess.shutdown()
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    assert len(xs) == 8  # four Const shards and four Reduce shards
    names = {e["name"] for e in events if e["ph"] == "i"}
    for want in ("bigslice:sessionStart", "bigslice:shuffleSizes",
                 "bigslice:waveStaging", "bigslice:waveRun",
                 "bigslice:hbm", "bigslice:donation"):
        assert want in names, want
    assert any(n.startswith("bigslice:invocation:") for n in names)


def test_tracer_no_tid_collision_after_rebegin():
    t = Tracer()
    t.begin("k1", "a")
    t.begin("k2", "b")
    t.begin("k1", "a-again")  # re-begin: the old k1 lane leaks
    t.begin("k3", "c")        # must not collide with k1's live lane
    live = list(t._tids.values())
    assert len(live) == len(set(live)), live
    t.end("k1")
    t.end("k2")
    t.end("k3")
    for k in ("k4", "k5", "k6", "k7"):
        t.begin(k, k)
    live = list(t._tids.values())
    assert len(live) == len(set(live)), live
    for e in t.events():
        assert e["ph"] == "X" and e["dur"] >= 0


def test_status_printer_prints_final_snapshot_on_stop():
    stream = io.StringIO()
    status = Status()
    printer = StatusPrinter(status, interval=60.0, stream=stream)
    printer.start()
    sess = bs.Session(executor=bs.LocalExecutor(device="cpu"),
                      monitor=status)
    sess.run(bs.Const(3, np.arange(6, dtype=np.int32)))
    assert stream.getvalue() == ""  # the interval never elapsed
    printer.stop()
    out = stream.getvalue()
    assert "3/3 done" in out
    printer.stop()  # unchanged state: no second block
    assert stream.getvalue() == out


def test_session_status_option_prints_on_shutdown(capsys):
    sess = bs.Session(executor=bs.LocalExecutor(device="cpu"), status=True)
    sess.run(bs.Const(2, np.arange(4, dtype=np.int32)))
    sess.shutdown()
    assert "2/2 done" in capsys.readouterr().err


def test_status_render_carries_resources():
    sess = bs.Session(executor=bs.MeshExecutor(device="cpu"))
    sess.run(bs.Reduce(bs.Const(4, np.arange(64, dtype=np.int32) % 7,
                                np.ones(64, np.int32)),
                       lambda a, b: a + b))
    rendered = sess.status.render()
    assert "host rss" in rendered
    assert "device-resident outputs" in rendered
    stats = sess.executor.resource_stats()
    assert stats["resident_output_bytes"] > 0
    assert stats["devices"] == []  # no allocator on the CPU


# ------------------------------------------------- monitor chaining


def test_chain_monitors_forwards_phase_and_drain_to_opted_in_members():
    seen = {"state": [], "phase": [], "drain": []}

    class Full:
        def __call__(self, task, state):
            seen["state"].append(state)

        def on_phase(self, task, phase, wave):
            seen["phase"].append((phase, wave))

        def on_drain_timeout(self, wedged):
            seen["drain"].append(wedged)

    plain = []
    chained = status_mod.chain_monitors(None, Full(),
                                        lambda t, s: plain.append(s))
    chained("task", "RUNNING")
    chained.on_phase("task", "waveCompute", 3)
    chained.on_drain_timeout([{"task": "t", "state": "RUNNING"}])
    assert seen == {"state": ["RUNNING"], "phase": [("waveCompute", 3)],
                    "drain": [[{"task": "t", "state": "RUNNING"}]]}
    assert plain == ["RUNNING"]
    # Members without the channel: the chain exposes none.
    bare = status_mod.chain_monitors(lambda t, s: None)
    assert not hasattr(bare, "on_phase")
    assert not hasattr(bare, "on_drain_timeout")


def test_safe_monitor_call_logs_once_per_callback(capsys):
    def bad(*a):
        raise RuntimeError("always")

    for _ in range(5):
        status_mod.safe_monitor_call(bad, 1, 2)
    err = capsys.readouterr().err
    assert err.count("raised (suppressed") == 1


# ---------------------------------------------------- eventer, corr


def test_eventer_hears_the_session_and_corr_rides_the_result():
    events = []
    lock = threading.Lock()

    def eventer(name, **fields):
        with lock:
            events.append((name, fields))

    sess = bs.Session(executor=bs.LocalExecutor(device="cpu"),
                      eventer=eventer)
    res = sess.run(bs.Const(2, np.arange(4, dtype=np.int32)))
    assert res.corr.startswith("inv")
    res2 = sess.run(bs.Const(2, np.arange(4, dtype=np.int32)), corr="req-7")
    assert res2.corr == "req-7"
    names = [n for n, _ in events]
    assert names[0] == "bigslice:sessionStart"
    assert names.count("bigslice:taskComplete") == 4
    invs = [f for n, f in events if n.startswith("bigslice:invocation:")]
    assert [f["corr"] for f in invs] == [res.corr, "req-7"]
    assert all("test_torch_status_trace.py" in f["location"] for f in invs)


def test_debug_port_and_fleet_scope_raise_by_name():
    """``debug_port`` starts the debug server as the JAX package's does
    (``session.debug`` on a free port, the same routes answering, closed
    at shutdown), ``/debug/fleet`` included; the summary's fleet scope
    (a fleet of one without an exporter) has the JAX package's keys,
    and an unknown scope still raises by name."""
    import urllib.request

    def get(s, path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{s.debug.port}{path}", timeout=10) as r:
            return r.status

    port = bs.Session(executor=bs.LocalExecutor(device="cpu"), debug_port=0)
    ref = RefSession(debug_port=0)
    try:
        for s in (port, ref):
            assert s.debug.port > 0
            assert [get(s, p) for p in ("/debug", "/debug/status",
                                        "/debug/fleet")] == [200, 200, 200]
    finally:
        port.shutdown()
        ref.shutdown()
    sess = _local()
    assert sess.debug is None
    got = sess.telemetry_summary(scope="fleet")
    want = RefSession().telemetry_summary(scope="fleet")
    assert set(got) == set(want)
    assert (got["scope"], got["nranks"], got["ranks"]) == ("fleet", 1, [0])
    with pytest.raises(ValueError, match="unknown scope"):
        sess.telemetry_summary(scope="galaxy")


def test_profiler_trace_run_around_an_evaluation(tmp_path):
    """``trace_run()`` of a profiler with an every-run directory wraps
    one evaluation and writes one loadable trace there."""
    from bigslice_tpu_torch.utils.xprof import Profiler

    d = str(tmp_path / "runs")
    sess = _local()
    prof = Profiler(every_run_dir=d, device="cpu")
    handle = prof.trace_run()
    try:
        sess.run(bs.Map(bs.Const(2, np.arange(64, dtype=np.int32)),
                        lambda x: x * 3))
    finally:
        handle.close()
    files = prof._trace_files(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(str(tmp_path / "runs" / files[0])) as fp:
        assert json.load(fp)["traceEvents"]
