"""The device half of the telemetry hub through the port
(tests/test_devicetelemetry.py's and tests/test_telemetry.py's device
cases): the kernels' declared cost and its attribution to ops, builds,
the program cache, HBM watermarks (the CUDA allocator's stats
monkeypatched, the executor's tensors on the CPU), ``hbm_budget`` and
the spill planner's use of it, donation, and the windowed profiler on
``torch.profiler``. A CPU run has no kernel launch to compare with the
JAX package, so these test the port alone; the launches themselves are
held against ``LAUNCHES`` on the card (tests/test_torch_kernels_gpu.py).
"""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu_torch as bs  # noqa: E402
from bigslice_tpu_torch.exec import shuffleplan  # noqa: E402
from bigslice_tpu_torch.parallel import cuda_kernels as ck  # noqa: E402
from bigslice_tpu_torch.utils import devicetelemetry as dt  # noqa: E402
from bigslice_tpu_torch.utils import resources  # noqa: E402
from bigslice_tpu_torch.utils.devicetelemetry import DeviceTelemetry  # noqa: E402,E501
from bigslice_tpu_torch.utils.xprof import Profiler, ProfilerBusy  # noqa: E402


# ------------------------------------------------------- kernel cost


@pytest.mark.parametrize("n,valid,counts", [(1 << 23, True, False),
                                            (1 << 25, False, True),
                                            (1000, True, True)])
def test_hash_partition_cost_is_the_byte_model(n, valid, counts):
    """K1's declared bytes: each key byte, the mask and the int32 id of
    a row, plus the int32 histogram: the model chip_smoke.py's phase 2
    holds the kernel's time against."""
    key = torch.zeros(n, dtype=torch.int32)
    ids = torch.zeros(n, dtype=torch.int32)
    want = key.nbytes + ids.nbytes + (n if valid else 0) + (16 if counts
                                                             else 0)
    c = ck.cost("hash_partition", n=n, key_itemsizes=(4,), valid=valid,
                nparts=4, with_counts=counts)
    assert c["bytes"] == want
    assert c["flops"] == n * 10


def test_hash_aggregate_cost_is_the_byte_model():
    n, nparts, R = 1 << 23, 4, 1 << 21
    T = nparts * R
    c = ck.cost("hash_aggregate", n=n, key_itemsizes=(4,),
                val_itemsizes=(4,), nparts=nparts, R=R)
    # valid, key, value and part in; presence, key and value out.
    assert c["bytes"] == n * (1 + 4 + 4 + 4) + T * (1 + 4 + 4)
    c2 = ck.cost("hash_aggregate", n=10, key_itemsizes=(4, 4),
                 val_itemsizes=(4, 4, 4), nparts=1, R=16)
    assert c2["bytes"] == 10 * (1 + 8 + 12 + 4) + 16 * (1 + 8 + 12)
    assert ck.cost("probe_add1", numel=1024) == {"bytes": 8192,
                                                 "flops": 1024}
    with pytest.raises(ValueError):
        ck.cost("no_such_kernel")


def test_launch_sink_attributes_each_counted_launch(monkeypatch):
    """A counted launch inside ``launch_sink`` reaches the sink with its
    declared cost at the increment of LAUNCHES, and nowhere else."""
    monkeypatch.setattr(ck, "LAUNCHES", dict(ck.LAUNCHES))
    ck.reset_launches()
    dev = DeviceTelemetry()
    heard = []

    def sink(name, cost):
        heard.append(name)
        dev.record_launch("op", 1, name, cost)

    with ck.launch_sink(sink):
        ck._count("hash_partition", n=8, key_itemsizes=(4,), valid=True,
                  nparts=2, with_counts=False)
        with ck.launch_sink(None):
            pass  # a no-op block keeps the outer sink
        ck._count("probe_add1", numel=16)
    ck._count("probe_add1", numel=16)  # outside: counted, not heard
    assert heard == ["hash_partition", "probe_add1"]
    assert ck.LAUNCHES["probe_add1"] == 2
    s = dev.summary()
    assert {k: v["launches"] for k, v in s["kernels"]["op"].items()} == {
        "hash_partition": 1, "probe_add1": 1}
    assert s["kernels"]["op"]["hash_partition"] == {
        "launches": 1, "bytes": 8 * 9.0, "flops": 8 * 10.0}
    assert s["totals"]["launches"] == 2
    assert s["totals"]["bytes_accessed"] == 72 + 128


def test_a_cpu_run_launches_no_kernel():
    """On the CPU the wrappers take the plain versions: no launch, no
    kernel record, while the rest of the device plane fills in."""
    sess = bs.Session(executor=bs.MeshExecutor(device="cpu"))
    n = 4096
    sess.run(bs.Reduce(bs.Const(4, np.arange(n, dtype=np.int32) % 97,
                                np.ones(n, np.int32)),
                       lambda a, b: a + b))
    d = sess.telemetry_summary()["device"]
    assert d["kernels"] == {} and d["totals"]["launches"] == 0
    assert d["compile"] == {} and d["hbm"]


# ------------------------------------------------- builds, programs


def test_builds_are_reported():
    """The native host kernels' first-use builds (cc, by digest) reach
    the device summary: the first load either built the .so or found
    it."""
    from bigslice_tpu_torch import native

    native.rungs()
    builds = dt.build_records()
    names = [b["name"] for b in builds]
    assert any(n.startswith("native-") for n in names), builds
    for b in builds:
        assert b["wall_s"] >= 0 and isinstance(b["cache_hit"], bool)
    assert DeviceTelemetry().summary()["builds"] == builds


def test_program_cache_is_not_applicable():
    """The JAX package's program cache compiles XLA executables; the
    port compiles no wave program, so the per-op compile records stay
    empty. What the cache accounts applies all the same: on a waved run
    the summary's ``program_cache`` is the process-wide stats dict with
    the JAX package's keys, and the device totals count the wave
    programs built after a miss and the session-local hits."""
    from bigslice_tpu.serve.programcache import ProgramCache as RefCache

    sess = bs.Session(executor=bs.MeshExecutor(device="cpu",
                                               auto_dense=False))
    n = 1 << 12
    keys = np.random.RandomState(3).randint(0, 1 << 16, n).astype(np.int32)
    res = sess.run(bs.Reduce(bs.Const(8, keys, np.ones(n, np.int32)),
                             lambda a, b: a + b))
    assert len(res.rows()) == len(np.unique(keys))
    summary = sess.telemetry_summary()
    pc = summary["program_cache"]
    assert set(pc) == set(RefCache(capacity=4).stats())
    assert pc["enabled"] and pc["entries"] >= 1
    assert summary["device"]["compile"] == {}
    totals = summary["device"]["totals"]
    assert not {"compiles", "compile_s"} & set(totals)
    # Two ops, eight waves each (a wave's rerun calls its program
    # again): every call after an op's first at its input shape is a
    # session-local hit.
    assert totals["program_builds"] + totals["cross_session_hits"] >= 2
    assert totals["cache_hits"] >= 1
    assert (totals["program_builds"] + totals["cross_session_hits"]
            + totals["cache_hits"]) >= 16


def test_summary_totals_roll_up():
    dev = DeviceTelemetry()
    dev.record_launch("a", 1, "hash_partition", {"bytes": 100, "flops": 7})
    dev.record_launch("b", 1, "hash_aggregate", {"bytes": 50, "flops": 3})
    dev.record_donation("a", 1, 1000, 500, 2, 1)
    dev.record_donation("b", 1, 1000, 1000, 2, 2)
    t = dev.summary()["totals"]
    assert t["launches"] == 2
    assert t["bytes_accessed"] == 150 and t["flops"] == 10
    assert t["donation_effectiveness"] == 0.75


def test_op_records_bounded():
    dev = DeviceTelemetry()
    for i in range(dt.MAX_OPS + 10):
        dev.record_launch(f"op{i}", None, "probe_add1")
    assert len(dev._ops) == dt.MAX_OPS


# ---------------------------------------------------------------- HBM


def _fake_allocator(monkeypatch, current, peak, reserved, total):
    """``torch.cuda.memory_stats_as_nested_dict`` and the card's memory
    as a CUDA allocator would report them."""
    stats = {"allocated_bytes": {"all": {"current": current, "peak": peak,
                                         "freed": 0}},
             "reserved_bytes": {"all": {"current": reserved}}}
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict",
                        lambda device=None: stats)
    monkeypatch.setattr(resources, "_total_memory", lambda device: total)
    return stats


def test_hbm_sample_with_allocator_stats_and_limit(monkeypatch):
    _fake_allocator(monkeypatch, 300, 400, 512, 1000)
    dev = DeviceTelemetry()
    dev.sample_hbm(torch.device("cuda", 0), op="x", wave=1)
    hbm = dev.summary()["hbm"]
    assert hbm["source"] == "memory_stats"
    assert hbm["current_bytes"] == 300
    assert hbm["peak_bytes"] == 400
    assert hbm["reserved_bytes"] == 512
    assert hbm["limit_bytes"] == 1000
    assert hbm["peak_frac"] == 0.4
    assert hbm["per_wave"][0]["wave"] == 1
    line = dev.status_line()
    assert line and "hbm 30%" in line


def test_hbm_watermark_takes_the_highest_peak(monkeypatch):
    stats = _fake_allocator(monkeypatch, 100, 150, 200, 1000)
    dev = DeviceTelemetry()
    dev.set_device("cuda")
    dev.sample_hbm(op="a", wave=0)
    stats["allocated_bytes"]["all"].update(current=120, peak=900)
    dev.sample_hbm(op="a", wave=1)
    stats["allocated_bytes"]["all"].update(current=50, peak=900)
    dev.sample_hbm(op="b", wave=None)
    assert dev.hbm_peak_bytes() == 900
    assert dev.summary()["totals"]["hbm_peak_bytes"] == 900


def test_hbm_live_tensor_fallback_on_a_cpu_run():
    """The CPU has no allocator stats: the bytes of the outputs the
    executor holds stand in, sampled after every wave and group."""
    sess = bs.Session(executor=bs.MeshExecutor(device="cpu"))
    n = 1 << 13
    keys = np.random.RandomState(3).randint(0, 1 << 18, n).astype(np.int32)
    res = sess.run(bs.Reduce(bs.Const(16, keys, np.ones(n, np.int32)),
                             lambda a, b: a + b))
    sum(len(f) for f in res.frames())
    hbm = sess.telemetry_summary()["device"]["hbm"]
    json.dumps(hbm)
    assert hbm["source"] == "live_tensors"
    assert hbm["samples"] == 2 * 16 + 2
    assert hbm["peak_bytes"] > 0
    assert "limit_bytes" not in hbm
    assert any(s.get("wave") is not None for s in hbm["per_wave"])


def test_hbm_budget_from_mem_get_info(monkeypatch):
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (3 << 30, 80 << 30))
    dev = DeviceTelemetry()
    assert dev.hbm_budget() is None  # no device bound
    dev.set_device("cpu")
    assert dev.hbm_budget() is None
    dev.record_hbm(10, 10, 1 << 30)  # a sample's limit stands in
    assert dev.hbm_budget() == 1 << 30
    dev.set_device("cuda")
    assert dev.hbm_budget() == 80 << 30


def test_spill_budget_takes_the_measured_budget_second(monkeypatch):
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (1, 1 << 34))
    dev = DeviceTelemetry()
    dev.set_device("cuda")
    monkeypatch.setenv("BIGSLICE_SPILL_BUDGET_BYTES", "12345")
    assert shuffleplan.spill_budget_bytes(
        100, 8, device_telemetry=dev) == 12345
    monkeypatch.delenv("BIGSLICE_SPILL_BUDGET_BYTES")
    assert shuffleplan.spill_budget_bytes(
        100, 8, device_telemetry=dev) == 1 << 34
    assert shuffleplan.spill_budget_bytes(
        100, 8, device_telemetry=DeviceTelemetry()) == 800
    assert shuffleplan.spill_budget_bytes(
        device_telemetry=DeviceTelemetry()) is None


def test_spill_plan_and_its_bytes_reach_the_device_summary(monkeypatch,
                                                            tmp_path):
    monkeypatch.setenv("BIGSLICE_SHUFFLE", "spill")
    monkeypatch.setenv("BIGSLICE_SPILL_DIR", str(tmp_path))
    sess = bs.Session(executor=bs.MeshExecutor(device="cpu",
                                               auto_dense=False))
    n = 4096
    keys = np.arange(n, dtype=np.int32) % 301
    res = sess.run(bs.Reduce(bs.Const(4, keys, np.ones(n, np.int32)),
                             lambda a, b: a + b))
    assert len(res.rows()) == 301
    s = sess.telemetry_summary()
    sp = s["device"]["shuffle_plan"]
    assert sp["totals"]["spill_boundaries"] == 1
    (entry,) = sp["ops"].values()
    assert entry["plans"] == {"spill": 1} and entry["spill_rows"] > 0
    # The spilled boundary's per-partition rows come from its manifest.
    skews = [e["skew"] for e in s["ops"].values() if "skew" in e]
    assert len(skews) == 1 and sum(skews[0]["rows"]) == entry["spill_rows"]
    sess.shutdown()


# ------------------------------------------------------------ donation


def test_donation_effectiveness_recorded():
    dev = DeviceTelemetry()
    dev.record_donation("op_a", 1, expected_bytes=1000,
                        aliased_bytes=750, buffers=4, aliased_buffers=3)
    s = dev.summary()
    assert s["donation"]["op_a"]["effectiveness"] == 0.75
    assert s["totals"]["donation_effectiveness"] == 0.75


def test_donation_on_a_cpu_run_frees_every_owned_input():
    sess = bs.Session(executor=bs.MeshExecutor(device="cpu",
                                               auto_dense=False))
    n = 4096
    sess.run(bs.Reduce(bs.Const(4, np.arange(n, dtype=np.int32) % 97,
                                np.ones(n, np.int32)),
                       lambda a, b: a + b))
    don = sess.telemetry_summary()["device"]["donation"]
    assert don, "the staged map waves were not donated"
    for entry in don.values():
        assert entry["expected_bytes"] > 0
        assert entry["effectiveness"] == 1.0


def test_donation_keeps_the_counts_a_map_only_output_uses():
    """A map-only chain's output carries its input's counts storage:
    the wave offers it with the columns, frees only the columns, and
    the donation record says so (the honored subset of the offer)."""
    sess = bs.Session(executor=bs.MeshExecutor(device="cpu"))
    keys = np.arange(4 * 64, dtype=np.int32)
    sess.run(bs.Map(bs.Const(4, keys), lambda k: k * 2))
    don = sess.telemetry_summary()["device"]["donation"]
    (entry,) = don.values()
    # Each of the 4 waves owns a key column (64 int32) and a counts
    # vector (1 int32); only the column is freed.
    assert entry["buffers"] == 8 and entry["aliased_buffers"] == 4
    assert entry["expected_bytes"] == 4 * (64 * 4 + 4)
    assert entry["aliased_bytes"] == 4 * 64 * 4


# ------------------------------------------------- windowed profiler


def test_profiler_window_writes_loadable_trace(tmp_path):
    out = Profiler(device="cpu").window(0.1, out_dir=str(tmp_path / "w"))
    assert out["files"] == ["trace.json"]
    with open(str(tmp_path / "w" / "trace.json")) as fp:
        assert "traceEvents" in json.load(fp)


def test_profiler_window_sees_work_on_another_thread(tmp_path):
    stop = threading.Event()

    def work():
        x = torch.ones(256, 256)
        while not stop.is_set():
            x = (x @ x) * 1e-3

    t = threading.Thread(target=work)
    t.start()
    try:
        out = Profiler(device="cpu").window(
            0.3, out_dir=str(tmp_path / "w"))
    finally:
        stop.set()
        t.join()
    with open(str(tmp_path / "w" / out["files"][0])) as fp:
        names = {e.get("name") for e in json.load(fp)["traceEvents"]}
    assert any(n and "mm" in n for n in names), sorted(n for n in names
                                                      if n)[:20]


def test_profiler_recording_is_seen_from_other_threads(tmp_path):
    from bigslice_tpu_torch.utils import xprof

    seen = []

    def watch():
        # A cold process's first torch.profiler entry takes seconds, so
        # the window opens late: wait for it (bounded), as a worker
        # thread would, instead of reading the flag once.
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if xprof.recording():
                seen.append(True)
                return
            time.sleep(0.01)
        seen.append(False)

    t = threading.Thread(target=watch)
    t.start()
    Profiler(device="cpu").window(0.8, out_dir=str(tmp_path / "w"))
    t.join()
    assert seen == [True] and not xprof.recording()


def test_profiler_window_ends_when_until_is_set(tmp_path):
    from bigslice_tpu_torch.utils import xprof

    done = threading.Event()
    seen = []

    def work():
        while not xprof.recording():
            time.sleep(0.01)
        torch.arange(4096).sum()
        seen.append(xprof.recording())
        done.set()

    t = threading.Thread(target=work)
    t.start()
    t0 = time.monotonic()
    out = Profiler(device="cpu").window(60.0, out_dir=str(tmp_path / "w"),
                                        until=done)
    held = time.monotonic() - t0
    t.join()
    # The work ran whole inside the window, which closed with it and not
    # at its 60 s cap.
    assert seen == [True] and not xprof.recording()
    assert held < 30.0 and out["files"] == ["trace.json"]
    assert Profiler(device="cpu").window(0.05, out_dir=str(
        tmp_path / "w2"))["files"]  # gate released


@pytest.mark.parametrize("mode", ["window", "trace_run"])
def test_device_trace_warms_up_before_it_records(tmp_path, monkeypatch,
                                                 mode):
    from bigslice_tpu_torch.utils import xprof

    seen = []
    monkeypatch.setattr(xprof, "_traces_device", lambda device: True)
    monkeypatch.setattr(xprof, "_device_warmup",
                        lambda device: seen.append(xprof.recording()))
    prof = Profiler(every_run_dir=str(tmp_path / "runs"), device="cpu")
    if mode == "window":
        prof.window(0.05, out_dir=str(tmp_path / "w"))
    else:
        handle = prof.trace_run()
        assert xprof.recording()
        handle.close()
    # The burst ran once, before the trace counted as recording.
    assert seen == [False] and not xprof.recording()


def test_device_trace_warmup_failure_releases_the_gate(tmp_path,
                                                       monkeypatch):
    from bigslice_tpu_torch.utils import xprof

    def broken(device):
        raise RuntimeError("no card")

    monkeypatch.setattr(xprof, "_traces_device", lambda device: True)
    monkeypatch.setattr(xprof, "_device_warmup", broken)
    prof = Profiler(every_run_dir=str(tmp_path / "runs"), device="cpu")
    assert prof.trace_run() is None  # a run is never failed by profiling
    with pytest.raises(RuntimeError, match="no card"):
        prof.window(0.05, out_dir=str(tmp_path / "w"))
    assert not xprof.recording()
    monkeypatch.setattr(xprof, "_traces_device", lambda device: False)
    assert prof.window(0.05, out_dir=str(tmp_path / "w2"))["files"]


def test_profiler_busy_rejects_second_window(tmp_path):
    prof = Profiler(device="cpu")
    started = threading.Event()
    done = []

    def long_window():
        started.set()
        done.append(prof.window(1.0, out_dir=str(tmp_path / "a")))

    t = threading.Thread(target=long_window)
    t.start()
    started.wait()
    time.sleep(0.2)
    # One gate a process: another Profiler object is turned away too.
    with pytest.raises(ProfilerBusy):
        Profiler(device="cpu").window(0.1, out_dir=str(tmp_path / "b"))
    t.join()
    assert done
    assert Profiler(device="cpu").trace_run() is None  # mode off


def test_profiler_trace_run_legacy_mode(tmp_path):
    d = str(tmp_path / "runs")
    prof = Profiler(every_run_dir=d, device="cpu")
    handle = prof.trace_run()
    assert handle is not None
    assert prof.trace_run() is None  # the gate is held
    torch.arange(128).sum()
    handle.close()
    handle.close()  # idempotent
    assert prof._trace_files(d) and handle.path.endswith(".json")
    out = prof.window(0.05, out_dir=str(tmp_path / "w"))  # gate released
    assert out["files"]
