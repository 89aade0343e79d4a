"""The fleet plane (``utils/fleettelemetry.py``) against the JAX package's.

The reference's fifteen cases of ``tests/test_fleettelemetry.py``: the
port's hub and device recorder export mergeable snapshots; the same
snapshots go through both packages' ``merge_snapshots``,
``hist_quantile`` and ``prometheus_fleet_text``, whose outputs must be
equal; the store-mediated export, pull and merge, the post-mortem
bundle, ``obsdump --fleet``, ``/debug/fleet`` and ``slicetrace
--merge`` run on the port.
"""

import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bigslice_tpu.utils import fleettelemetry as ref_fleet  # noqa: E402
from bigslice_tpu.utils import telemetry as ref_telemetry  # noqa: E402

import bigslice_tpu_torch as bs  # noqa: E402
from bigslice_tpu_torch.exec.meshexec import MeshExecutor  # noqa: E402
from bigslice_tpu_torch.exec.session import Session  # noqa: E402
from bigslice_tpu_torch.utils import fleettelemetry as fleet_mod  # noqa: E402
from bigslice_tpu_torch.utils import telemetry as telemetry_mod  # noqa: E402


def _mesh_session(**kwargs):
    return Session(executor=MeshExecutor(device="cpu"), **kwargs)


def _bucket_of(v: float) -> int:
    for i, edge in enumerate(fleet_mod.DUR_BUCKETS_S):
        if v <= edge:
            return i
    return len(fleet_mod.DUR_BUCKETS_S)


def _same_merge(snaps):
    """Both packages' merge of the same snapshots, equal."""
    wire = json.loads(json.dumps(snaps, default=str))
    got = fleet_mod.merge_snapshots(wire)
    want = ref_fleet.merge_snapshots(json.loads(json.dumps(wire)))
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)
    return got


def _hub_with_rank_data(rank: int) -> telemetry_mod.TelemetryHub:
    hub = telemetry_mod.TelemetryHub()
    hub.record_shuffle("red", 1, [10 + rank, 5], [80, 40],
                       indices=[2 * rank, 2 * rank + 1], rank=rank)
    with hub._lock:
        hub._op("red", 1).durations.extend([0.01 * (rank + 1)] * 3)
    return hub


# -- mergeable histograms ----------------------------------------------------


def test_merged_quantile_within_one_bin_of_exact():
    rng = np.random.RandomState(5)
    rank0 = list(np.abs(rng.lognormal(-4.0, 1.2, 300)))
    rank1 = list(np.abs(rng.lognormal(-3.5, 1.0, 200)))
    merged = fleet_mod.merge_hist(fleet_mod.duration_hist(rank0),
                                  fleet_mod.duration_hist(rank1))
    assert merged == ref_fleet.merge_hist(ref_fleet.duration_hist(rank0),
                                          ref_fleet.duration_hist(rank1))
    assert merged["count"] == 500
    both = sorted(rank0 + rank1)
    for p in (0.5, 0.9, 0.99, 1.0):
        est = fleet_mod.hist_quantile(merged, p)
        assert est == ref_fleet.hist_quantile(merged, p)
        exact = telemetry_mod.quantile(both, p)
        assert _bucket_of(est) == _bucket_of(exact), (p, est, exact)
    assert fleet_mod.hist_quantile(merged, 1.0) == pytest.approx(max(both))
    assert fleet_mod.hist_stats(merged) == ref_fleet.hist_stats(merged)


def test_snapshot_json_round_trip_and_merge():
    hub = telemetry_mod.TelemetryHub()
    hub.record_shuffle("op1", 1, [10, 20, 30], [80, 160, 240])
    with hub._lock:
        hub._op("op1", 1).durations.extend([0.01, 0.02, 0.3])
    snap = hub.snapshot(rank=0, nranks=1)
    assert snap["schema"] == fleet_mod.SNAPSHOT_SCHEMA == \
        ref_fleet.SNAPSHOT_SCHEMA
    ref_hub = ref_telemetry.TelemetryHub()
    ref_hub.record_shuffle("op1", 1, [10, 20, 30], [80, 160, 240])
    with ref_hub._lock:
        ref_hub._op("op1", 1).durations.extend([0.01, 0.02, 0.3])
    want = ref_hub.snapshot(rank=0, nranks=1)
    assert set(snap) == set(want)
    assert set(snap["ops"]["op1"]) == set(want["ops"]["op1"])
    fleet = _same_merge([snap])
    assert fleet["scope"] == "fleet" and fleet["ranks"] == [0]
    assert fleet["ops"]["op1"]["skew"]["rows"] == [10, 20, 30]
    assert fleet["ops"]["op1"]["tasks"]["n"] == 3


def test_two_rank_merge_equals_single_process():
    single = telemetry_mod.TelemetryHub()
    single.record_shuffle("red", 1, [100, 12, 3, 9], [800, 96, 24, 72])
    r0 = telemetry_mod.TelemetryHub()
    r0.record_shuffle("red", 1, [100, 12], [800, 96], indices=[0, 1],
                      rank=0)
    r1 = telemetry_mod.TelemetryHub()
    r1.record_shuffle("red", 1, [3, 9], [24, 72], indices=[2, 3], rank=1)
    durs = [0.004, 0.008, 0.040, 0.120]
    for hub, d in ((single, durs), (r0, durs[:2]), (r1, durs[2:])):
        with hub._lock:
            hub._op("red", 1).durations.extend(d)
    ref = _same_merge([single.snapshot(rank=0, nranks=1)])
    fleet = _same_merge([r0.snapshot(rank=0, nranks=2),
                         r1.snapshot(rank=1, nranks=2)])
    assert fleet["ranks"] == [0, 1]
    ref_skew, skew = (d["ops"]["red"]["skew"] for d in (ref, fleet))
    assert skew["rows"] == ref_skew["rows"] == [100, 12, 3, 9]
    assert skew["ratio"] == ref_skew["ratio"]
    assert skew["per_rank_rows"] == {"0": 112, "1": 12}
    h, ref_h = (d["ops"]["red"]["tasks"]["hist"] for d in (fleet, ref))
    assert h["buckets"] == ref_h["buckets"] and h["count"] == ref_h["count"]
    assert fleet["ops"]["red"]["tasks"]["p50_s"] == \
        ref["ops"]["red"]["tasks"]["p50_s"]


def test_record_shuffle_indices_observe_only_provided_rows():
    hub = telemetry_mod.TelemetryHub()
    hub.record_shuffle("op", 1, [7, 9], indices=[5, 63], rank=0)
    rec = hub.snapshot(rank=0, nranks=2)["ops"]["op"]
    assert len(rec["part_rows"]) == 64
    assert rec["part_rows"][5] == 7 and rec["part_rows"][63] == 9
    assert rec["rows_hist_count"] == 2
    hub.record_shuffle("op", 1, [1, 2], indices=[0], rank=0)
    assert sum(hub.snapshot()["ops"]["op"]["part_rows"]) == 16


# -- the store-mediated export and merge ---------------------------------------


def test_fleet_exporter_export_pull_merge(tmp_path):
    url = str(tmp_path)
    ex0 = fleet_mod.FleetExporter(_hub_with_rank_data(0), url, rank=0,
                                  nranks=2, period_s=0)
    ex1 = fleet_mod.FleetExporter(_hub_with_rank_data(1), url, rank=1,
                                  nranks=2, period_s=0)
    assert ex0.export() is not None and ex1.export() is not None
    snaps = ex0.pull(wait_for_all=True, timeout_s=5)
    assert [s["rank"] for s in snaps] == [0, 1]
    fleet = ex0.fleet_summary()
    assert fleet["ops"]["red"]["skew"]["rows"] == [10, 5, 11, 5]
    _same_merge(snaps)
    ex0.close()
    ex1.close()
    merged = json.loads(fleet_mod._aux_store(url).get_aux(
        fleet_mod.MERGED_NAME).decode())
    assert merged["ranks"] == [0, 1] and merged["nranks"] == 2
    # The JAX package's offline reader sees the port's files.
    assert [s["rank"] for s in ref_fleet.load_snapshots(url)] == [0, 1]


def test_obsdump_fleet_offline_merge(tmp_path, capsys):
    from bigslice_tpu_torch.tools import obsdump

    url = str(tmp_path)
    for rank in (0, 1):
        fleet_mod.FleetExporter(_hub_with_rank_data(rank), url, rank=rank,
                                nranks=2, period_s=0).export()
    out = str(tmp_path / "fleet-summary.json")
    assert obsdump.main(["--fleet", url, "--summary", out]) == 0
    with open(out) as fp:
        doc = json.load(fp)
    assert doc["scope"] == "fleet" and doc["ranks"] == [0, 1]
    assert obsdump.main(["--fleet", url]) == 0
    assert json.loads(capsys.readouterr().out)["ranks"] == [0, 1]
    with pytest.raises(SystemExit):
        obsdump.main(["--fleet", str(tmp_path / "empty")])


def test_memory_store_aux_blobs():
    from bigslice_tpu_torch.exec.store import MemoryStore

    st = MemoryStore()
    assert st.get_aux("x.json") is None
    st.put_aux("x.json", b"{}")
    assert st.get_aux("x.json") == b"{}"


# -- the session's wiring ------------------------------------------------------


def test_session_fleet_dir_exports_and_merges(tmp_path):
    sess = _mesh_session(fleet_dir=str(tmp_path))
    assert sess.fleet is not None
    keys = (np.arange(4096, dtype=np.int64) % 97).astype(np.int32)
    res = sess.run(bs.Reduce(bs.Const(4, keys, np.ones(len(keys),
                                                       np.int32)),
                             lambda a, b: a + b))
    assert re.fullmatch(r"inv\d+", res.corr), res.corr
    single = sess.telemetry_summary()
    fleet = sess.telemetry_summary(scope="fleet")
    assert fleet["scope"] == "fleet" and fleet["ranks"] == [0]
    ops = [op for op, e in fleet["ops"].items() if "skew" in e]
    assert ops
    for op in ops:
        assert fleet["ops"][op]["skew"]["rows"] == \
            single["ops"][op]["skew"]["rows"]
        assert fleet["ops"][op]["skew"]["ratio"] == \
            single["ops"][op]["skew"]["ratio"]
    # The device section: the programs the session built, summed.
    assert fleet["device"]["totals"]["compiles"] == \
        single["device"]["totals"]["program_builds"]
    _same_merge([sess.telemetry.snapshot()])
    sess.shutdown()
    names = sorted(p.name for p in (tmp_path / "aux").iterdir())
    assert fleet_mod.SNAP_NAME.format(rank=0) in names
    assert fleet_mod.MERGED_NAME in names


def test_telemetry_disabled_writes_zero_snapshots(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGSLICE_TELEMETRY", "0")
    sess = Session(executor=bs.LocalExecutor(device="cpu"),
                   fleet_dir=str(tmp_path))
    assert sess.telemetry is None and sess.fleet is None
    res = sess.run(bs.Const(2, np.arange(8, dtype=np.int32)))
    assert len(sorted(res.rows())) == 8
    assert sess.telemetry_summary(scope="fleet") == {}
    sess.shutdown()
    assert [str(p) for p in tmp_path.rglob("*")] == []


def test_debug_fleet_endpoint(tmp_path):
    from urllib.request import urlopen

    sess = _mesh_session(fleet_dir=str(tmp_path), debug_port=0)
    sess.run(bs.Reduce(bs.Const(4, np.arange(1024, dtype=np.int32) % 31,
                                np.ones(1024, np.int32)),
                       lambda a, b: a + b))
    base = f"http://127.0.0.1:{sess.debug.port}"
    doc = json.loads(urlopen(f"{base}/debug/fleet").read())
    assert doc["scope"] == "fleet" and doc["ranks"] == [0]
    text = urlopen(f"{base}/debug/fleet?format=prom").read().decode()
    assert "bigslice_fleet_ranks 1" in text and 'rank="0"' in text
    assert "bigslice_task_duration_seconds_bucket" in text
    sess.shutdown()


# -- flight records ------------------------------------------------------------


def test_flight_record_rank_suffix(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGSLICE_FLIGHTREC_DIR", str(tmp_path))
    monkeypatch.setattr(telemetry_mod, "_process_rank", lambda: 1)
    hub = telemetry_mod.TelemetryHub()
    hub._emit("bigslice:test", op="x", inv=3)
    path = hub.dump_flight_record(inv=3, reason="boom")
    assert os.path.basename(path) == "flightrec-3-rank1.json"
    with open(path) as fp:
        assert json.load(fp)["rank"] == 1


def test_collate_flights_postmortem_bundle(tmp_path):
    url = str(tmp_path)
    exps = []
    for rank in (0, 1):
        hub = _hub_with_rank_data(rank)
        ex = fleet_mod.FleetExporter(hub, url, rank=rank, nranks=2,
                                     period_s=0)
        ex.export_flight(hub.flight_doc(inv=1, reason=f"boom{rank}"))
        exps.append(ex)
    name = exps[0].collate_flights(wait_s=5)
    assert name == fleet_mod.POSTMORTEM_NAME == ref_fleet.POSTMORTEM_NAME
    bundle = json.loads(fleet_mod._aux_store(url).get_aux(name).decode())
    assert sorted(bundle["by_rank"]) == ["0", "1"]
    assert bundle["by_rank"]["1"]["reason"] == "boom1"
    assert exps[1].collate_flights(wait_s=1) is None


# -- slicetrace --merge ----------------------------------------------------------


def _rank_trace(tmp_path, rank: int, part: int):
    doc = {"traceEvents": [
        {"ph": "i", "name": "bigslice:sessionStart", "ts": 0,
         "args": {"rank": rank}},
        {"ph": "i", "name": "bigslice:invocation:1", "ts": 1,
         "args": {"inv": 1, "corr": "smoke:1", "location": "pipe.py:10",
                  "args": "()"}},
        {"ph": "X", "name": "reduce@pipe.py:10", "ts": 1000 + rank,
         "dur": 500 + 100 * rank,
         "args": {"inv": 1, "shard": rank, "shards": 2}},
        {"ph": "i", "name": "bigslice:shuffleSizes", "ts": 1200,
         "args": {"op": "reduce@pipe.py:10", "inv": 1, "rows": [40 + rank],
                  "indices": [part], "rank": rank}},
        {"ph": "i", "name": "bigslice:exchange", "ts": 1400,
         "args": {"op": "reduce@pipe.py:10", "inv": 1,
                  "ici_messages": 2, "ici_bytes": 4096}},
    ]}
    path = tmp_path / f"trace-rank{rank}.json"
    path.write_text(json.dumps(doc))
    return str(path)


def test_slicetrace_merge_renders_rank_lanes(tmp_path, capsys):
    from bigslice_tpu.tools import slicetrace as ref_slicetrace
    from bigslice_tpu_torch.tools import slicetrace

    paths = [_rank_trace(tmp_path, r, part=r) for r in (0, 1)]
    assert slicetrace.main(["--merge", *paths]) == 0
    out = capsys.readouterr().out
    assert ref_slicetrace.main(["--merge", *paths]) == 0
    assert out == capsys.readouterr().out
    assert "fleet: 2 rank trace(s) merged" in out
    assert "corr=smoke:1" in out and "ranks=[0, 1]" in out


def test_slicetrace_merge_rank_from_filename(tmp_path, capsys):
    """No sessionStart rank: the ``rank<k>`` file name names the lane,
    as in the JAX package's analyzer."""
    from bigslice_tpu.tools import slicetrace as ref_slicetrace
    from bigslice_tpu_torch.tools import slicetrace

    doc = {"traceEvents": [
        {"ph": "X", "name": "map@x", "ts": 10, "dur": 5,
         "args": {"inv": 2}},
        {"ph": "i", "name": "bigslice:invocation:2", "ts": 1,
         "args": {"inv": 2, "location": "x"}},
    ]}
    p = tmp_path / "trace-rank7.json"
    p.write_text(json.dumps(doc))
    assert slicetrace.main(["--merge", str(p)]) == 0
    out = capsys.readouterr().out
    assert ref_slicetrace.main(["--merge", str(p)]) == 0
    assert out == capsys.readouterr().out
    assert "rank 7" in out and "ranks=[7]" in out


def test_prometheus_fleet_text_rank_labels():
    snaps = [_hub_with_rank_data(r).snapshot(rank=r, nranks=2)
             for r in (0, 1)]
    text = fleet_mod.prometheus_fleet_text(snaps)
    assert text == ref_fleet.prometheus_fleet_text(
        json.loads(json.dumps(snaps)))
    assert "bigslice_fleet_ranks 2" in text
    assert 'bigslice_shuffle_partition_rows_sum{rank="1",op="red"}' in text
    for ln in text.splitlines():
        assert "{}" not in ln
