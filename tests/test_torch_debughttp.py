"""The port's debug HTTP server (``utils/debughttp.py``) on the CPU: the
11 cases of tests/test_debughttp.py against a live waved device-executor
session, each route's payload held to what the JAX package's server
serves for the same session shape, and the ``/debug/fleet`` refusal
(501, naming the fleet merge) where the JAX package answers a document.

The kernels' launches are counted on the CPU here by wrapping the two
kernel wrappers so that each plain call counts as the card's launch
would (``cuda_kernels._count``): the device route's launches then equal
the hub's and the delta of ``LAUNCHES``, as phase 29 of chip_smoke.py
checks on the card."""

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.exec.session import Session as RefSession  # noqa: E402

import bigslice_tpu_torch as bs  # noqa: E402
from bigslice_tpu_torch.exec.meshexec import MeshExecutor  # noqa: E402
from bigslice_tpu_torch.parallel import cuda_kernels as ck  # noqa: E402
from bigslice_tpu_torch.utils import debughttp  # noqa: E402

# One Prometheus text-format sample line (tests/test_debughttp.py:19-24).
_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\")*\})?"
    r" [-+]?([0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?|Inf|NaN)$"
)


def counting_kernels(mp):
    """Count each plain K1/K2 call as a launch (``_count``, the same
    declared cost the card's wrapper records), on a private
    ``LAUNCHES``."""
    real_hp, real_ha = ck.hash_partition, ck.hash_aggregate

    def hash_partition(keys, nparts, seed=0, with_counts=True, valid=None):
        keys = list(keys)
        if keys[0].shape[0]:
            ck._count("hash_partition", n=keys[0].shape[0],
                      key_itemsizes=tuple(k.element_size() for k in keys),
                      valid=valid is not None, nparts=nparts,
                      with_counts=with_counts)
        return real_hp(keys, nparts, seed, with_counts, valid)

    def hash_aggregate(valid, key_cols, val_cols, ops, part, nparts, R,
                       seed=0):
        if key_cols[0].shape[0]:
            ck._count("hash_aggregate", n=key_cols[0].shape[0],
                      key_itemsizes=tuple(k.element_size()
                                          for k in key_cols),
                      val_itemsizes=tuple(v.element_size()
                                          for v in val_cols),
                      nparts=nparts, R=R)
        return real_ha(valid, key_cols, val_cols, ops, part, nparts, R,
                       seed)

    mp.setattr(ck, "LAUNCHES", dict.fromkeys(ck.LAUNCHES, 0))
    mp.setattr(ck, "hash_partition", hash_partition)
    mp.setattr(ck, "hash_aggregate", hash_aggregate)


def _skewed(n=1 << 13):
    keys = np.zeros(n, dtype=np.int32)  # a hot key: the skew gauge fires
    keys[: n // 8] = np.arange(n // 8, dtype=np.int32) % 53 + 1
    return keys


@pytest.fixture(scope="module")
def debug_sess():
    """One session with a waved device-executor run behind it (16 shards
    on the one device slot: 16 waves, so the overlap gauges fire)."""
    with pytest.MonkeyPatch.context() as mp:
        counting_kernels(mp)
        sess = bs.Session(executor=MeshExecutor(device="cpu",
                                                auto_dense=False),
                          debug_port=0)
        keys = _skewed()
        res = sess.run(bs.Reduce(bs.Const(16, keys, np.ones(len(keys),
                                                            np.int32)),
                                 lambda a, b: a + b))
        sum(len(f) for f in res.frames())
        sess.launches = dict(ck.LAUNCHES)
        yield sess
        res.discard()
        sess.shutdown()


def _get(sess, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{sess.debug.port}{path}", timeout=10
    ) as r:
        return r.read().decode(), r.headers.get("Content-Type", "")


def test_debug_index_lists_every_endpoint(debug_sess):
    body, _ = _get(debug_sess, "/debug")
    for ep in ("/debug/status", "/debug/tasks", "/debug/trace",
               "/debug/resources", "/debug/metrics", "/debug/device",
               "/debug/profile", "/debug/fleet"):
        assert ep in body


def test_debug_status(debug_sess):
    body, ctype = _get(debug_sess, "/debug/status")
    assert "done" in body and ctype.startswith("text/plain")


def test_debug_tasks_graph(debug_sess):
    body, ctype = _get(debug_sess, "/debug/tasks")
    assert ctype.startswith("application/json")
    doc = json.loads(body)
    assert doc["nodes"] and all(
        {"id", "op", "shard", "state"} <= set(n) for n in doc["nodes"])
    assert doc["links"]  # reduce depends on const
    # 16 const and 16 reduce tasks, each reduce shard reading every
    # const shard's partition: the JAX package's graph of this pipeline.
    assert len(doc["nodes"]) == 32
    assert {n["state"] for n in doc["nodes"]} == {"OK"}
    assert len(doc["links"]) == 16 * 16


def test_debug_trace(debug_sess):
    body, ctype = _get(debug_sess, "/debug/trace")
    assert ctype.startswith("application/json")
    assert json.loads(body) == {"traceEvents": []}  # no trace_path


def test_debug_resources(debug_sess):
    body, ctype = _get(debug_sess, "/debug/resources")
    assert ctype.startswith("application/json")
    doc = json.loads(body)
    assert doc["host_rss_bytes"] > 0
    assert "gauges" in doc


def test_debug_metrics_prometheus_parseable(debug_sess):
    """/debug/metrics: Prometheus text with the task-state counts, the
    per-op skew ratio and the wave overlap gauges, every sample line
    parseable (tests/test_debughttp.py:95-121)."""
    body, ctype = _get(debug_sess, "/debug/metrics")
    assert ctype.startswith("text/plain")
    assert "version=0.0.4" in ctype
    n_samples = 0
    for line in body.splitlines():
        if not line or line.startswith("#"):
            continue
        assert _SAMPLE_RE.match(line), f"unparseable line: {line!r}"
        n_samples += 1
    assert n_samples > 5
    for family in ("bigslice_task_state_total", "bigslice_op_skew_ratio",
                   "bigslice_op_skew_flagged",
                   "bigslice_wave_overlap_efficiency",
                   "bigslice_task_duration_seconds",
                   "bigslice_shuffle_partition_rows_bucket"):
        assert family in body, family
    assert 'state="OK"' in body
    assert 'le="+Inf"' in body
    assert "bigslice_kernel_select" not in body  # the knob is unset


def test_debug_unknown_path_404(debug_sess):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(debug_sess, "/nope")
    assert ei.value.code == 404


def test_debug_device_endpoint(debug_sess):
    """/debug/device: the device plane, where the JAX package's compile
    attribution stands empty by design; the kernels' launches equal the
    hub's and the run's LAUNCHES, and the waves sampled the HBM
    watermark."""
    body, ctype = _get(debug_sess, "/debug/device")
    assert ctype.startswith("application/json")
    doc = json.loads(body)
    assert {"compile", "kernels", "builds", "hbm", "donation",
            "totals"} <= set(doc)
    assert doc["compile"] == {}
    by_kernel = {}
    for per_op in doc["kernels"].values():
        for name, k in per_op.items():
            by_kernel[name] = by_kernel.get(name, 0) + k["launches"]
            assert k["bytes"] > 0 and k["flops"] > 0
    want = {k: v for k, v in debug_sess.launches.items() if v}
    assert by_kernel == want
    assert want["hash_partition"] == 16 and want["hash_aggregate"] == 32
    hub = debug_sess.telemetry_summary()["device"]["kernels"]
    assert doc["kernels"] == hub
    assert doc["totals"]["launches"] == sum(want.values())
    assert "kselect" not in doc
    assert doc["hbm"]["samples"] > 0
    assert doc["hbm"]["peak_bytes"] > 0


def test_debug_profile_window(debug_sess):
    """/debug/profile?seconds=N profiles the process for the window and
    answers a trace directory holding its file."""
    body, ctype = _get(debug_sess, "/debug/profile?seconds=0.2")
    assert ctype.startswith("application/json")
    doc = json.loads(body)
    assert os.path.isdir(doc["dir"])
    assert doc["files"] == ["trace.json"]
    with open(os.path.join(doc["dir"], "trace.json")) as fp:
        assert "traceEvents" in json.load(fp)


def test_debug_profile_bad_seconds_400(debug_sess):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(debug_sess, "/debug/profile?seconds=nope")
    assert ei.value.code == 400


def test_debug_profile_busy_409(debug_sess):
    """A second window while one is live gets 409, not a crashed
    profiler (torch runs one profiler per process)."""
    errs = []

    def long_window():
        try:
            _get(debug_sess, "/debug/profile?seconds=1.5")
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    t = threading.Thread(target=long_window)
    t.start()
    try:
        time.sleep(0.4)  # let the first window start
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(debug_sess, "/debug/profile?seconds=0.1")
        assert ei.value.code == 409
    finally:
        t.join(timeout=30)
    assert not t.is_alive()
    assert not errs


@pytest.mark.parametrize("query", ["", "?format=json", "?format=prom"])
def test_debug_fleet_refuses_by_name(debug_sess, query):
    """/debug/fleet answers the cross-rank merge (a fleet of one without
    an exporter): the json is the session's fleet summary, whose
    per-op rows and tasks the JAX package's ``merge_snapshots`` computes
    from the same snapshot, and the Prometheus text is the JAX
    package's ``prometheus_fleet_text`` of it."""
    from bigslice_tpu.utils import fleettelemetry as ref_fleet

    text, ctype = _get(debug_sess, "/debug/fleet" + query)
    snap = debug_sess.telemetry.snapshot()
    if query == "?format=prom":
        assert ctype.startswith("text/plain")
        assert text == ref_fleet.prometheus_fleet_text([snap])
        assert "bigslice_fleet_ranks 1" in text
        return
    doc = json.loads(text)
    want = ref_fleet.merge_snapshots([snap])
    assert set(doc) == set(want)
    assert doc["scope"] == "fleet" and doc["ranks"] == [0]
    for op, entry in want["ops"].items():
        assert doc["ops"][op].get("skew", {}).get("rows") == \
            entry.get("skew", {}).get("rows")
        assert doc["ops"][op].get("tasks", {}).get("n") == \
            entry.get("tasks", {}).get("n")
    assert doc["device"]["totals"] == want["device"]["totals"]


def test_routes_answer_as_the_jax_package():
    """Each route but the fleet's answers the JAX package's status code
    and content type for a session of the same run, and the same index
    of routes."""
    keys = _skewed(1 << 10)
    vals = np.ones(len(keys), np.int32)
    port = bs.Session(executor=MeshExecutor(device="cpu"), debug_port=0)
    ref = RefSession(debug_port=0)
    try:
        port.run(bs.Reduce(bs.Const(4, keys, vals), lambda a, b: a + b))
        ref.run(ref_bs.Reduce(ref_bs.Const(4, keys, vals),
                              lambda a, b: a + b))
        for path in ("/debug", "/debug/status", "/debug/tasks",
                     "/debug/trace", "/debug/resources", "/debug/metrics",
                     "/debug/device", "/nope"):
            got = []
            for sess in (port, ref):
                try:
                    _, ctype = _get(sess, path)
                    got.append((200, ctype.split(";")[0]))
                except urllib.error.HTTPError as e:
                    got.append((e.code, None))
            assert got[0] == got[1], path
        index = [_get(s, "/debug")[0].splitlines()[2:] for s in (port, ref)]
        assert [ln.split()[0] for ln in index[0]] == [
            ln.split()[0] for ln in index[1]]
    finally:
        port.shutdown()
        ref.shutdown()


def test_close_drains_in_flight_requests():
    """close() waits for a request in flight (here a profile window),
    which completes with 200; a request after close is refused."""
    sess = bs.Session(executor=bs.LocalExecutor(device="cpu"), debug_port=0)
    port = sess.debug.port
    got = []

    def window():
        got.append(_get(sess, "/debug/profile?seconds=0.5")[0])

    t = threading.Thread(target=window)
    t.start()
    time.sleep(0.2)
    t0 = time.monotonic()
    assert sess.debug.drain(timeout=debughttp.DRAIN_TIMEOUT_S)
    waited = time.monotonic() - t0
    sess.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()
    assert got and json.loads(got[0])["files"]
    assert waited > 0.1
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/debug", timeout=5)
