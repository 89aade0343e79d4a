"""The serving plane through the port (tests/test_serve.py's cases): the
cross-Session program cache (``serve/programcache.py``), the invocation
server (``serve/server.py``) and its admission, quotas, deadlines,
result cache and drain, on the CPU.

The JAX package's program cache holds compiled executables, and its
acceptance case asserts that a fresh Session compiles nothing. The port
compiles no wave program; its counterpart asserts that every group
program of a fresh Session in the same process is a hit in the
process-wide tier (no program built after a miss), with bit-equal rows,
and that an unfingerprintable pipeline's program misses there. Beside
the ported cases: the served rows of the port's ``ServeServer`` equal
the JAX package's for the same pipeline and arguments, ``fn_fingerprint``
gives both packages the same token, the cost gate (tests/test_adaptive.py
:430, :475) reads the declared launch bytes of ``record_launch``, the
kernel selector's probe programs land in the cache
(tests/test_kernelselect.py:225), and the executor's session-local table
guards against recycled function ids (tests/test_meshexec.py:297)."""

import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.exec.meshexec import MeshExecutor as RefMesh  # noqa: E402
from bigslice_tpu.exec.session import Session as RefSession  # noqa: E402
from bigslice_tpu.serve import programcache as ref_pc  # noqa: E402
from bigslice_tpu.serve.server import ServeServer as RefServe  # noqa: E402

import bigslice_tpu_torch as bs  # noqa: E402
from bigslice_tpu_torch.exec.meshexec import MeshExecutor  # noqa: E402
from bigslice_tpu_torch.exec.session import Session  # noqa: E402
from bigslice_tpu_torch.serve import programcache as pc_mod  # noqa: E402
from bigslice_tpu_torch.serve.server import ServeServer  # noqa: E402


def _add(a, b):
    return a + b


def _session(**kw):
    return Session(executor=MeshExecutor(device="cpu"), **kw)


def _group_totals(sess):
    """Program accounting of the session's wave programs (kind group)."""
    out = {"built": 0, "hits": 0, "cross_session_hits": 0}
    for per_op in sess.telemetry_summary()["device"]["programs"].values():
        for k in out:
            out[k] += per_op.get("group", {}).get(k, 0)
    return out


# ------------------------------------------------- program cache (unit)

def test_fingerprint_content_not_identity():
    """Two function objects minted from the same code (the fresh-Session
    case) share a fingerprint; different code or different captured
    primitives split it."""
    def mk(k):
        def f(a, b):
            return a + b * k
        return f

    assert pc_mod.fn_fingerprint((mk(3),)) == pc_mod.fn_fingerprint((mk(3),))
    assert pc_mod.fn_fingerprint((mk(3),)) != pc_mod.fn_fingerprint((mk(4),))
    assert pc_mod.fn_fingerprint(()) == ()


def test_fingerprint_hashes_global_values():
    """Functions with identical bytecode reading different module globals
    must not share a fingerprint; modules (numpy, torch) hash by name; a
    mutable global keeps the program session-local."""
    import torch

    src = "def f(a, b):\n    return a + b * SCALE\n"
    ns1: dict = {"SCALE": 2}
    ns2: dict = {"SCALE": 3}
    ns3: dict = {"SCALE": 2}
    exec(src, ns1)
    exec(src, ns2)
    exec(src, ns3)
    f1 = pc_mod.fn_fingerprint((ns1["f"],))
    assert f1 is not None
    assert f1 != pc_mod.fn_fingerprint((ns2["f"],))
    assert f1 == pc_mod.fn_fingerprint((ns3["f"],))
    for name, mod in (("np", np), ("torch", torch)):
        nsm: dict = {name: mod}
        exec(f"def g(a, b):\n    return {name}.minimum(a, b)\n", nsm)
        assert pc_mod.fn_fingerprint((nsm["g"],)) is not None
    nso: dict = {"STATE": {"k": 1}}
    exec("def h(a, b):\n    return a + b + STATE['k']\n", nso)
    assert pc_mod.fn_fingerprint((nso["h"],)) is None


def test_fingerprint_bails_on_array_closure():
    """A closure over an array or a tensor makes the program
    session-local, never wrongly shared."""
    import torch

    def mk(x):
        def f(a, b):
            return a + b + x
        return f

    assert pc_mod.fn_fingerprint((mk(np.arange(3)),)) is None
    assert pc_mod.fn_fingerprint((mk(torch.arange(3)),)) is None


def test_program_cache_lru_and_accounting():
    c = pc_mod.ProgramCache(capacity=2)
    c.put("d1", (1,), "spec1", 0.5)
    c.put("d2", (1,), "spec2", 0.25)
    assert c.get("d1", (1,)) == "spec1"     # refreshes d1
    c.put("d3", (1,), "spec3", 0.1)          # evicts d2 (LRU)
    assert c.get("d2", (1,)) is None
    s = c.stats()
    assert s["evictions"] == 1
    assert s["hits"] == 1 and s["misses"] == 1
    assert s["compile_s_saved"] == pytest.approx(0.5)
    assert s["compile_s_evicted"] == pytest.approx(0.25)
    c.discard("d1", (1,))
    assert c.get("d1", (1,)) is None
    assert c.stats()["discards"] == 1
    assert set(s) == set(ref_pc.ProgramCache(capacity=2).stats())


def test_program_cache_disabled_is_noop(monkeypatch):
    monkeypatch.setenv("BIGSLICE_PROGRAM_CACHE", "0")
    c = pc_mod.ProgramCache()
    assert not c.enabled
    c.put("d", (1,), "spec", 1.0)
    assert c.get("d", (1,)) is None
    assert len(c) == 0


def test_serve_digest_strips_invocation_suffix():
    d1 = pc_mod.serve_digest("reduce@f.py:10#3", "group", (1,), None, ())
    d2 = pc_mod.serve_digest("reduce@f.py:10#7", "group", (1,), None, ())
    d3 = pc_mod.serve_digest("reduce@f.py:11", "group", (1,), None, ())
    assert d1 == d2 and d1 != d3
    # The same digest as the JAX package's for the same parts.
    assert d1 == ref_pc.serve_digest("reduce@f.py:10#3", "group", (1,),
                                     None, ())


@pytest.mark.parametrize("fn", [
    _add,
    lambda a, b: (max(a[0], b[0]), a[1] + b[1]),
    (lambda k: (lambda a, b: a + b * k))(3),
], ids=["module-fn", "lambda", "closure"])
def test_fingerprint_equals_the_jax_packages(fn):
    """A pure-Python combine fn fingerprints to the same token in both
    packages (the copied algorithm, byte for byte), and so do the
    digests built on it."""
    tok = pc_mod.fn_fingerprint((fn,))
    assert tok is not None and tok == ref_pc.fn_fingerprint((fn,))
    assert pc_mod.serve_digest("op@x.py:1", "group", (1,), None, tok) == \
        ref_pc.serve_digest("op@x.py:1", "group", (1,), None, tok)


# --------------------------- a fresh Session: every group program a hit

_XS_DATA = {}


def _xs_pipeline():
    d = _XS_DATA
    return bs.Reduce(bs.Const(d["shards"], d["keys"], d["vals"]), _add)


def _run_rows(sess, fn):
    res = sess.run(fn)
    rows = sorted(map(tuple, res.rows()))
    res.discard()
    return rows


def test_fresh_session_zero_compiles():
    """The serving acceptance case: session 2 (fresh, same process)
    re-runs the pipeline and every one of its group programs is a hit in
    the process-wide tier, none built after a miss, with bit-equal
    rows; the hits ride the cache's stats."""
    pc_mod.reset_global_program_cache()
    rng = np.random.RandomState(42)
    _XS_DATA.update(
        shards=8,  # 8 waves on one device slot
        keys=rng.randint(0, 1 << 10, 1 << 14).astype(np.int32),
        vals=np.ones(1 << 14, np.int32),
    )
    s1 = _session()
    rows1 = _run_rows(s1, _xs_pipeline)
    t1 = _group_totals(s1)
    s1.shutdown()
    assert t1["built"] > 0 and t1["cross_session_hits"] == 0

    pc0 = pc_mod.global_program_cache().stats()
    s2 = _session()
    rows2 = _run_rows(s2, _xs_pipeline)
    t2 = _group_totals(s2)
    totals = s2.telemetry_summary()["device"]["totals"]
    pc1 = pc_mod.global_program_cache().stats()
    s2.shutdown()
    assert rows2 == rows1
    assert t2["built"] == 0 and totals["program_builds"] == 0, t2
    assert t2["cross_session_hits"] == t1["built"] > 0
    assert totals["cross_session_hits"] == t2["cross_session_hits"]
    assert pc1["hits"] - pc0["hits"] == t2["cross_session_hits"]
    assert pc1["compile_s_saved"] > pc0["compile_s_saved"]


_OPAQUE_DATA = {}


def _opaque_pipeline():
    d = _OPAQUE_DATA
    bias = d["bias"]  # an array captured by the combine closure

    def combine(a, b):
        return a + b + bias[0] - bias[0]

    return bs.Reduce(bs.Const(4, d["keys"], d["vals"]), combine)


def test_unfingerprintable_closure_stays_session_local():
    """A combine fn closing over an array defeats fingerprinting: its
    group program never enters the process-wide tier, so a fresh
    session's misses there and is built again."""
    rng = np.random.RandomState(7)
    _OPAQUE_DATA.update(
        keys=rng.randint(0, 64, 4096).astype(np.int32),
        vals=np.ones(4096, np.int32),
        bias=np.zeros(1, np.int32),
    )
    entries0 = len(pc_mod.global_program_cache())
    s1 = _session()
    rows1 = _run_rows(s1, _opaque_pipeline)
    s1.shutdown()
    s2 = _session()
    rows2 = _run_rows(s2, _opaque_pipeline)
    t2 = _group_totals(s2)
    s2.shutdown()
    assert rows2 == rows1
    assert t2["built"] > 0 and t2["cross_session_hits"] == 0
    assert len(pc_mod.global_program_cache()) == entries0


# --------------------------------------------------- invocation server

_SRV_DATA = {}


def _srv_pipeline(n_keys=64):
    d = _SRV_DATA
    return bs.Reduce(bs.Const(4, d["keys"] % np.int32(n_keys), d["vals"]),
                     _add)


@pytest.fixture(scope="module")
def serve_mesh():
    """One session and server shared by the HTTP-path tests."""
    rng = np.random.RandomState(0)
    _SRV_DATA.update(
        keys=rng.randint(0, 1 << 20, 8192).astype(np.int32),
        vals=np.ones(8192, np.int32),
    )
    sess = _session()
    srv = ServeServer(sess, port=0, slots=2, queue_depth=8, tenant_quota=8)
    srv.register("reduce", _srv_pipeline, description="keyed reduce (test)")
    yield srv
    sess.shutdown()


def _post(srv, doc):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/serve/invoke",
        data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}",
                                timeout=30) as r:
        return r.status, r.read().decode()


def test_invoke_http_roundtrip(serve_mesh):
    code, doc = _post(serve_mesh, {"pipeline": "reduce", "args": [64],
                                   "tenant": "alice"})
    assert code == 200, doc
    assert doc["pipeline"] == "reduce" and doc["tenant"] == "alice"
    assert doc["num_rows"] == 64
    assert sum(r[1] for r in doc["rows"]) == 8192
    assert doc["latency_s"] > 0


def test_invoke_correlation_id_minted_and_echoed(serve_mesh):
    """Every invocation carries a correlation id: minted
    ``<pipeline>:<seq>`` when the client sends none, echoed verbatim
    when it does, errors included."""
    code, doc = _post(serve_mesh, {"pipeline": "reduce", "args": [64]})
    assert code == 200
    assert re.fullmatch(r"reduce:\d+", doc["corr"]), doc["corr"]
    code, doc2 = _post(serve_mesh, {"pipeline": "reduce", "args": [64],
                                    "corr": "req-abc123"})
    assert code == 200 and doc2["corr"] == "req-abc123"
    code, err = _post(serve_mesh, {"pipeline": "reduce", "args": ["bogus"],
                                   "corr": "req-bad"})
    assert code == 500 and err["corr"] == "req-bad"


def test_correlation_id_lands_in_trace(tmp_path):
    """request → response corr → the trace's ``bigslice:invocation:N``
    instant."""
    trace = str(tmp_path / "t.json")
    sess = _session(trace_path=trace)
    srv = ServeServer(sess, port=0, slots=1, queue_depth=4)
    srv.register("wc", lambda: bs.Reduce(
        bs.Const(4, np.arange(256, dtype=np.int32) % 7,
                 np.ones(256, np.int32)), _add))
    code, doc = srv.invoke_request({"pipeline": "wc"})
    assert code == 200, doc
    corr = doc["corr"]
    sess.shutdown()
    with open(trace) as fp:
        events = json.load(fp)["traceEvents"]
    tagged = [ev for ev in events
              if str(ev.get("name", "")).startswith("bigslice:invocation:")
              and ev.get("args", {}).get("corr") == corr]
    assert tagged, corr


def test_invoke_unknown_pipeline_404(serve_mesh):
    code, doc = _post(serve_mesh, {"pipeline": "nope"})
    assert code == 404
    assert "reduce" in doc["pipelines"]


def test_invoke_bad_args_400(serve_mesh):
    code, doc = _post(serve_mesh, {"pipeline": "reduce", "args": "not-a-list"})
    assert code == 400


def test_invoke_oversized_body_413(serve_mesh):
    """A Content-Length beyond the body limit answers 413, not an
    empty-body parse that would say 'unknown pipeline None'."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", serve_mesh.port,
                                      timeout=30)
    try:
        conn.putrequest("POST", "/serve/invoke")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(17 << 20))
        conn.endheaders()
        conn.send(b"{}")  # the server answers without reading 17 MiB
        resp = conn.getresponse()
        assert resp.status == 413
        assert "too large" in json.loads(resp.read())["error"]
    finally:
        conn.close()


def test_serve_index_and_healthz(serve_mesh):
    code, body = _get(serve_mesh, "/serve")
    assert code == 200 and "/serve/invoke" in body
    assert "/debug/metrics" in body  # the debug surface rides along
    code, body = _get(serve_mesh, "/healthz")
    doc = json.loads(body)
    assert doc["ok"] and "reduce" in doc["pipelines"]


def test_serving_stats_and_metrics(serve_mesh):
    _post(serve_mesh, {"pipeline": "reduce", "args": [64], "tenant": "bob"})
    code, body = _get(serve_mesh, "/serve/stats")
    doc = json.loads(body)
    assert doc["tenants"]["bob"]["requests"] >= 1
    assert doc["tenants"]["bob"]["latency"]["p99_s"] > 0
    assert "program_cache" in doc and "result_cache" in doc
    assert doc["admission"]["slots"] == 2
    summary = serve_mesh.session.telemetry_summary()
    assert summary["serving"]["tenants"]["bob"]["requests"] >= 1
    assert "hits" in summary["program_cache"]
    code, body = _get(serve_mesh, "/debug/metrics")
    assert "bigslice_serving_requests_total" in body
    assert 'tenant="bob"' in body
    assert "bigslice_serving_latency_seconds" in body
    assert "bigslice_program_cache_total" in body
    assert "bigslice_program_cache_entries" in body
    assert "bigslice_program_cache_compile_seconds_saved_total" in body
    assert "bigslice_result_cache_total" in body


def test_concurrent_invocations_bit_parity(serve_mesh):
    """Four threads invoking pipelines on one shared Session and
    executor: rows bit-equal to serial execution of the same
    invocations, and the repeats hit the session-local program table."""
    serial = [
        sorted(map(tuple, _post(serve_mesh, {"pipeline": "reduce",
                                             "args": [nk]})[1]["rows"]))
        for nk in (32, 48) for _ in range(2)
    ]
    results = {}
    errs = []

    def worker(i, nk):
        try:
            code, doc = _post(serve_mesh, {"pipeline": "reduce",
                                           "args": [nk], "tenant": f"t{i}"})
            assert code == 200, doc
            results[i] = sorted(map(tuple, doc["rows"]))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i, nk))
               for i, nk in enumerate([32, 48, 32, 48])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    concurrent = [results[0], results[2], results[1], results[3]]
    assert concurrent == serial
    totals = serve_mesh.session.telemetry_summary()["device"]["totals"]
    assert totals["cache_hits"] > 0


@pytest.mark.parametrize("args", [[16], [64], [1000]])
def test_served_rows_equal_the_jax_packages(args):
    """Parity: the same pipeline over the same seeded inputs, served by
    the port's ServeServer on its Session and the JAX package's on its
    own (a four-device CPU mesh): equal rows and counts."""
    rng = np.random.RandomState(5)
    keys = rng.randint(0, 1 << 20, 8192).astype(np.int32)
    vals = rng.randint(-100, 100, 8192).astype(np.int32)

    def make(mod):
        def pipe(n_keys):
            return mod.Reduce(mod.Const(4, keys % np.int32(n_keys), vals),
                              _add)
        return pipe

    sess = _session()
    srv = ServeServer(sess, port=0)
    srv.register("p", make(bs))
    mesh = Mesh(np.array(jax.devices()[:4]), ("shards",))
    ref_sess = RefSession(executor=RefMesh(mesh))
    ref_srv = RefServe(ref_sess, port=0)
    ref_srv.register("p", make(ref_bs))
    try:
        req = {"pipeline": "p", "args": args, "max_rows": 1 << 20}
        code, doc = srv.invoke_request(dict(req))
        ref_code, ref_doc = ref_srv.invoke_request(dict(req))
        assert code == ref_code == 200, (doc, ref_doc)
        assert doc["num_rows"] == ref_doc["num_rows"] == len(
            np.unique(keys % args[0]))
        assert sorted(map(tuple, doc["rows"])) == sorted(
            map(tuple, ref_doc["rows"]))
        assert doc["rows_truncated"] is ref_doc["rows_truncated"] is False
    finally:
        sess.shutdown()
        ref_sess.shutdown()


# ------------------------------------------------- admission control

@pytest.fixture()
def slow_server(tmp_path):
    """A session and a pipeline whose slice function blocks on an event:
    deterministic occupancy for the admission tests."""
    gate = threading.Event()
    started = threading.Event()

    def slow_pipeline():
        started.set()
        gate.wait(30)
        return bs.Const(1, np.arange(4, dtype=np.int32))

    sess = _session()
    srv = ServeServer(sess, port=0, slots=1, queue_depth=0, tenant_quota=1,
                      result_cache_dir=str(tmp_path))
    srv.register("slow", slow_pipeline)
    srv.register("fast", lambda: bs.Const(1, np.arange(4, dtype=np.int32)))
    yield srv, gate, started
    gate.set()
    sess.shutdown()


def test_admission_queue_full_503(slow_server):
    srv, gate, started = slow_server
    out = {}

    def occupy():
        out["first"] = srv.invoke_request({"pipeline": "slow"})

    t = threading.Thread(target=occupy)
    t.start()
    assert started.wait(10)
    # The slot taken, queue_depth=0: another tenant sheds with 503.
    code, doc = srv.invoke_request({"pipeline": "fast", "tenant": "other"})
    assert code == 503 and doc.get("retry")
    gate.set()
    t.join(30)
    assert out["first"][0] == 200
    stats = srv.stats.summary()
    assert stats["tenants"]["other"]["outcomes"]["rejected_capacity"] == 1
    assert stats["totals"]["shed"] >= 1


def test_tenant_quota_429(slow_server):
    srv, gate, started = slow_server
    srv.queue_depth = 4  # capacity available: the quota must trip first
    out = {}

    def occupy():
        out["first"] = srv.invoke_request({"pipeline": "slow",
                                           "tenant": "alice"})

    t = threading.Thread(target=occupy)
    t.start()
    assert started.wait(10)
    code, doc = srv.invoke_request({"pipeline": "fast", "tenant": "alice"})
    assert code == 429 and doc.get("retry")
    gate.set()
    t.join(30)
    assert out["first"][0] == 200
    outcomes = srv.stats.summary()["tenants"]["alice"]["outcomes"]
    assert outcomes["rejected_quota"] == 1
    assert outcomes["ok"] == 1


# -------------------------------------------------- result cache

def test_result_cache_hit_accounting(tmp_path):
    from bigslice_tpu_torch.ops import cache as cache_mod

    sess = _session()
    srv = ServeServer(sess, port=0, result_cache_dir=str(tmp_path))
    rng = np.random.RandomState(3)
    keys = rng.randint(0, 16, 1024).astype(np.int32)
    vals = np.ones(1024, np.int32)

    def pipeline():
        return bs.Reduce(bs.Const(2, keys, vals), _add)

    srv.register("cached", pipeline, cache=True)
    before = cache_mod.result_cache_counts()
    code, doc1 = srv.invoke_request({"pipeline": "cached"})
    assert code == 200
    mid = cache_mod.result_cache_counts()
    assert mid["miss"] - before["miss"] >= 1  # computed and written
    code, doc2 = srv.invoke_request({"pipeline": "cached"})
    assert code == 200
    after = cache_mod.result_cache_counts()
    assert after["hit"] - mid["hit"] >= 1  # served from the cache files
    assert sorted(map(tuple, doc2["rows"])) == sorted(map(tuple,
                                                          doc1["rows"]))
    text = sess.telemetry.prometheus_text()
    assert "bigslice_result_cache_total" in text
    assert 'outcome="hit"' in text
    sess.shutdown()


def test_register_cache_without_dir_raises():
    sess = _session()
    srv = ServeServer(sess, port=0)
    with pytest.raises(ValueError):
        srv.register("c", lambda: bs.Const(1, np.arange(2)), cache=True)
    sess.shutdown()


# ---------------------------------------------- graceful shutdown

def test_shutdown_drains_inflight_and_flushes_snapshot():
    import io

    gate = threading.Event()
    started = threading.Event()

    def slow_pipeline():
        started.set()
        gate.wait(30)
        return bs.Const(1, np.arange(3, dtype=np.int32))

    sess = _session()
    srv = ServeServer(sess, port=0, slots=1, queue_depth=2)
    srv.register("slow", slow_pipeline)
    out = {}

    def invoke():
        out["resp"] = _post(srv, {"pipeline": "slow"})

    t = threading.Thread(target=invoke)
    t.start()
    assert started.wait(10)
    closer = threading.Thread(target=sess.shutdown)
    closer.start()
    deadline = time.monotonic() + 10
    while not srv._closing and time.monotonic() < deadline:
        time.sleep(0.01)
    # Mid-drain: new invocations shed, they do not queue.
    code, doc = srv.invoke_request({"pipeline": "slow"})
    assert code == 503
    gate.set()  # let the invocation in flight finish
    t.join(30)
    closer.join(30)
    assert out["resp"][0] == 200, out["resp"]
    assert out["resp"][1]["num_rows"] == 3
    buf = io.StringIO()
    srv._final_snapshot(stream=buf)
    assert "sliceserve: shutdown after" in buf.getvalue()


def test_attach_session_swaps_and_rehooks():
    sess1 = _session()
    srv = ServeServer(sess1, port=0)
    srv.register("c", lambda: bs.Const(1, np.arange(2, dtype=np.int32)))
    assert sess1.serve is srv
    assert sess1.telemetry.serving is srv.stats
    sess2 = _session()
    srv.attach_session(sess2)
    assert sess2.serve is srv and sess1.serve is None
    assert sess2.telemetry.serving is srv.stats
    code, doc = srv.invoke_request({"pipeline": "c"})
    assert code == 200 and doc["num_rows"] == 2
    sess1.shutdown()
    sess2.shutdown()


def test_debug_server_close_drains():
    """DebugServer.close() waits for a request in flight instead of
    resetting it."""
    from bigslice_tpu_torch.utils.debughttp import DebugServer

    sess = _session()
    dbg = DebugServer(sess, port=0)
    release = threading.Event()
    entered = threading.Event()
    orig = sess.status.render

    def slow_render():
        entered.set()
        release.wait(10)
        return orig()

    sess.status.render = slow_render
    out = {}

    def get_status():
        with urllib.request.urlopen(
                f"http://127.0.0.1:{dbg.port}/debug/status", timeout=30) as r:
            out["code"] = r.status

    t = threading.Thread(target=get_status)
    t.start()
    assert entered.wait(10)
    closer = threading.Thread(target=dbg.close)
    closer.start()
    time.sleep(0.2)
    assert closer.is_alive()  # draining, not done
    release.set()
    t.join(10)
    closer.join(10)
    assert out.get("code") == 200
    sess.status.render = orig
    sess.shutdown()


# --------------------------------------------------- deadlines


def test_deadline_admission_predictive_504(slow_server):
    """A request whose budget cannot cover the pipeline's measured wall
    (EWMA x queue position) sheds 504 at admission."""
    srv, gate, started = slow_server
    code, doc = srv.invoke_request({"pipeline": "fast", "tenant": "bob",
                                    "deadline_s": 60})
    assert code == 200, doc
    assert srv._pipe_latency["fast"] > 0
    stats = srv.serving_stats()
    assert stats["admission"]["latency_ewma_s"]["fast"] > 0
    srv._pipe_latency["fast"] = 50.0
    code, doc = srv.invoke_request({"pipeline": "fast", "tenant": "bob",
                                    "deadline_s": 0.5})
    assert code == 504
    assert doc.get("retry") is False
    assert "predicted wall" in doc["error"]
    outcomes = srv.stats.summary()["tenants"]["bob"]["outcomes"]
    assert outcomes["deadline_exceeded"] == 1
    assert outcomes["ok"] == 1
    hub = srv.session.telemetry
    assert hub.deadline.count("met", "bob") == 1
    assert hub.deadline.count("rejected", "bob") == 1
    assert hub.deadline.summary()["by_source"]["serve"] == 2
    for bad in ("soon", 0, -3):
        code, doc = srv.invoke_request({"pipeline": "fast",
                                        "deadline_s": bad})
        assert code == 400, (bad, doc)


def test_deadline_expires_in_queue_504(slow_server):
    """A queued request whose budget burns out waiting sheds 504 without
    ever taking the slot."""
    srv, gate, started = slow_server
    srv.queue_depth = 4
    out = {}

    def occupy():
        out["first"] = srv.invoke_request({"pipeline": "slow"})

    t = threading.Thread(target=occupy)
    t.start()
    assert started.wait(10)
    t0 = time.monotonic()
    code, doc = srv.invoke_request({"pipeline": "fast", "tenant": "carol",
                                    "deadline_s": 0.3})
    waited = time.monotonic() - t0
    assert code == 504
    assert "expired while queued" in doc["error"]
    assert 0.2 < waited < 10.0
    gate.set()
    t.join(30)
    assert out["first"][0] == 200
    outcomes = srv.stats.summary()["tenants"]["carol"]["outcomes"]
    assert outcomes["deadline_exceeded"] == 1
    assert srv.session.telemetry.deadline.count("expired", "carol") == 1


def test_deadline_midflight_504_frees_slot_for_queued(slow_server):
    """Mid-flight expiry: the evaluator cancels and drains, the 504
    releases the slot, and the queued tenant (no deadline) runs to 200
    on it."""
    srv, gate, started = slow_server
    srv.queue_depth = 4
    out = {}

    def first():
        out["a"] = srv.invoke_request({"pipeline": "slow", "tenant": "alice",
                                       "deadline_s": 0.25})

    def second():
        out["b"] = srv.invoke_request({"pipeline": "fast", "tenant": "dave"})

    ta = threading.Thread(target=first)
    ta.start()
    assert started.wait(10)
    tb = threading.Thread(target=second)
    tb.start()
    deadline = time.monotonic() + 10
    while srv.stats.queued < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.3)  # alice's budget burns while the gate is held
    gate.set()
    ta.join(30)
    tb.join(30)
    code_a, doc_a = out["a"]
    assert code_a == 504, doc_a
    assert "pending_tasks" in doc_a
    code_b, doc_b = out["b"]
    assert code_b == 200, doc_b
    outcomes = srv.stats.summary()["tenants"]["alice"]["outcomes"]
    assert outcomes["deadline_exceeded"] == 1
    hub = srv.session.telemetry
    assert hub.deadline.count("expired", "alice") == 1
    doc = hub.summary()["deadline"]
    assert doc["by_tenant"]["alice"]["expired"] == 1
    assert doc["by_source"]["serve"] >= 1
    text = hub.prometheus_text()
    assert ('bigslice_deadline_outcomes_total{tenant="alice",'
            'outcome="expired"} 1') in text


# ----------------------------------------- the cost gate (test_adaptive)


def test_serve_sheds_on_predicted_cost(monkeypatch):
    """tests/test_adaptive.py:430: a pipeline's predicted cost is the
    declared launch bytes of its sole invocation (``record_launch``,
    where the JAX package records a compile's bytes); with that much
    already admitted past the budget, the next invocation is shed."""
    monkeypatch.setenv("BIGSLICE_ADAPTIVE", "cost")
    monkeypatch.setenv("BIGSLICE_SERVE_COST_BUDGET_BYTES", "1200")
    sess = _session()
    srv = ServeServer(sess, port=0, slots=2, queue_depth=4)

    def pipe():
        # The declared bytes land in the device plane while this is the
        # sole invocation: measured as its prediction.
        sess.telemetry.device.record_launch(
            "served-op", 0, "hash_aggregate", {"bytes": 900, "flops": 9})
        return bs.Const(1, np.arange(8, dtype=np.int32))

    srv.register("measured", pipe)
    try:
        code, doc = srv.invoke_request({"pipeline": "measured"})
        assert code == 200 and doc["num_rows"] == 8
        assert srv._pipe_cost == {"measured": 900}
        srv._cost_inflight = 500  # 500 + 900 > 1200: shed
        code, doc = srv.invoke_request({"pipeline": "measured"})
        assert code == 503 and doc.get("retry")
        assert "predicted cost" in doc["error"]
        srv._cost_inflight = 0
        # An idle server always admits (the anti-livelock guard), and a
        # repeat leaves the prediction where it was.
        code, _ = srv.invoke_request({"pipeline": "measured"})
        assert code == 200
        assert srv._pipe_cost == {"measured": 900}
        counts = sess.adaptive.stats.summary()["counts"]["cost"]
        assert counts["serve_measured"] >= 1
        assert counts["serve_shed"] == 1
        assert counts["serve_admit"] >= 1
        outcomes = srv.stats.summary()["tenants"]["default"]["outcomes"]
        assert outcomes["rejected_cost"] == 1 and outcomes["ok"] == 2
        adm = srv.serving_stats()["admission"]["cost"]
        assert adm["budget_bytes"] == 1200
        assert adm["predicted_bytes"] == {"measured": 900}
        assert adm["inflight_bytes"] == 0
    finally:
        srv.close(timeout=5)
        sess.shutdown()


def test_serve_cost_gate_absent_without_policy(monkeypatch):
    """tests/test_adaptive.py:475: with BIGSLICE_ADAPTIVE unset nothing
    of the gate runs."""
    monkeypatch.delenv("BIGSLICE_ADAPTIVE", raising=False)
    sess = _session()
    srv = ServeServer(sess, port=0)
    srv.register("plain", lambda: bs.Const(1, np.arange(4, dtype=np.int32)))
    try:
        code, _ = srv.invoke_request({"pipeline": "plain"})
        assert code == 200
        assert srv._pipe_cost == {}
        assert "cost" not in srv.serving_stats()["admission"]
    finally:
        srv.close(timeout=5)
        sess.shutdown()


# ------------------------------ probes and the recycled-id guard


def test_probe_compiles_land_in_program_cache(monkeypatch):
    """tests/test_kernelselect.py:225: the measured probe's sort and
    hash programs land in the cross-session program cache; a second
    selector of the process probing the same op shape finds both there
    and builds none."""
    from bigslice_tpu_torch.parallel import kernelselect as ks
    from bigslice_tpu_torch.utils.telemetry import TelemetryHub

    monkeypatch.delenv("BIGSLICE_KERNEL_SELECT", raising=False)
    pc_mod.reset_global_program_cache()
    totals = []
    for _ in range(2):
        hub = TelemetryHub()
        sel = ks.KernelSelector("measured", hub, device="cpu")
        kernel = sel.choose(
            "ksel-cache-op", "s", nkeys=1, nvals=1, ops=("add",),
            key_dtypes=("int32",), val_dtypes=("int32",),
            hash_eligible=True, dense_bound=False)
        assert kernel in ("hash", "sort")
        totals.append(hub.device.summary()["totals"])
    first, second = totals
    assert first["program_builds"] == 2  # the sort core and the hash core
    assert second["program_builds"] == 0
    assert second["cross_session_hits"] == 2


def test_program_cache_guards_recycled_fn_ids():
    """tests/test_meshexec.py:297: a table entry whose stage function
    has been collected (a dead weakref) is made again, never taken for
    the program of a function that happens to reuse its id."""
    import weakref

    from bigslice_tpu_torch.exec import compile as compile_mod
    from bigslice_tpu_torch.exec.meshexec import _ProgramEntry

    ex = MeshExecutor(device="cpu")
    Session(executor=ex)
    s = bs.Map(bs.Const(8, np.arange(16, dtype=np.int32)), lambda x: x + 1)
    task = compile_mod.compile_slice(s)[0]
    stages = ex._stages_for(task)
    ex._program(task, stages, 2.0)
    assert len(ex._programs) == 1
    key = next(iter(ex._programs))
    entry1 = ex._programs[key][0]

    class _Tmp:
        pass

    dead = weakref.ref(_Tmp())  # dies at once
    assert dead() is None
    ex._programs[key] = ("stale", (dead,))
    ex._program(task, stages, 2.0)
    entry2, refs = ex._programs[key]
    assert entry2 != "stale" and isinstance(entry2, _ProgramEntry)
    assert entry2 is not entry1
    assert all(r() is not None for r in refs)
    # A live entry is found again, not made anew.
    ex._program(task, stages, 2.0)
    assert ex._programs[key][0] is entry2
