"""Debug HTTP server: live status, task DAG, trace download, metrics.

A copy of the JAX package's ``utils/debughttp.py``, adapted to this
package's planes. ``Session(debug_port=N)`` starts it (0 picks a free
port, ``session.debug.port`` says which). Its routes (reference
``:60-195``):

- ``/debug``: the index;
- ``/debug/status``: the live per-op task counts (``utils/status.py``);
- ``/debug/tasks``: the task DAG as JSON (the d3 force-graph data);
- ``/debug/trace``: the Chrome trace of the session so far;
- ``/debug/resources``: the executor's resource gauges;
- ``/debug/metrics``: the telemetry hub in Prometheus text format;
- ``/debug/device``: the device plane (``utils/devicetelemetry.py``):
  kernel launches with their declared bytes and operations, builds,
  HBM watermarks, donation. Its ``compile`` section is empty by design:
  this package compiles no wave program;
- ``/debug/profile?seconds=N``: a ``torch.profiler`` window of the live
  process (``utils/xprof.py``); a second window while one is live
  gets 409;
- ``/debug/fleet``: the cross-rank merge (``utils/fleettelemetry.py``),
  json, or rank-labelled Prometheus series with ``?format=prom``.

The request plumbing (a threaded server, GET/POST dispatch through an
overridable route method, a bounded body read, in-flight tracking with
a draining ``close()``) is what the serving plane's ``ServeServer``
(``serve/server.py``) subclasses.

``close()`` **drains**: it stops admitting requests (503), waits,
bounded by ``DRAIN_TIMEOUT_S``, for those in flight, then releases the
socket.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List
from urllib.parse import parse_qs, urlparse

# How long close() waits for in-flight handlers before it closes the
# socket anyway (a wedged profile window must not hang shutdown).
DRAIN_TIMEOUT_S = 10.0


class DebugServer:
    def __init__(self, session, port: int = 0):
        self.session = session
        self._roots: List = []
        self._lock = threading.Lock()
        # In-flight accounting for the draining close() (reference
        # :288-306): every request enters and exits; close() sets
        # _closing (new requests get 503) and waits for zero.
        self._inflight = 0
        self._inflight_cond = threading.Condition()
        self._closing = False

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if not server._enter(self):
                    return
                try:
                    parsed = urlparse(self.path)
                    if not server.handle_get(self, parsed):
                        self._send(404, "text/plain", "not found\n")
                finally:
                    server._exit()

            def do_POST(self):
                if not server._enter(self):
                    return
                try:
                    parsed = urlparse(self.path)
                    if not server.handle_post(self, parsed):
                        self._send(404, "text/plain", "not found\n")
                finally:
                    server._exit()

            def _read_body(self, limit: int = 16 << 20):
                """The request body, or None when its Content-Length
                exceeds ``limit`` (the caller answers 413: an oversized
                request must not pass for an empty one; reference
                :85-95)."""
                n = int(self.headers.get("Content-Length") or 0)
                if n > limit:
                    return None
                if n <= 0:
                    return b""
                return self.rfile.read(n)

            def _send(self, code, ctype, body: str):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _send_json(self, code, doc):
                self._send(code, "application/json",
                           json.dumps(doc, default=str))

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name="bigslice-debughttp")
        self._thread.start()

    # -- in-flight accounting (the draining close) ------------------------

    def _enter(self, handler) -> bool:
        with self._inflight_cond:
            if self._closing:
                try:
                    handler._send(503, "text/plain", "shutting down\n")
                except OSError:
                    pass
                return False
            self._inflight += 1
        return True

    def _exit(self) -> None:
        with self._inflight_cond:
            self._inflight -= 1
            self._inflight_cond.notify_all()

    # -- route tables (a serving server overrides and extends them) -------

    def index_lines(self) -> List[str]:
        return [
            "bigslice_tpu_torch debug",
            "",
            "/debug/status  live task-state counts",
            "/debug/tasks   task DAG (json)",
            "/debug/trace   chrome trace (json)",
            "/debug/resources  device memory/RSS/combiner gauges (json)",
            "/debug/metrics  telemetry in Prometheus text format",
            "/debug/fleet   cross-rank merged telemetry (json;"
            " ?format=prom for rank-labelled series)",
            "/debug/device  device plane: kernel launches, declared"
            " bytes and operations, HBM, donation (json)",
            "/debug/profile?seconds=N  windowed torch.profiler trace of"
            " the live process (json)",
        ]

    def handle_get(self, handler, parsed) -> bool:
        """Serve one GET; False for 'no such route' (the handler 404s).
        A subclass handles its own paths first and falls back here."""
        path = parsed.path
        session = self.session
        if path in ("/debug", "/debug/"):
            handler._send(200, "text/plain",
                          "\n".join(self.index_lines()) + "\n")
        elif path == "/debug/status":
            handler._send(200, "text/plain",
                          session.status.render() or "(idle)")
        elif path == "/debug/tasks":
            handler._send_json(200, self.task_graph())
        elif path == "/debug/resources":
            stats_fn = getattr(session.executor, "resource_stats", None)
            handler._send_json(
                200, stats_fn() if stats_fn is not None else {})
        elif path == "/debug/metrics":
            hub = getattr(session, "telemetry", None)
            text = hub.prometheus_text() if hub else ""
            handler._send(200, "text/plain; version=0.0.4", text)
        elif path == "/debug/fleet":
            self._fleet(handler, parse_qs(parsed.query))
        elif path == "/debug/device":
            hub = getattr(session, "telemetry", None)
            dev = getattr(hub, "device", None)
            handler._send_json(
                200, dev.summary() if dev is not None else {})
        elif path == "/debug/profile":
            self._profile(handler, parse_qs(parsed.query))
        elif path == "/debug/trace":
            tracer = session.tracer
            events = tracer.events() if tracer else []
            handler._send_json(200, {"traceEvents": events})
        else:
            return False
        return True

    def handle_post(self, handler, parsed) -> bool:
        """No POST routes on the debug surface."""
        return False

    def _fleet(self, handler, query):
        """The fleet's scrape surface (reference :199-231): the
        cross-rank merged summary (json), or rank-labelled
        ``bigslice_*{rank=}`` Prometheus series with ``?format=prom``.
        Without a fleet exporter it is this process's own fleet of one:
        the endpoint's shape never depends on the deployment. A merge
        that fails answers 500 with its error."""
        session = self.session
        fmt = (query.get("format") or ["json"])[0]
        if fmt in ("prom", "prometheus"):
            from bigslice_tpu_torch.utils import fleettelemetry as fleet_mod

            fleet = getattr(session, "fleet", None)
            hub = getattr(session, "telemetry", None)
            try:
                if fleet is not None:
                    snaps = fleet.pull()
                elif hub is not None:
                    snaps = [hub.snapshot()]
                else:
                    snaps = []
                text = fleet_mod.prometheus_fleet_text(snaps)
            except Exception as e:  # noqa: BLE001 — reported, not raised
                handler._send(500, "text/plain",
                              f"fleet scrape failed: {e!r}\n")
                return
            handler._send(200, "text/plain; version=0.0.4", text)
            return
        try:
            doc = session.telemetry_summary(scope="fleet")
        except Exception as e:  # noqa: BLE001 — reported, not raised
            handler._send(500, "text/plain", f"fleet merge failed: {e!r}\n")
            return
        handler._send_json(200, doc)

    def _profile(self, handler, query):
        """A windowed profile (reference :233-264): blocks this request's
        thread for the window (the server is threaded, the other routes
        stay live) and answers the trace directory and its files; 409
        when another window or evaluation trace holds the profiler."""
        from bigslice_tpu_torch.utils.xprof import ProfilerBusy

        profiler = getattr(self.session, "profiler", None)
        if profiler is None:
            handler._send(404, "text/plain",
                          "no profiler on this session\n")
            return
        try:
            seconds = float(query.get("seconds", ["1"])[0])
        except (TypeError, ValueError):
            handler._send(400, "text/plain", "seconds must be a number\n")
            return
        try:
            result = profiler.window(seconds)
        except ProfilerBusy as e:
            handler._send(409, "text/plain", f"{e}\n")
            return
        except Exception as e:  # noqa: BLE001 — report, not crash
            handler._send(500, "text/plain", f"profiling failed: {e!r}\n")
            return
        handler._send_json(200, result)

    def register_roots(self, roots) -> None:
        with self._lock:
            self._roots.extend(roots)

    def task_graph(self) -> dict:
        """Every registered run's tasks (reference :266-286), over
        ``exec/task.iter_tasks``."""
        from bigslice_tpu_torch.exec.task import iter_tasks

        with self._lock:
            roots = list(self._roots)
        nodes, links = [], []
        for t in iter_tasks(roots):
            nodes.append({
                "id": str(t.name),
                "op": t.name.op,
                "shard": t.name.shard,
                "state": t.state.name,
            })
            for d in t.deps:
                for p in d.tasks:
                    links.append({
                        "source": str(p.name),
                        "target": str(t.name),
                        "partition": d.partition,
                    })
        return {"nodes": nodes, "links": links}

    def drain(self, timeout: float = DRAIN_TIMEOUT_S) -> bool:
        """Stop admitting requests and wait (bounded) for those in
        flight. True when fully drained."""
        deadline = time.monotonic() + max(0.0, timeout)
        with self._inflight_cond:
            self._closing = True
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._inflight_cond.wait(remaining)
        return True

    def close(self, timeout: float = DRAIN_TIMEOUT_S) -> None:
        """Drain (bounded), then stop the accept loop and release the
        socket."""
        self.drain(timeout)
        self.httpd.shutdown()
        self.httpd.server_close()
