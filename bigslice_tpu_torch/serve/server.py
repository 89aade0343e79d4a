"""The invocation server: a long-lived, multi-tenant serving surface.

A copy of the JAX package's ``serve/server.py``, adapted to this
package. It grows ``utils/debughttp.py``'s request plumbing into one
resident process that owns the card and serves named pipelines:

- **Named pipelines** (the deterministic ``bigslice.Func`` framing):
  the operator registers ``name -> Func | slice-returning callable``
  at startup; invocations arrive as HTTP/JSON ``POST /serve/invoke``
  with ``{"pipeline", "args", "tenant"}``.
- **Shared wave slots and admission control**: at most ``slots``
  invocations evaluate concurrently on the shared Session (its
  invocation gate keeps them isolated); at most ``queue_depth`` more
  wait. Beyond that the server *sheds* with 503 instead of queuing
  without bound, and a tenant above its ``tenant_quota`` of in-flight
  and queued invocations gets 429, so one noisy tenant cannot starve
  the rest.
- **Deadlines**: a request's ``deadline_s`` is shed 504 at admission
  when the pipeline's measured wall (an EWMA) times its queue position
  cannot fit, 504 when it expires in the queue, and 504 when the
  evaluation's deadline expires mid-flight (the evaluator cancels and
  drains, and the slot goes to the next waiter).
- **Cost gate** (``BIGSLICE_ADAPTIVE=cost``): a pipeline's predicted
  cost is the declared bytes of the kernel launches of its invocations
  that ran alone (``DeviceTelemetry.total_cost_bytes``, summed from
  ``cuda_kernels.cost``), and an invocation that would push the bytes
  admitted past ``BIGSLICE_SERVE_COST_BUDGET_BYTES`` (else the card's
  memory, ``hbm_budget()``) is shed 503 while another runs. In the
  JAX package the bytes are the compiled programs' and accrue at a
  compile only; here they accrue at every run, and the prediction keeps
  the largest sole-invocation delta, so that it stays stable.
- **Per-tenant metrics**: requests and outcomes, latency quantiles,
  rows served: ``telemetry_summary()["serving"]``, Prometheus
  (``bigslice_serving_*`` on ``/debug/metrics``) and ``GET
  /serve/stats``.
- **Cross-request result cache**: a pipeline registered with
  ``cache=True`` runs under ``ops/cache.py``'s writethrough tier,
  keyed by (pipeline, args digest) below ``result_cache_dir``, so that
  repeat invocations are file reads, with hit and miss accounting
  (``bigslice_result_cache_total{outcome}``).
- **Session swap**: ``attach_session()`` moves the server onto a fresh
  Session. The process's cold costs (the kernel library's build, the
  CUDA context) are paid once a process, and the cross-Session program
  cache (``serve/programcache.py``) shows the fresh Session's programs
  as ones the process served before.
- **Graceful shutdown**: ``close()`` rejects new work, drains in-flight
  invocations (bounded), prints a final snapshot line, then releases
  the socket. SIGTERM in ``tools/sliceserve.py`` lands here.

The debug surface (``/debug/*``) rides on the same listener through
the ``DebugServer`` base class.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from bigslice_tpu_torch.exec.evaluate import DeadlineExceeded
from bigslice_tpu_torch.utils.debughttp import DebugServer

# Bounded per-tenant latency samples (quantiles stay meaningful, a
# week of traffic doesn't grow the server).
MAX_LATENCY_SAMPLES = 4096

# Rows returned inline per invocation unless the caller asks for
# fewer; bounds response payloads, not the computation.
DEFAULT_MAX_ROWS = 4096


def _quantile(sorted_xs: List[float], p: float) -> float:
    n = len(sorted_xs)
    if n == 0:
        return 0.0
    if n == 1:
        return sorted_xs[0]
    i = p * (n - 1)
    lo = int(i)
    hi = min(lo + 1, n - 1)
    return sorted_xs[lo] + (sorted_xs[hi] - sorted_xs[lo]) * (i - lo)


def _jsonable(v):
    """Result-row cell → JSON-serializable (numpy scalars/vectors)."""
    if hasattr(v, "tolist"):
        return v.tolist()
    if hasattr(v, "item"):
        return v.item()
    return v


class Pipeline:
    """One registered pipeline: a ``Func`` or a slice-returning
    callable, plus its serving options."""

    def __init__(self, name: str, fn, cache: bool = False,
                 description: str = ""):
        self.name = name
        self.fn = fn
        self.cache = cache
        self.description = (description
                           or (getattr(fn, "__doc__", None) or ""
                               ).strip().split("\n")[0])


class _TenantRecord:
    def __init__(self):
        self.requests = 0
        self.outcomes: Dict[str, int] = {}
        self.latencies: List[float] = []
        self.rows = 0
        self.inflight = 0  # active + queued right now


class ServingStats:
    """Per-tenant serving accounting, hub-attachable: the telemetry
    hub surfaces ``summary()`` as ``telemetry_summary()["serving"]``
    and ``prometheus_lines()`` under ``/debug/metrics``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantRecord] = {}
        self.active = 0
        self.queued = 0
        self.shed_total = 0

    def _tenant(self, tenant: str) -> _TenantRecord:
        rec = self._tenants.get(tenant)
        if rec is None:
            rec = self._tenants[tenant] = _TenantRecord()
        return rec

    def record(self, tenant: str, outcome: str,
               latency_s: Optional[float] = None,
               rows: int = 0) -> None:
        with self._lock:
            rec = self._tenant(tenant)
            rec.requests += 1
            rec.outcomes[outcome] = rec.outcomes.get(outcome, 0) + 1
            if outcome.startswith("rejected"):
                self.shed_total += 1
            if latency_s is not None:
                if len(rec.latencies) >= MAX_LATENCY_SAMPLES:
                    rec.latencies.pop(0)
                rec.latencies.append(latency_s)
            rec.rows += max(0, int(rows))

    def tenant_inflight(self, tenant: str) -> int:
        with self._lock:
            rec = self._tenants.get(tenant)
            return rec.inflight if rec else 0

    def adjust_inflight(self, tenant: str, delta: int) -> None:
        with self._lock:
            self._tenant(tenant).inflight += delta

    def summary(self) -> dict:
        with self._lock:
            tenants = {}
            tot_requests = tot_rows = 0
            all_lats: List[float] = []
            for name, rec in self._tenants.items():
                ls = sorted(rec.latencies)
                entry = {
                    "requests": rec.requests,
                    "outcomes": dict(rec.outcomes),
                    "rows": rec.rows,
                    "inflight": rec.inflight,
                }
                if ls:
                    entry["latency"] = {
                        "n": len(ls),
                        "p50_s": round(_quantile(ls, 0.5), 6),
                        "p99_s": round(_quantile(ls, 0.99), 6),
                        "max_s": round(ls[-1], 6),
                    }
                tenants[name] = entry
                tot_requests += rec.requests
                tot_rows += rec.rows
                all_lats.extend(ls)
            all_lats.sort()
            out = {
                "tenants": tenants,
                "totals": {
                    "requests": tot_requests,
                    "rows": tot_rows,
                    "shed": self.shed_total,
                    "active": self.active,
                    "queued": self.queued,
                },
            }
            if all_lats:
                out["totals"]["latency"] = {
                    "n": len(all_lats),
                    "p50_s": round(_quantile(all_lats, 0.5), 6),
                    "p99_s": round(_quantile(all_lats, 0.99), 6),
                }
            return out

    def prometheus_lines(self, metric, line) -> None:
        with self._lock:
            tenants = {
                name: (dict(rec.outcomes), sorted(rec.latencies),
                       rec.rows)
                for name, rec in self._tenants.items()
            }
            active, queued = self.active, self.queued
        metric("bigslice_serving_requests_total",
               "Pipeline invocations by tenant and outcome "
               "(serve/server.py admission + execution).", "counter")
        for name, (outcomes, _, _) in tenants.items():
            for outcome, n in sorted(outcomes.items()):
                line("bigslice_serving_requests_total",
                     {"tenant": name, "outcome": outcome}, n)
        metric("bigslice_serving_latency_seconds",
               "Invocation latency quantiles per tenant (admission to "
               "response).", "summary")
        for name, (_, ls, _) in tenants.items():
            if not ls:
                continue
            for q in (0.5, 0.99):
                line("bigslice_serving_latency_seconds",
                     {"tenant": name, "quantile": str(q)},
                     f"{_quantile(ls, q):.6f}")
            line("bigslice_serving_latency_seconds_count",
                 {"tenant": name}, len(ls))
            line("bigslice_serving_latency_seconds_sum",
                 {"tenant": name}, f"{sum(ls):.6f}")
        metric("bigslice_serving_rows_total",
               "Result rows served per tenant.", "counter")
        for name, (_, _, rows) in tenants.items():
            if rows:
                line("bigslice_serving_rows_total", {"tenant": name},
                     rows)
        metric("bigslice_serving_inflight",
               "Invocations currently evaluating (active) or waiting "
               "for a wave slot (queued).", "gauge")
        line("bigslice_serving_inflight", {"state": "active"}, active)
        line("bigslice_serving_inflight", {"state": "queued"}, queued)


class ServeServer(DebugServer):
    """HTTP serving front end over one shared Session (see module
    docstring). ``slots`` bounds concurrent evaluations, ``queue_depth``
    bounds waiters (beyond → 503), ``tenant_quota`` bounds one
    tenant's in-flight+queued invocations (beyond → 429; ``None`` =
    unlimited)."""

    def __init__(self, session, port: int = 0, slots: int = 2,
                 queue_depth: int = 16,
                 tenant_quota: Optional[int] = None,
                 result_cache_dir: Optional[str] = None,
                 result_cache_ttl_s: Optional[float] = ...,
                 result_cache_max_bytes: Optional[int] = ...,
                 default_tenant: str = "default"):
        self._pipelines: Dict[str, Pipeline] = {}
        self._pipe_lock = threading.Lock()
        self.slots = max(1, int(slots))
        self.queue_depth = max(0, int(queue_depth))
        self.tenant_quota = tenant_quota
        self.result_cache_dir = result_cache_dir
        # Result-cache eviction policy (ops/cache.py: TTL + byte-
        # bounded LRU — PR-14's named follow-on; entries no longer
        # live forever). Omitted arguments keep the env-seeded policy
        # (BIGSLICE_RESULT_CACHE_TTL_S / _MAX_BYTES); None disables.
        if result_cache_ttl_s is not ... or \
                result_cache_max_bytes is not ...:
            from bigslice_tpu_torch.ops.cache import configure_result_cache

            configure_result_cache(ttl_s=result_cache_ttl_s,
                                   max_bytes=result_cache_max_bytes)
        self.default_tenant = default_tenant
        self.stats = ServingStats()
        # Admission state: one lock guards the active/queued counters
        # (decisions must be atomic — a race could admit past the
        # bound); a Condition hands freed slots to waiters FIFO-ish.
        self._adm = threading.Condition()
        # Cost-keyed admission (exec/adaptive.py "cost" policy): per-
        # pipeline measured invocation cost (the declared bytes of the
        # kernel launches of an invocation that ran alone, the largest
        # seen) and the sum currently admitted against the device
        # budget. Both stay zero unless the Session carries an adaptive
        # planner with the cost policy engaged (BIGSLICE_ADAPTIVE), so
        # the knob-off path is untouched.
        self._pipe_cost: Dict[str, int] = {}
        self._cost_inflight = 0
        # Deadline admission (PR-20 ladder): per-pipeline wall-clock
        # EWMA, measured from completed invocations. A request with a
        # ``deadline_s`` budget is shed 504-early at admission when
        # the predicted wall (EWMA × (1 + its queue position)) already
        # exceeds the remaining budget — failing in microseconds what
        # would otherwise burn a slot and fail anyway. Empty until the
        # first completion, so an unmeasured pipeline always admits.
        self._pipe_latency: Dict[str, float] = {}
        # Correlation-id sequence: invocations with no caller-supplied
        # ``corr`` get ``<pipeline>:<seq>``. Deterministic across SPMD
        # ranks by the same-program contract (every rank's server sees
        # the identical invocation stream in the same order), so the
        # id stitches one serve request across every rank's trace.
        self._corr_seq = itertools.count(1)
        self._started = time.time()
        super().__init__(session, port)
        self._hook_session(session)

    # -- session attachment ----------------------------------------------

    def _hook_session(self, session) -> None:
        hub = getattr(session, "telemetry", None)
        if hub is not None:
            hub.serving = self.stats
        setattr(session, "serve", self)

    def attach_session(self, session) -> None:
        """Swap the server onto a fresh Session (same process: the
        kernels are built and the program cache shows the fresh
        Session's programs as hits). In-flight invocations keep the
        Session they started on."""
        old = self.session
        with self._adm:
            self.session = session
        self._hook_session(session)
        if old is not None and getattr(old, "serve", None) is self:
            old.serve = None

    # -- pipeline registry -------------------------------------------------

    def register(self, name: str, fn, cache: bool = False,
                 description: str = "") -> Pipeline:
        """Register ``name`` → a ``Func`` or slice-returning callable.
        ``cache=True`` runs invocations under the ops/cache.py
        writethrough tier keyed by (name, args digest) below
        ``result_cache_dir``."""
        from bigslice_tpu_torch import typecheck

        typecheck.check(callable(fn),
                        "serve.register(%s): fn must be callable", name)
        if cache and not self.result_cache_dir:
            raise ValueError(
                f"pipeline {name}: cache=True needs a "
                f"result_cache_dir on the server"
            )
        pipe = Pipeline(name, fn, cache=cache, description=description)
        with self._pipe_lock:
            self._pipelines[name] = pipe
        return pipe

    def pipelines(self) -> dict:
        with self._pipe_lock:
            return {
                name: {"description": p.description,
                       "cache": p.cache}
                for name, p in self._pipelines.items()
            }

    # -- HTTP routes -------------------------------------------------------

    def index_lines(self) -> List[str]:
        return [
            "bigslice_tpu_torch serving plane",
            "",
            "POST /serve/invoke  {\"pipeline\", \"args\", \"tenant\"}"
            "  run a registered pipeline",
            "GET  /serve/pipelines  registered pipelines (json)",
            "GET  /serve/stats  per-tenant serving stats + program/"
            "result cache (json)",
            "GET  /healthz  liveness (json)",
            "",
        ] + super().index_lines()

    def handle_get(self, handler, parsed) -> bool:
        path = parsed.path
        if path in ("/serve", "/serve/"):
            handler._send(200, "text/plain",
                          "\n".join(self.index_lines()) + "\n")
        elif path == "/serve/pipelines":
            handler._send_json(200, self.pipelines())
        elif path == "/serve/stats":
            handler._send_json(200, self.serving_stats())
        elif path == "/healthz":
            handler._send_json(200, {
                "ok": True,
                "uptime_s": round(time.time() - self._started, 3),
                "pipelines": sorted(self.pipelines()),
            })
        else:
            return super().handle_get(handler, parsed)
        return True

    def handle_post(self, handler, parsed) -> bool:
        if parsed.path != "/serve/invoke":
            return super().handle_post(handler, parsed)
        body = handler._read_body()
        if body is None:
            handler._send_json(413, {"error": "request body too "
                                              "large"})
            return True
        try:
            req = json.loads(body or b"{}")
        except ValueError:
            handler._send_json(400, {"error": "invalid JSON body"})
            return True
        code, doc = self.invoke_request(req)
        handler._send_json(code, doc)
        return True

    # -- invocation path ---------------------------------------------------

    def serving_stats(self) -> dict:
        from bigslice_tpu_torch.ops.cache import result_cache_counts
        from bigslice_tpu_torch.serve.programcache import (
            program_cache_stats,
        )

        from bigslice_tpu_torch.ops.cache import result_cache_policy

        doc = self.stats.summary()
        doc["program_cache"] = program_cache_stats()
        doc["result_cache"] = result_cache_counts()
        doc["result_cache_policy"] = result_cache_policy()
        doc["admission"] = {
            "slots": self.slots,
            "queue_depth": self.queue_depth,
            "tenant_quota": self.tenant_quota,
        }
        with self._adm:
            if self._pipe_latency:
                doc["admission"]["latency_ewma_s"] = {
                    k: round(v, 6)
                    for k, v in self._pipe_latency.items()
                }
        if self._cost_planner() is not None:
            with self._adm:
                doc["admission"]["cost"] = {
                    "budget_bytes": self._cost_budget(),
                    "inflight_bytes": self._cost_inflight,
                    "predicted_bytes": dict(self._pipe_cost),
                }
        return doc

    def _cost_planner(self):
        """The Session's adaptive planner when its cost policy is
        engaged, else None (the chicken bit for cost-keyed admission —
        BIGSLICE_ADAPTIVE unset means this returns None and every
        cost-admission branch below is dead)."""
        planner = getattr(self.session, "adaptive", None)
        if planner is None or "cost" not in getattr(
                planner, "policies", ()):
            return None
        return planner

    def _cost_budget(self) -> int:
        """Admission byte budget: BIGSLICE_SERVE_COST_BUDGET_BYTES if
        set, else the measured per-device HBM budget (0 = no gate)."""
        raw = os.environ.get("BIGSLICE_SERVE_COST_BUDGET_BYTES")
        if raw:
            try:
                return max(0, int(raw))
            except ValueError:
                pass
        hub = getattr(self.session, "telemetry", None)
        dev = getattr(hub, "device", None)
        if dev is not None:
            try:
                return int(dev.hbm_budget() or 0)
            except Exception:
                return 0
        return 0

    def invoke_request(self, req: dict):
        """The full admission + execution path for one invocation
        request (the HTTP handler and tests call this directly).
        Returns ``(http_status, response_doc)``."""
        name = req.get("pipeline")
        args = req.get("args") or []
        tenant = str(req.get("tenant") or self.default_tenant)
        # Correlation id: caller-supplied (end-to-end tracing across
        # services) or minted here — threaded through Session.run into
        # every rank's trace and echoed in the response, so one serve
        # request is traceable request → evaluation → wave → task on
        # every rank (slicetrace --merge joins on it).
        corr = str(req.get("corr") or "") \
            or f"{name}:{next(self._corr_seq)}"
        want_rows = bool(req.get("rows", True))
        try:
            max_rows = int(req.get("max_rows", DEFAULT_MAX_ROWS))
        except (TypeError, ValueError):
            return 400, {"error": "max_rows must be an integer"}
        if not isinstance(args, list):
            return 400, {"error": "args must be a JSON array"}
        deadline_s = req.get("deadline_s")
        if deadline_s is not None:
            try:
                deadline_s = float(deadline_s)
            except (TypeError, ValueError):
                return 400, {"error": "deadline_s must be a number"}
            if deadline_s <= 0:
                return 400, {"error": "deadline_s must be > 0"}
        # Absolute budget, stamped before admission: queue wait, wave
        # evaluation and row materialisation all spend from the same
        # clock the caller started.
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        with self._pipe_lock:
            pipe = self._pipelines.get(name)
        if pipe is None:
            return 404, {
                "error": f"unknown pipeline {name!r}",
                "pipelines": sorted(self.pipelines()),
            }

        # -- admission (atomic under the condition's lock) ------------
        planner = self._cost_planner()
        predicted = 0
        with self._adm:
            if self._closing:
                self.stats.record(tenant, "rejected_closing")
                return 503, {"error": "shutting down"}
            if (self.tenant_quota is not None
                    and self.stats.tenant_inflight(tenant)
                    >= self.tenant_quota):
                self.stats.record(tenant, "rejected_quota")
                return 429, {
                    "error": f"tenant {tenant!r} is at its quota of "
                             f"{self.tenant_quota} in-flight "
                             f"invocations",
                    "retry": True,
                }
            if (self.stats.active >= self.slots
                    and self.stats.queued >= self.queue_depth):
                self.stats.record(tenant, "rejected_capacity")
                return 503, {
                    "error": f"admission queue full "
                             f"({self.slots} slots + "
                             f"{self.queue_depth} queued)",
                    "retry": True,
                }
            if deadline is not None:
                # Predictive 504: shed now if this pipeline's measured
                # wall × (1 + queue position) can't fit the budget.
                ewma = float(self._pipe_latency.get(name) or 0.0)
                queue_pos = (self.stats.queued
                             if self.stats.active >= self.slots else 0)
                predicted_wall = ewma * (1 + queue_pos)
                remaining = deadline - time.monotonic()
                if ewma > 0.0 and predicted_wall > remaining:
                    self.stats.record(tenant, "deadline_exceeded")
                    self._record_deadline("rejected", tenant,
                                          deadline_s)
                    return 504, {
                        "error": f"deadline {deadline_s}s cannot be "
                                 f"met: predicted wall "
                                 f"{predicted_wall:.3f}s "
                                 f"(EWMA {ewma:.3f}s × "
                                 f"{1 + queue_pos} queue position) "
                                 f"exceeds remaining "
                                 f"{max(0.0, remaining):.3f}s",
                        "retry": False,
                    }
            if planner is not None:
                # Cost gate: shed when this pipeline's predicted bytes-
                # accessed would push the admitted total past the
                # budget. The _cost_inflight > 0 guard means an idle
                # server always admits — an over-budget pipeline still
                # runs alone, it just can't stack.
                predicted = int(self._pipe_cost.get(name) or 0)
                budget = self._cost_budget()
                if (budget and predicted and self._cost_inflight > 0
                        and self._cost_inflight + predicted > budget):
                    planner.stats.record(
                        "cost", "serve_shed", pipeline=name,
                        predicted_bytes=predicted,
                        inflight_bytes=self._cost_inflight,
                        budget_bytes=budget)
                    self.stats.record(tenant, "rejected_cost")
                    return 503, {
                        "error": f"pipeline {name!r} predicted cost "
                                 f"{predicted}B would exceed the "
                                 f"admission budget ({budget}B, "
                                 f"{self._cost_inflight}B in flight)",
                        "retry": True,
                    }
                if predicted:
                    planner.note_cost_action(
                        "serve_admit", name,
                        predicted_bytes=predicted)
            self.stats.adjust_inflight(tenant, +1)
            if self.stats.active < self.slots:
                self.stats.active += 1
            else:
                self.stats.queued += 1
                while self.stats.active >= self.slots:
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            # Budget burned in the queue: shed without
                            # ever taking a slot.
                            self.stats.queued -= 1
                            self.stats.adjust_inflight(tenant, -1)
                            self.stats.record(tenant,
                                              "deadline_exceeded")
                            self._record_deadline("expired", tenant,
                                                  deadline_s)
                            return 504, {
                                "error": f"deadline {deadline_s}s "
                                         f"expired while queued",
                                "retry": False,
                            }
                        self._adm.wait(timeout=remaining)
                    else:
                        self._adm.wait()
                    if self._closing:
                        self.stats.queued -= 1
                        self.stats.adjust_inflight(tenant, -1)
                        self.stats.record(tenant, "rejected_closing")
                        return 503, {"error": "shutting down"}
                self.stats.queued -= 1
                self.stats.active += 1
            self._cost_inflight += predicted
            sole = self.stats.active == 1

        t0 = time.perf_counter()
        b0 = self._cost_probe() if planner is not None else 0
        try:
            doc = self._run(pipe, args, want_rows, max_rows,
                            corr=corr, deadline=deadline)
            if planner is not None:
                self._cost_measure(planner, name, b0, sole)
        except DeadlineExceeded as e:
            # Mid-flight expiry: the evaluator already cancelled and
            # drained the remaining tasks; the finally below releases
            # this slot to the next queued tenant immediately.
            latency = time.perf_counter() - t0
            self.stats.record(tenant, "deadline_exceeded", latency)
            self._record_deadline("expired", tenant, deadline_s)
            return 504, {
                "error": str(e),
                "pipeline": name,
                "corr": corr,
                "latency_s": round(latency, 6),
                "pending_tasks": e.pending,
                "retry": False,
            }
        except Exception as e:  # noqa: BLE001 — serve errors as JSON
            latency = time.perf_counter() - t0
            self.stats.record(tenant, "error", latency)
            return 500, {
                "error": f"{type(e).__name__}: {e}",
                "pipeline": name,
                "corr": corr,
                "latency_s": round(latency, 6),
            }
        finally:
            with self._adm:
                self.stats.active -= 1
                self._cost_inflight -= predicted
                self.stats.adjust_inflight(tenant, -1)
                self._adm.notify_all()
        latency = time.perf_counter() - t0
        with self._adm:
            prev = self._pipe_latency.get(name)
            # EWMA (alpha 0.3): tracks drift without letting one cold
            # first request poison the admission predictor forever.
            self._pipe_latency[name] = (
                latency if prev is None else 0.7 * prev + 0.3 * latency
            )
        if deadline_s is not None:
            self._record_deadline("met", tenant, deadline_s)
        self.stats.record(tenant, "ok", latency,
                          rows=doc.get("num_rows", 0))
        doc.update({
            "pipeline": name,
            "tenant": tenant,
            "corr": corr,
            "latency_s": round(latency, 6),
        })
        return 200, doc

    def _record_deadline(self, outcome: str, tenant: str,
                         deadline_s: Optional[float]) -> None:
        """Fold one deadline outcome into the hub's DeadlineStats
        (per-tenant, source='serve'). Best-effort: accounting never
        fails a request."""
        hub = getattr(self.session, "telemetry", None)
        if hub is None:
            return
        try:
            hub.record_deadline(outcome, tenant=tenant,
                                deadline_s=deadline_s, source="serve")
        except Exception:
            pass

    def _cost_probe(self) -> int:
        """The session's declared launch bytes so far (the
        measurement baseline for one invocation's cost delta)."""
        hub = getattr(self.session, "telemetry", None)
        dev = getattr(hub, "device", None)
        if dev is None:
            return 0
        try:
            return int(dev.total_cost_bytes())
        except Exception:
            return 0

    def _cost_measure(self, planner, name: str, b0: int,
                      sole: bool) -> None:
        """Fold one invocation's measured cost delta into the
        pipeline's prediction. Only sole-in-flight invocations update
        it (a concurrent invocation's launches would pollute the
        delta). Declared bytes accrue at every run, not at a compile
        as in the JAX package, so the prediction keeps the largest
        delta seen: repeats of the same work leave it stable."""
        delta = self._cost_probe() - b0
        if not sole or delta <= 0:
            return
        with self._adm:
            prev = int(self._pipe_cost.get(name) or 0)
            if delta > prev:
                self._pipe_cost[name] = int(delta)
        if delta > prev:
            planner.stats.record("cost", "serve_measured",
                                 pipeline=name, cost_bytes=int(delta))

    def _cache_prefix(self, pipe: Pipeline, args) -> str:
        digest = hashlib.sha1(repr(tuple(args)).encode()).hexdigest()
        return os.path.join(self.result_cache_dir,
                            f"{pipe.name}-{digest[:12]}")

    def _run(self, pipe: Pipeline, args, want_rows: bool,
             max_rows: int, corr: Optional[str] = None,
             deadline: Optional[float] = None) -> dict:
        """Evaluate one invocation on the shared Session. Cached
        pipelines build their slice and run it under the ops/cache.py
        writethrough tier; plain ones go straight through
        ``Session.run`` (Func memoization and pragmas intact).
        ``corr`` rides into the run's invocation trace instant;
        ``deadline`` (absolute monotonic) becomes the evaluation's
        remaining budget — whatever the queue left of it."""
        session = self.session
        remaining = None
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise DeadlineExceeded(deadline_s=0.0, pending=0)
        if pipe.cache:
            from bigslice_tpu_torch.ops.base import Slice
            from bigslice_tpu_torch.ops.cache import Cache

            slice_ = pipe.fn(*args)
            if not isinstance(slice_, Slice):
                raise TypeError(
                    f"pipeline {pipe.name} returned "
                    f"{type(slice_).__name__}, expected a Slice"
                )
            res = session.run(Cache(slice_,
                                    self._cache_prefix(pipe, args)),
                              corr=corr, deadline_s=remaining)
        else:
            res = session.run(pipe.fn, *args, corr=corr,
                              deadline_s=remaining)

        rows: List[list] = []
        num_rows = 0
        for f in res.frames():
            n = len(f)
            num_rows += n
            if want_rows and len(rows) < max_rows:
                take = min(n, max_rows - len(rows))
                for row in itertools.islice(f.to_host().rows(), take):
                    rows.append([_jsonable(v) for v in row])
        res.discard()
        doc = {"num_rows": num_rows}
        if want_rows:
            doc["rows"] = rows
            doc["rows_truncated"] = num_rows > len(rows)
        return doc

    # -- shutdown ----------------------------------------------------------

    def close(self, timeout: float = 30.0) -> None:
        """Graceful shutdown: reject new invocations (503), wake
        queued waiters so they shed, drain in-flight HTTP handlers
        (which carry the running invocations), flush a final telemetry
        snapshot, then release the socket. Idempotent — the session's
        own shutdown() calls back in here."""
        with self._adm:
            if getattr(self, "_closed", False):
                return
            self._closed = True
            self._closing = True
            self._adm.notify_all()
        super().close(timeout)
        self._final_snapshot()

    def _final_snapshot(self, stream=None) -> None:
        """StatusPrinter-style last word: the serving totals and cache
        effectiveness an operator wants in the log right before the
        process exits (never raises — shutdown must finish)."""
        stream = stream or sys.stderr
        try:
            doc = self.serving_stats()
            tot = doc.get("totals", {})
            pc = doc.get("program_cache", {})
            rc = doc.get("result_cache", {})
            lat = tot.get("latency", {})
            print(
                f"sliceserve: shutdown after "
                f"{tot.get('requests', 0)} requests "
                f"({tot.get('shed', 0)} shed), "
                f"{tot.get('rows', 0)} rows; p50 "
                f"{lat.get('p50_s', 0)}s p99 {lat.get('p99_s', 0)}s; "
                f"program cache {pc.get('hits', 0)} hits / "
                f"{pc.get('misses', 0)} misses "
                f"({pc.get('compile_s_saved', 0)}s of builds saved); "
                f"result cache {rc.get('hit', 0)} hits / "
                f"{rc.get('miss', 0)} misses",
                file=stream, flush=True,
            )
            hub = getattr(self.session, "telemetry", None)
            if hub is not None:
                for line in hub.status_lines():
                    print(f"sliceserve:{line}", file=stream,
                          flush=True)
        except Exception:
            pass
