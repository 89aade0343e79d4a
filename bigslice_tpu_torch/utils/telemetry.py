"""Session-scoped telemetry hub: skew, stragglers, wave overlap.

The raw observability channels (task-state transitions, the Chrome
trace, resource gauges) leave their reading to the operator. At scale
the questions that matter are aggregates: is this shuffle skewed, which
shard straggles, how much of the wave pipeline's prefetch hides behind
compute. ``TelemetryHub`` subscribes to the channels that exist (the
``(task, state)`` monitor chain, the ``on_phase`` wave channel of
``exec/evaluate.py``, and the executors' shuffle, staging and device
seams) and computes:

1. **Shuffle skew**: per-partition row and byte sizes at every shuffle
   boundary, summed per op, with a skew ratio (max / median) and the
   hot partition's index. The local executor reports rows *routed* per
   partition (before its combine); the device executor reports each
   partition's rows out of the map side's combine, read with the
   signals each wave's settle reads anyway.
2. **Stragglers**: per-task duration quantiles per op (from
   ``Task.state_times``), flagging a completed task slower than
   ``straggler_factor`` times the p50 of its op's earlier siblings, and
   (live) a RUNNING task already past that.
3. **Wave overlap**: per staged wave, staging time against the part
   the group thread waited for (exposed); ``hidden / staging`` is the
   pipeline's overlap efficiency (1.0 all hidden, 0.0 serial).

The device half, ``hub.device`` (``utils/devicetelemetry.py``), holds
kernel launches with their declared cost, builds, HBM watermarks and
donation. Surfaced as ``summary()``
(``Session.telemetry_summary()``), ``status_lines()`` (the status
display) and ``prometheus_text()``; each record also emits an instant
through the session's eventer and tracer, and lands in a bounded
flight recorder dumped on a fatal run when ``BIGSLICE_FLIGHTREC_DIR``
is set.

Every entry point is exception-safe (telemetry never takes an
evaluation down) and cheap: host arithmetic only, O(partitions) per
shuffle boundary, O(1) per task transition.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

from bigslice_tpu_torch.utils import faultinject

# Flagging thresholds. Deliberately conservative defaults: a production
# alert that fires on balanced workloads is worse than none. Tests (and
# operators) tune per-hub attributes directly.
DEFAULT_SKEW_RATIO = 4.0          # max/median per-shard rows
DEFAULT_SKEW_MIN_ROWS = 512       # don't flag toy shuffles
DEFAULT_STRAGGLER_FACTOR = 3.0    # task > k * p50(completed siblings)
DEFAULT_STRAGGLER_MIN_SIBLINGS = 3
DEFAULT_STRAGGLER_MIN_SECS = 0.05  # 3x of a 1ms task is noise

# Prometheus histogram buckets for per-shard shuffle sizes.
ROWS_BUCKETS = (100, 1_000, 10_000, 100_000, 1_000_000, 10_000_000)

# Retained per-op records. Iterative drivers mint fresh ``#N``-suffixed
# op names every invocation, so a week-long session would otherwise
# grow the hub without bound; oldest ops (insertion order) evict first,
# Prometheus-counter monotonicity be damned — an evicted op is one
# nobody scraped for hundreds of invocations.
MAX_OPS = 1024

# Bounds on the recovery ladder's bookkeeping: latency samples per site
# and simultaneously-pending lost tasks tracked (beyond it, recoveries
# still count — only the latency sample is dropped).
MAX_RECOVERY_SAMPLES = 4096
MAX_RECOVERY_PENDING = 4096

# Flight-recorder ring: the last N structured hub events, dumped as a
# flightrec-<inv>.json artifact on fatal error / drain timeout. Small
# on purpose: the recorder answers "what was the run doing right
# before it died", not "replay the whole session".
FLIGHT_MAX_EVENTS = 512


def quantile(sorted_xs: List[float], p: float) -> float:
    """Linear-interpolated quantile of an ascending list."""
    n = len(sorted_xs)
    if n == 0:
        return 0.0
    if n == 1:
        return sorted_xs[0]
    i = p * (n - 1)
    lo = int(i)
    hi = min(lo + 1, n - 1)
    return sorted_xs[lo] + (sorted_xs[hi] - sorted_xs[lo]) * (i - lo)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class _OpRecord:
    """Per-op accumulation (one instance per distinct op name; iterative
    drivers re-invoke under fresh ``#N``-suffixed names, so an op key is
    naturally per-invocation-site-per-run)."""

    def __init__(self, inv: Optional[int] = None):
        self.inv = inv
        # -- task durations / stragglers
        self.durations: List[float] = []      # completed (OK) tasks
        self.running: Dict[str, float] = {}   # task key -> start stamp
        self.shards: Dict[str, int] = {}      # task key -> shard index
        self.stragglers: List[dict] = []
        # -- shuffle sizes (elementwise-accumulated across producers)
        self.part_rows: List[int] = []
        self.part_bytes: List[int] = []
        self.shuffle_boundaries = 0
        self.worst_ratio = 0.0
        self.worst_max_shard = -1
        self.skew_flagged = False
        self.rows_hist = [0] * (len(ROWS_BUCKETS) + 1)
        self.rows_hist_sum = 0
        self.rows_hist_count = 0
        # -- wave pipeline accounting
        self.staging_s = 0.0
        self.exposed_s = 0.0
        self.compute_s = 0.0
        self.staged_waves = 0
        self.max_wave = -1
        self.phase_counts: Dict[str, int] = {}
        # staging breakdown: where staging time went (the why behind
        # overlap_efficiency): read, decode, assemble, upload.
        self.stage_phases: Dict[str, float] = {}
        # -- map-side combine cardinality (exec/local.py seam): rows
        # into the boundary's combiner and rows out (about the distinct
        # keys), summed over producer tasks. The post-combine shuffle
        # vector alone hides the true cardinality.
        self.combine_in_rows = 0
        self.combine_out_rows = 0
        self.combine_boundaries = 0


class DeadlineStats:
    """Deadline attribution (``Session.run(deadline_s=)``,
    ``exec/evaluate.DeadlineExceeded``): outcome counts per tenant (""
    for a session's own runs) and per source. Made by the hub's first
    ``record_deadline``, so a process without deadlines exports no
    sample."""

    MAX_TENANTS = 64

    def __init__(self):
        self._lock = threading.Lock()
        # (tenant, outcome) -> count; tenant "" = a session's own run.
        self._counts: Dict[Tuple[str, str], int] = {}
        self._sources: Dict[str, int] = {}

    def record(self, outcome: str, tenant: str = "",
               deadline_s=None, source: str = "") -> None:
        tenant = str(tenant or "")
        with self._lock:
            known = {t for t, _ in self._counts}
            if tenant not in known and len(known) >= self.MAX_TENANTS:
                tenant = "_overflow"
            k = (tenant, str(outcome))
            self._counts[k] = self._counts.get(k, 0) + 1
            if source:
                self._sources[source] = self._sources.get(source, 0) + 1

    def count(self, outcome: str, tenant: Optional[str] = None) -> int:
        with self._lock:
            return sum(
                n for (t, o), n in self._counts.items()
                if o == outcome and (tenant is None or t == tenant)
            )

    def summary(self) -> dict:
        with self._lock:
            by_tenant: Dict[str, Dict[str, int]] = {}
            for (t, o), n in sorted(self._counts.items()):
                by_tenant.setdefault(t or "_session", {})[o] = n
            return {
                "by_tenant": by_tenant,
                "by_source": dict(sorted(self._sources.items())),
            }

    def prometheus_lines(self, metric, line) -> None:
        with self._lock:
            counts = dict(self._counts)
        metric("bigslice_deadline_outcomes_total",
               "Deadline outcomes (met, expired) per tenant; tenant "
               "_session = Session.run(deadline_s=) calls.",
               "counter")
        for (t, o), n in sorted(counts.items()):
            line("bigslice_deadline_outcomes_total",
                 {"tenant": t or "_session", "outcome": o}, n)


class TelemetryHub:
    """The aggregation layer. Participates in the monitor chain (it is
    a ``(task, state)`` callable exposing ``on_phase``) and receives
    executor seam calls (``record_shuffle`` / ``record_wave_staging`` /
    ``record_wave_compute``)."""

    def __init__(self, eventer=None,
                 skew_ratio: float = DEFAULT_SKEW_RATIO,
                 skew_min_rows: int = DEFAULT_SKEW_MIN_ROWS,
                 straggler_factor: float = DEFAULT_STRAGGLER_FACTOR,
                 straggler_min_siblings: int =
                 DEFAULT_STRAGGLER_MIN_SIBLINGS,
                 straggler_min_secs: float = DEFAULT_STRAGGLER_MIN_SECS):
        self._lock = threading.Lock()
        self._ops: Dict[str, _OpRecord] = {}
        self._state_counts: Dict[tuple, int] = {}
        # Recovery ladder: LOST tasks pending recovery (task key ->
        # (first-loss stamp, site)), per-site recovered and fatal
        # counters, and recovery-latency samples per site. The site is
        # the chaos plane's injecting seam found in the loss's error
        # chain (utils/faultinject.py), else "organic".
        self._recovery_pending: Dict[str, Tuple[float, str]] = {}
        self._recovered: Dict[str, int] = {}
        self._recovery_fatal: Dict[str, int] = {}
        self._recovery_lat: Dict[str, List[float]] = {}
        # Drain-timeout census (exec/evaluate._drain's wedged report).
        self._drain_timeouts = 0
        self._drain_wedged: List[dict] = []
        self._eventer = eventer
        # Flight recorder: every event _emit sends (wave staging/
        # compute, shuffle sizes, compile, hbm, recovery...) also lands
        # in this bounded ring; dump_flight_record writes it out on
        # fatal error / drain timeout when a dump dir is configured.
        self._flight: collections.deque = collections.deque(
            maxlen=FLIGHT_MAX_EVENTS
        )
        # Own lock (never nests under executor/monitor paths): appends
        # happen on whatever thread emitted, and the dump snapshot must
        # not race them — a deque mutated mid-iteration raises, and the
        # dump's best-effort except would silently eat the one artifact
        # a live failure exists to leave behind.
        self._flight_lock = threading.Lock()
        self._flight_dumped: Dict[object, str] = {}
        # Device plane (utils/devicetelemetry.py): kernel launches and
        # their declared cost, builds, HBM watermarks, donation
        # effectiveness. Shares
        # this hub's eventer so its instants ride the same tracer lane
        # (and this flight ring).
        from bigslice_tpu_torch.utils import devicetelemetry

        self.device = devicetelemetry.DeviceTelemetry(
            eventer=self._emit
        )
        # The robustness plane's stats, attached by the Session when a
        # knob engages (exec/adaptive.py, exec/codedplan.py) or made by
        # the first record_deadline: None otherwise, and then neither
        # the summary nor Prometheus carries a sample of them.
        self.adaptive = None
        self.coded = None
        self.deadline = None
        self.skew_ratio = skew_ratio
        self.skew_min_rows = skew_min_rows
        self.straggler_factor = straggler_factor
        self.straggler_min_siblings = straggler_min_siblings
        self.straggler_min_secs = straggler_min_secs

    def _op(self, op: str, inv: Optional[int] = None) -> _OpRecord:
        rec = self._ops.get(op)
        if rec is None:
            while len(self._ops) >= MAX_OPS:
                evicted = next(iter(self._ops))
                del self._ops[evicted]
                for k in [k for k in self._state_counts
                          if k[0] == evicted]:
                    del self._state_counts[k]
            rec = self._ops[op] = _OpRecord(inv)
        if rec.inv is None:
            rec.inv = inv
        return rec

    def _emit(self, name: str, **fields) -> None:
        try:
            with self._flight_lock:
                self._flight.append(
                    (time.time(), name,
                     {k: v for k, v in fields.items()
                      if v is not None})
                )
        except Exception:
            pass
        ev = self._eventer
        if ev is None:
            return
        try:
            ev(name, **fields)
        except Exception:  # telemetry must never break the run
            pass

    # -- monitor protocol (chained by Session) ----------------------------

    def __call__(self, task, state) -> None:
        from bigslice_tpu_torch.exec.task import TaskState

        now = time.monotonic()
        key = str(task.name)
        straggler = None
        recovered = None
        with self._lock:
            sk = (task.name.op, state.name)
            self._state_counts[sk] = self._state_counts.get(sk, 0) + 1
            rec = self._op(task.name.op, task.name.inv_index)
            if state == TaskState.RUNNING:
                # Task.state_times is authoritative (stamped inside the
                # transition, before subscribers run); our own stamp is
                # the fallback for hand-rolled tasks in tests.
                times = getattr(task, "state_times", None) or {}
                rec.running[key] = times.get(TaskState.RUNNING, now)
                rec.shards[key] = task.name.shard
            elif state == TaskState.OK:
                pend = self._recovery_pending.pop(key, None)
                if pend is not None:
                    # LOST → ... → OK: the ladder recovered this task.
                    t_lost, site = pend
                    times = getattr(task, "state_times", None) or {}
                    lat = max(0.0, times.get(TaskState.OK, now) - t_lost)
                    self._recovered[site] = \
                        self._recovered.get(site, 0) + 1
                    lats = self._recovery_lat.setdefault(site, [])
                    if len(lats) < MAX_RECOVERY_SAMPLES:
                        lats.append(lat)
                    recovered = {"site": site,
                                 "latency_s": round(lat, 6)}
                start = rec.running.pop(key, None)
                if start is not None:
                    # End stamp from state_times too: the hub may be
                    # called after slower chain members, and that
                    # monitor latency must not inflate durations (or
                    # mint false stragglers on fast ops).
                    times = getattr(task, "state_times", None) or {}
                    dur = max(0.0, times.get(TaskState.OK, now) - start)
                    siblings = sorted(rec.durations)
                    rec.durations.append(dur)
                    if (len(siblings) >= self.straggler_min_siblings
                            and dur >= self.straggler_min_secs):
                        p50 = quantile(siblings, 0.5)
                        if dur > self.straggler_factor * p50:
                            straggler = {
                                "task": key,
                                "shard": rec.shards.get(key, -1),
                                "duration_s": round(dur, 6),
                                "p50_s": round(p50, 6),
                            }
                            rec.stragglers.append(straggler)
            elif state == TaskState.LOST:
                rec.running.pop(key, None)
                if (key not in self._recovery_pending
                        and len(self._recovery_pending)
                        < MAX_RECOVERY_PENDING):
                    # First loss opens the recovery window (repeat
                    # losses keep the original stamp: time-to-recovery
                    # measures loss → healthy, retries included).
                    # (Reference utils/telemetry.py:405.)
                    site = faultinject.fault_site_of(
                        getattr(task, "error", None)) or "organic"
                    times = getattr(task, "state_times", None) or {}
                    self._recovery_pending[key] = (
                        times.get(TaskState.LOST, now), site,
                    )
            elif state == TaskState.CANCELLED:
                # A cooperative stop: no duration sample, and the task
                # leaves the running ledger (live_stragglers).
                rec.running.pop(key, None)
            elif state == TaskState.ERR:
                rec.running.pop(key, None)
                pend = self._recovery_pending.pop(key, None)
                if pend is not None:
                    # The ladder gave up (consecutive-loss cap / fatal
                    # reclassification): a non-recovery, by site.
                    self._recovery_fatal[pend[1]] = \
                        self._recovery_fatal.get(pend[1], 0) + 1
        if recovered is not None:
            self._emit("bigslice:taskRecovered", op=task.name.op,
                       inv=task.name.inv_index, task=key, **recovered)
        if straggler is not None:
            self._emit("bigslice:straggler", op=task.name.op,
                       inv=task.name.inv_index, **straggler)

    def on_phase(self, task, phase: str, wave: int) -> None:
        with self._lock:
            rec = self._op(task.name.op, task.name.inv_index)
            rec.phase_counts[phase] = rec.phase_counts.get(phase, 0) + 1
            rec.max_wave = max(rec.max_wave, int(wave))

    def on_drain_timeout(self, wedged: List[dict]) -> None:
        """exec/evaluate._drain's expiry census: which tasks were still
        in flight when an aborted evaluation gave up waiting."""
        with self._lock:
            self._drain_timeouts += 1
            self._drain_wedged = list(wedged)[:64]
        self._emit("bigslice:drainTimeout", n=len(wedged),
                   tasks=[w["task"] for w in wedged[:8]])
        # The drain census IS the wedge evidence a post-mortem needs:
        # dump the flight ring next to it (no-op unless a dump dir is
        # configured — see dump_flight_record).
        self.dump_flight_record(reason="drain_timeout")

    # -- flight recorder --------------------------------------------------

    @staticmethod
    def flightrec_dir(out_dir: Optional[str] = None) -> Optional[str]:
        """Where flight-recorder dumps go: explicit arg, else the
        ``BIGSLICE_FLIGHTREC_DIR`` env var, else None (dumping is
        opt-in: a failing unit test must not litter /tmp)."""
        import os

        return out_dir or os.environ.get("BIGSLICE_FLIGHTREC_DIR") \
            or None

    def dump_flight_record(self, inv: Optional[int] = None,
                           reason: str = "",
                           out_dir: Optional[str] = None
                           ) -> Optional[str]:
        """Write the event ring (filtered to ``inv`` when given — events
        with no inv tag ride along) plus the task-state census to
        ``flightrec-<inv>.json``. Best-effort and
        deduped per inv — matching the one-file-per-inv naming, so a
        later outcome for the same invocation can never silently
        overwrite the first dump (whose ring, closest to the original
        failure, is the evidence a post-mortem wants). Returns the
        path, or None when no dump dir is configured or writing
        failed."""
        dirname = self.flightrec_dir(out_dir)
        if dirname is None:
            return None
        key = inv
        try:
            with self._lock:
                if key in self._flight_dumped:
                    return self._flight_dumped[key]
            doc = self.flight_doc(inv=inv, reason=reason)
            import json
            import os

            os.makedirs(dirname, exist_ok=True)
            stem = f"flightrec-{inv if inv is not None else 'session'}"
            path = os.path.join(dirname, stem + ".json")
            with open(path, "w") as fp:
                json.dump(doc, fp, indent=1, default=str)
            with self._lock:
                self._flight_dumped[key] = path
            return path
        except Exception:  # telemetry must never break the run
            return None

    def flight_doc(self, inv: Optional[int] = None,
                   reason: str = "") -> dict:
        """The flight-recorder document (the event ring filtered to
        ``inv`` when given, and the task-state census) that
        ``dump_flight_record`` writes."""
        with self._flight_lock:
            ring = list(self._flight)
        with self._lock:
            events = [
                {"ts": ts, "name": name, **fields}
                for ts, name, fields in ring
                if inv is None or fields.get("inv") in (None, inv)
            ]
            states: Dict[str, int] = {}
            for (_, st), n in self._state_counts.items():
                states[st] = states.get(st, 0) + n
        doc = {
            "inv": inv,
            "reason": reason,
            "ts": time.time(),
            "task_states": states,
            "events": events,
        }
        plan = faultinject.active_plan()
        if plan is not None:
            doc["chaos"] = plan.snapshot()
        return doc

    def record_deadline(self, outcome: str, tenant: str = "",
                        deadline_s=None, source: str = "") -> None:
        """One deadline outcome (met, expired): the deadline plane is
        made here, at the first (reference utils/telemetry.py:651)."""
        with self._lock:
            if self.deadline is None:
                self.deadline = DeadlineStats()
        self.deadline.record(outcome, tenant=tenant, deadline_s=deadline_s,
                             source=source)
        self._emit("bigslice:deadline", outcome=outcome,
                   tenant=tenant or None, deadline_s=deadline_s,
                   source=source or None)

    # -- executor seams ---------------------------------------------------

    def record_shuffle(self, op: str, inv: Optional[int],
                       rows, nbytes=None) -> None:
        """One producer's (or one whole group's) per-partition sizes at
        a shuffle boundary. Contributions accumulate elementwise per op,
        so per-producer local-tier calls and whole-group device calls
        land in the same per-op partition-size vector."""
        rows = [max(0, int(r)) for r in rows]
        if not rows:
            return
        if nbytes is None:
            nbytes = [0] * len(rows)
        nbytes = [max(0, int(b)) for b in nbytes][:len(rows)]
        top = len(rows)
        with self._lock:
            rec = self._op(op, inv)
            if len(rec.part_rows) < top:
                rec.part_rows.extend(
                    [0] * (top - len(rec.part_rows)))
                rec.part_bytes.extend(
                    [0] * (top - len(rec.part_bytes)))
            for i, r in enumerate(rows):
                rec.part_rows[i] += r
            for i, b in enumerate(nbytes):
                rec.part_bytes[i] += b
            rec.shuffle_boundaries += 1
            for r in rows:  # the histogram observes per-partition sizes
                for bi, le in enumerate(ROWS_BUCKETS):
                    if r <= le:
                        rec.rows_hist[bi] += 1
                        break
                else:
                    rec.rows_hist[-1] += 1
                rec.rows_hist_sum += r
                rec.rows_hist_count += 1
            ratio, max_shard, median, total = self._skew_of(
                rec.part_rows
            )
            max_rows = rec.part_rows[max_shard]
            if ratio > rec.worst_ratio:
                rec.worst_ratio = ratio
                rec.worst_max_shard = max_shard
            flagged = (total >= self.skew_min_rows
                       and ratio >= self.skew_ratio)
            rec.skew_flagged = rec.skew_flagged or flagged
        # The accumulated vector's values (this call's contribution
        # folded in), so the last event of an op reads its final state.
        self._emit(
            "bigslice:shuffleSizes", op=op, inv=inv,
            rows=rows if len(rows) <= 64 else None,
            total_rows=total, max_rows=max_rows, median_rows=median,
            ratio=round(ratio, 3), max_shard=max_shard,
            flagged=flagged,
        )

    @staticmethod
    def _skew_of(rows: List[int]):
        total = sum(rows)
        mx = max(rows)
        max_shard = rows.index(mx)
        median = quantile(sorted(float(r) for r in rows), 0.5)
        ratio = mx / max(median, 1.0)
        return ratio, max_shard, median, total

    def record_combine_input(self, op: str, inv: Optional[int],
                             in_rows: int, out_rows: int) -> None:
        """One producer task's map-side combine cardinality: rows INTO
        the boundary's combiner and rows out (~distinct keys for the
        full boundary once every producer reports). The executor calls
        this per combine-bearing task (exec/local.py); post-combine
        shuffle sizes alone understate cardinality by exactly the
        combine's collapse factor."""
        in_rows = max(0, int(in_rows))
        out_rows = max(0, int(out_rows))
        with self._lock:
            rec = self._op(op, inv)
            rec.combine_in_rows += in_rows
            rec.combine_out_rows += out_rows
            rec.combine_boundaries += 1
        self._emit("bigslice:combineInput", op=op, inv=inv,
                   in_rows=in_rows, out_rows=out_rows)

    # The staging-breakdown phases an executor may report (the staging
    # fast path's read → decode → assemble → upload chain); unknown
    # keys are dropped so a buggy caller can't grow the record.
    STAGE_PHASES = ("read_s", "decode_s", "assemble_s", "upload_s")

    def record_wave_staging(self, op: str, inv: Optional[int],
                            wave: int, dur_s: float,
                            exposed_s: float,
                            breakdown: Optional[dict] = None) -> None:
        """One wave's input staging: total duration, the portion the
        compute thread actually blocked on (== dur_s on the serial
        path; the wait in ``staged.get()`` on the pipelined path), and
        optionally the read/decode/assemble/upload breakdown of where
        the staging time went."""
        dur_s = max(0.0, float(dur_s))
        exposed_s = min(max(0.0, float(exposed_s)), dur_s)
        clean: Dict[str, float] = {}
        if breakdown:
            for k in self.STAGE_PHASES:
                v = breakdown.get(k)
                if v:
                    clean[k] = max(0.0, float(v))
        with self._lock:
            rec = self._op(op, inv)
            rec.staging_s += dur_s
            rec.exposed_s += exposed_s
            rec.staged_waves += 1
            rec.max_wave = max(rec.max_wave, int(wave))
            for k, v in clean.items():
                rec.stage_phases[k] = rec.stage_phases.get(k, 0.0) + v
        self._emit("bigslice:waveStaging", op=op, inv=inv, wave=wave,
                   ms=round(dur_s * 1e3, 3),
                   exposed_ms=round(exposed_s * 1e3, 3),
                   **{k[:-2] + "_ms": round(v * 1e3, 3)
                      for k, v in clean.items()})

    def record_wave_compute(self, op: str, inv: Optional[int],
                            wave: int, dur_s: float) -> None:
        dur_s = max(0.0, float(dur_s))
        with self._lock:
            rec = self._op(op, inv)
            rec.compute_s += dur_s
            rec.max_wave = max(rec.max_wave, int(wave))
        self._emit("bigslice:waveRun", op=op, inv=inv, wave=wave,
                   ms=round(dur_s * 1e3, 3))

    # -- queries ----------------------------------------------------------

    def skew_of_op(self, op: str) -> Optional[dict]:
        """One op's current shuffle-skew verdict: ratio, hot
        partition, totals and the flag, from the accumulated
        per-partition row vector. None before the op's first shuffle
        boundary."""
        with self._lock:
            rec = self._ops.get(op)
            if rec is None or not rec.part_rows:
                return None
            ratio, max_shard, median, total = self._skew_of(
                rec.part_rows
            )
            out = {
                "ratio": ratio,
                "max_shard": max_shard,
                "median_rows": median,
                "total_rows": total,
                "max_rows": rec.part_rows[max_shard],
                "flagged": (total >= self.skew_min_rows
                            and ratio >= self.skew_ratio),
            }
            if rec.combine_boundaries:
                # True pre-combine cardinality at the op's map-side
                # combine boundary (record_combine_input): input rows
                # and the distinct-key ratio (rows out / rows in; 1.0
                # = all-distinct, small = heavy collapse).
                out["combine_input_rows"] = rec.combine_in_rows
                out["distinct_key_ratio"] = (
                    rec.combine_out_rows
                    / max(1, rec.combine_in_rows)
                )
            return out

    def live_stragglers(self) -> List[dict]:
        """RUNNING tasks whose elapsed time already exceeds the
        straggler threshold of their op's completed siblings."""
        now = time.monotonic()
        out = []
        with self._lock:
            for op, rec in self._ops.items():
                if len(rec.durations) < self.straggler_min_siblings:
                    continue
                p50 = quantile(sorted(rec.durations), 0.5)
                floor = max(self.straggler_factor * p50,
                            self.straggler_min_secs)
                for key, start in rec.running.items():
                    elapsed = now - start
                    if elapsed > floor:
                        out.append({
                            "op": op, "task": key,
                            "shard": rec.shards.get(key, -1),
                            "elapsed_s": round(elapsed, 3),
                            "p50_s": round(p50, 6),
                        })
        out.sort(key=lambda d: -d["elapsed_s"])
        return out

    def summary(self) -> dict:
        """The ``Session.telemetry_summary()`` payload: per-op skew /
        straggler / wave sections plus session-wide rollups."""
        with self._lock:
            ops = {}
            total_staging = total_hidden = 0.0
            flagged_ops = []
            straggler_total = 0
            for op, rec in self._ops.items():
                entry: dict = {"inv": rec.inv}
                if rec.durations:
                    ds = sorted(rec.durations)
                    entry["tasks"] = {
                        "n": len(ds),
                        "p50_s": round(quantile(ds, 0.5), 6),
                        "p90_s": round(quantile(ds, 0.9), 6),
                        "max_s": round(ds[-1], 6),
                        "total_s": round(sum(ds), 6),
                    }
                if rec.stragglers:
                    entry["stragglers"] = list(rec.stragglers)
                    straggler_total += len(rec.stragglers)
                if rec.part_rows:
                    ratio, max_shard, median, total = self._skew_of(
                        rec.part_rows
                    )
                    flagged = (total >= self.skew_min_rows
                               and ratio >= self.skew_ratio)
                    nonempty = sorted(
                        float(r) for r in rec.part_rows if r > 0
                    )
                    entry["skew"] = {
                        "rows": list(rec.part_rows),
                        "bytes": list(rec.part_bytes),
                        "total_rows": total,
                        "median_rows": median,
                        "ratio": round(ratio, 3),
                        "max_shard": max_shard,
                        "flagged": flagged,
                        "boundaries": rec.shuffle_boundaries,
                        # The per-partition row distribution.
                        "per_shard": {
                            "n": len(rec.part_rows),
                            "nonempty": len(nonempty),
                            "p50_rows": round(
                                quantile(nonempty, 0.5), 1
                            ) if nonempty else 0.0,
                            "p90_rows": round(
                                quantile(nonempty, 0.9), 1
                            ) if nonempty else 0.0,
                            "max_rows": int(max(rec.part_rows)),
                            "mean_rows": round(
                                total / max(1, len(rec.part_rows)), 1
                            ),
                        },
                    }
                    if flagged:
                        flagged_ops.append(op)
                if rec.staged_waves or rec.max_wave >= 0:
                    hidden = max(0.0, rec.staging_s - rec.exposed_s)
                    eff = (hidden / rec.staging_s
                           if rec.staging_s > 0 else 0.0)
                    entry["waves"] = {
                        "n_waves": rec.max_wave + 1,
                        "staged": rec.staged_waves,
                        "staging_s": round(rec.staging_s, 6),
                        "exposed_s": round(rec.exposed_s, 6),
                        "hidden_s": round(hidden, 6),
                        "compute_s": round(rec.compute_s, 6),
                        "overlap_efficiency": round(eff, 4),
                        "phases": dict(rec.phase_counts),
                    }
                    if rec.stage_phases:
                        entry["waves"]["staging_breakdown"] = {
                            k: round(v, 6)
                            for k, v in rec.stage_phases.items()
                        }
                    total_staging += rec.staging_s
                    total_hidden += hidden
                ops[op] = entry
            states: Dict[str, int] = {}
            for (_, st), n in self._state_counts.items():
                states[st] = states.get(st, 0) + n
            out = {
                "ops": ops,
                "task_states": states,
                "skew_flagged_ops": sorted(flagged_ops),
                "straggler_total": straggler_total,
                "overlap_efficiency": round(
                    total_hidden / total_staging, 4
                ) if total_staging > 0 else None,
            }
            recovery = self._recovery_summary_locked()
            if recovery is not None:
                out["recovery"] = recovery
            if self._drain_timeouts:
                out["drain"] = {
                    "timeouts": self._drain_timeouts,
                    "wedged": list(self._drain_wedged),
                }
        plan = faultinject.active_plan()
        if plan is not None:
            snap = plan.snapshot()
            out["chaos"] = {
                "seed": snap["seed"],
                "spec": snap["spec"],
                "injected": snap["injected"],
                "by_kind": snap["by_kind"],
            }
        # Device plane: kernel launches and builds, HBM watermarks, donation
        # effectiveness (utils/devicetelemetry.py). Always present so
        # consumers need no existence dance; empty sub-dicts mean "no
        # device work observed".
        try:
            out["device"] = self.device.summary()
        except Exception:
            out["device"] = {}
        # The JAX package's program cache: not applicable, the port
        # compiles no wave program.
        out["program_cache"] = None
        # The file-backed result cache (ops/cache.py): process-scope
        # hit and miss counts.
        try:
            from bigslice_tpu_torch.ops.cache import result_cache_counts

            out["result_cache"] = result_cache_counts()
        except Exception:
            out["result_cache"] = {}
        # The robustness plane (reference utils/telemetry.py:930-953):
        # only what is attached.
        for name in ("adaptive", "coded", "deadline"):
            stats = getattr(self, name)
            if stats is not None:
                try:
                    out[name] = stats.summary()
                except Exception:
                    out[name] = {}
        return out

    @staticmethod
    def _lat_stats(lats: List[float]) -> dict:
        ls = sorted(lats)
        return {
            "n": len(ls),
            "p50_s": round(quantile(ls, 0.5), 6),
            "p90_s": round(quantile(ls, 0.9), 6),
            "max_s": round(ls[-1], 6) if ls else 0.0,
        }

    def _recovery_summary_locked(self) -> Optional[dict]:
        if not (self._recovered or self._recovery_fatal
                or self._recovery_pending):
            return None
        by_site = {}
        for site in sorted(set(self._recovered)
                           | set(self._recovery_fatal)):
            entry = {
                "recovered": self._recovered.get(site, 0),
                "fatal": self._recovery_fatal.get(site, 0),
            }
            lats = self._recovery_lat.get(site)
            if lats:
                entry["latency"] = self._lat_stats(lats)
            by_site[site] = entry
        all_lats = [v for ls in self._recovery_lat.values()
                    for v in ls]
        out = {
            "recovered_total": sum(self._recovered.values()),
            "fatal_total": sum(self._recovery_fatal.values()),
            "pending": len(self._recovery_pending),
            "by_site": by_site,
        }
        if all_lats:
            out["latency"] = self._lat_stats(all_lats)
        return out

    def status_lines(self, limit: int = 4) -> List[str]:
        """Live annotations for the status display: flagged skew and
        current/flagged stragglers, worst first, bounded — plus a
        recovery-ladder line when losses were seen."""
        lines: List[str] = []
        with self._lock:
            rec_total = sum(self._recovered.values())
            fatal_total = sum(self._recovery_fatal.values())
            pending = len(self._recovery_pending)
            if rec_total or fatal_total or pending:
                lines.append(
                    f"  recovery: {rec_total} recovered, "
                    f"{fatal_total} fatal, {pending} pending"
                )
            skews = []
            for op, rec in self._ops.items():
                if rec.skew_flagged:
                    skews.append((rec.worst_ratio, op,
                                  rec.worst_max_shard))
            for ratio, op, shard in sorted(skews, reverse=True)[:limit]:
                lines.append(
                    f"  skew {op}: ratio {ratio:.1f} (hot shard {shard})"
                )
            flagged = [
                (s["duration_s"], s["task"], s["p50_s"])
                for rec in self._ops.values() for s in rec.stragglers
            ]
        for dur, task, p50 in sorted(flagged, reverse=True)[:limit]:
            lines.append(
                f"  straggler {task}: {dur:.2f}s vs p50 {p50:.2f}s"
            )
        for s in self.live_stragglers()[:limit]:
            lines.append(
                f"  straggler (live) {s['task']}: {s['elapsed_s']:.2f}s"
                f" vs p50 {s['p50_s']:.2f}s"
            )
        try:
            hbm = self.device.status_line()
            if hbm:
                lines.append(hbm)
        except Exception:
            pass
        return lines

    # -- Prometheus export ------------------------------------------------

    def prometheus_text(self) -> str:
        """The hub's signals in Prometheus text exposition format
        (text/plain; version=0.0.4) — counters, gauges, a per-op task
        duration summary, and a per-op shuffle-size histogram — plus
        the framework's internal stats.Map counters and host RSS."""
        from bigslice_tpu_torch.utils import resources as resources_mod
        from bigslice_tpu_torch.utils import stats as stats_mod

        out: List[str] = []

        def metric(name, help_, type_):
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {type_}")

        def line(name, labels, value):
            if labels:
                lab = ",".join(
                    f'{k}="{_escape_label(v)}"'
                    for k, v in labels.items()
                )
                out.append(f"{name}{{{lab}}} {value}")
            else:
                out.append(f"{name} {value}")

        with self._lock:
            states = sorted(self._state_counts.items())
            ops = {op: rec for op, rec in self._ops.items()}

            metric("bigslice_task_state_total",
                   "Task state transitions observed, by op and state.",
                   "counter")
            for (op, st), n in states:
                line("bigslice_task_state_total",
                     {"op": op, "state": st}, n)

            metric("bigslice_task_duration_seconds",
                   "Completed task durations per op.", "summary")
            for op, rec in ops.items():
                if not rec.durations:
                    continue
                ds = sorted(rec.durations)
                for q in (0.5, 0.9, 0.99):
                    line("bigslice_task_duration_seconds",
                         {"op": op, "quantile": str(q)},
                         f"{quantile(ds, q):.6f}")
                line("bigslice_task_duration_seconds_sum", {"op": op},
                     f"{sum(ds):.6f}")
                line("bigslice_task_duration_seconds_count", {"op": op},
                     len(ds))

            metric("bigslice_op_straggler_total",
                   "Tasks flagged as stragglers "
                   "(duration > factor * sibling p50).", "counter")
            for op, rec in ops.items():
                if rec.stragglers:
                    line("bigslice_op_straggler_total", {"op": op},
                         len(rec.stragglers))

            metric("bigslice_op_skew_ratio",
                   "Worst max/median per-shard row ratio observed at "
                   "this op's shuffle boundary.", "gauge")
            for op, rec in ops.items():
                if rec.part_rows:
                    line("bigslice_op_skew_ratio", {"op": op},
                         f"{rec.worst_ratio:.4f}")
            metric("bigslice_op_skew_flagged",
                   "1 when the op's shuffle skew exceeded the flag "
                   "threshold.", "gauge")
            for op, rec in ops.items():
                if rec.part_rows:
                    line("bigslice_op_skew_flagged", {"op": op},
                         int(rec.skew_flagged))

            metric("bigslice_shuffle_partition_rows",
                   "Per-shard row counts observed at shuffle "
                   "boundaries.", "histogram")
            for op, rec in ops.items():
                if rec.rows_hist_count == 0:
                    continue
                cum = 0
                for bi, le in enumerate(ROWS_BUCKETS):
                    cum += rec.rows_hist[bi]
                    line("bigslice_shuffle_partition_rows_bucket",
                         {"op": op, "le": str(le)}, cum)
                cum += rec.rows_hist[-1]
                line("bigslice_shuffle_partition_rows_bucket",
                     {"op": op, "le": "+Inf"}, cum)
                line("bigslice_shuffle_partition_rows_sum", {"op": op},
                     rec.rows_hist_sum)
                line("bigslice_shuffle_partition_rows_count",
                     {"op": op}, rec.rows_hist_count)

            metric("bigslice_wave_overlap_efficiency",
                   "Fraction of wave staging time hidden behind "
                   "compute by the prefetch pipeline (1.0 = fully "
                   "hidden, 0.0 = serial).", "gauge")
            for op, rec in ops.items():
                if rec.staged_waves:
                    hidden = max(0.0, rec.staging_s - rec.exposed_s)
                    eff = (hidden / rec.staging_s
                           if rec.staging_s > 0 else 0.0)
                    line("bigslice_wave_overlap_efficiency", {"op": op},
                         f"{eff:.4f}")

            metric("bigslice_wave_staging_seconds_total",
                   "Cumulative wave input staging time, split into "
                   "compute-exposed and prefetch-hidden.", "counter")
            for op, rec in ops.items():
                if rec.staged_waves:
                    line("bigslice_wave_staging_seconds_total",
                         {"op": op, "kind": "exposed"},
                         f"{rec.exposed_s:.6f}")
                    line("bigslice_wave_staging_seconds_total",
                         {"op": op, "kind": "hidden"},
                         f"{max(0.0, rec.staging_s - rec.exposed_s):.6f}")

            metric("bigslice_wave_staging_phase_seconds_total",
                   "Cumulative wave staging time by phase "
                   "(read/decode/assemble/upload — why staging is "
                   "slow).", "counter")
            for op, rec in ops.items():
                for ph, v in sorted(rec.stage_phases.items()):
                    line("bigslice_wave_staging_phase_seconds_total",
                         {"op": op, "phase": ph[:-2]}, f"{v:.6f}")

            metric("bigslice_wave_compute_seconds_total",
                   "Cumulative wave compute (dispatch to settle) time.",
                   "counter")
            for op, rec in ops.items():
                if rec.compute_s > 0:
                    line("bigslice_wave_compute_seconds_total",
                         {"op": op}, f"{rec.compute_s:.6f}")

            metric("bigslice_wave_phase_total",
                   "Wave pipeline phase events per op "
                   "(wavePrefetch/waveCompute).", "counter")
            for op, rec in ops.items():
                for phase, n in sorted(rec.phase_counts.items()):
                    line("bigslice_wave_phase_total",
                         {"op": op, "phase": phase}, n)

            # -- recovery ladder ----------------------------------------
            metric("bigslice_task_recovered_total",
                   "Lost tasks the recovery ladder brought back to OK, "
                   "by attributed fault site ('organic' = no chaos "
                   "marker in the loss's error chain).", "counter")
            for site, n in sorted(self._recovered.items()):
                line("bigslice_task_recovered_total", {"site": site}, n)
            metric("bigslice_task_recovery_fatal_total",
                   "Lost tasks that turned fatal (ERR) instead of "
                   "recovering, by attributed fault site.", "counter")
            for site, n in sorted(self._recovery_fatal.items()):
                line("bigslice_task_recovery_fatal_total",
                     {"site": site}, n)
            all_lats = sorted(
                v for ls in self._recovery_lat.values() for v in ls
            )
            if all_lats:
                metric("bigslice_task_recovery_seconds",
                       "Time from first loss to recovered-OK per task.",
                       "summary")
                for q in (0.5, 0.9, 0.99):
                    line("bigslice_task_recovery_seconds",
                         {"quantile": str(q)},
                         f"{quantile(all_lats, q):.6f}")
                line("bigslice_task_recovery_seconds_sum", {},
                     f"{sum(all_lats):.6f}")
                line("bigslice_task_recovery_seconds_count", {},
                     len(all_lats))
            metric("bigslice_drain_timeout_total",
                   "Aborted-evaluation drains that expired with tasks "
                   "still in flight.", "counter")
            line("bigslice_drain_timeout_total", {},
                 self._drain_timeouts)

        # -- device plane (kernel / HBM / donation gauges) ------------
        try:
            self.device.prometheus_lines(metric, line)
        except Exception:
            pass

        # -- cross-request result cache (ops/cache.py) ----------------
        try:
            from bigslice_tpu_torch.ops.cache import result_cache_counts

            rc = result_cache_counts()
            metric("bigslice_result_cache_total",
                   "Per-shard result-cache reads by outcome (hit = "
                   "served from cache, miss = computed + written "
                   "through; ops/cache.py).", "counter")
            for outcome, n in sorted(rc.items()):
                line("bigslice_result_cache_total",
                     {"outcome": outcome}, n)
        except Exception:
            pass

        # -- the robustness plane (exec/adaptive.py, exec/codedplan.py,
        # the deadline ladder, utils/faultinject.py) -------------------
        for stats in (self.adaptive, self.coded, self.deadline):
            if stats is not None:
                try:
                    stats.prometheus_lines(metric, line)
                except Exception:
                    pass
        plan = faultinject.active_plan()
        if plan is not None:
            snap = plan.snapshot()
            metric("bigslice_fault_injected_total",
                   "Chaos-plane injected faults by site and kind "
                   "(utils/faultinject.py).", "counter")
            for site in sorted(snap["by_kind"]):
                for kind, n in sorted(snap["by_kind"][site].items()):
                    line("bigslice_fault_injected_total",
                         {"site": site, "kind": kind}, n)

        metric("bigslice_stat_total",
               "Framework-internal stats.Map counters.", "counter")
        for name, v in sorted(stats_mod.DEFAULT.snapshot().items()):
            line("bigslice_stat_total", {"name": name}, v)

        rss = resources_mod.host_rss_bytes()
        if rss is not None:
            metric("bigslice_host_rss_bytes",
                   "Driver process resident set size.", "gauge")
            line("bigslice_host_rss_bytes", {}, rss)
        out.append("")
        return "\n".join(out)
