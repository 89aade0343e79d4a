"""Adaptive execution: the telemetry → action loop.

An ``AdaptivePlanner`` that the device executor and the evaluator
consult at wave boundaries, with three policies on measured signals
behind one knob, ``BIGSLICE_ADAPTIVE`` (the JAX package's names and
defaults): unset (or ``off``) builds no planner, so no adaptive code
path runs and no ``bigslice_adaptive_*`` sample is exported; ``skew``,
``spec`` and ``cost`` engage one policy each, comma or plus combos and
``all`` compose them. Unknown tokens fail loudly.

- **skew** — hot-shard splitting: when the hub's shuffle-size vector
  flags a consumer's producer op (ratio ≥ skew_ratio over ≥
  skew_min_rows rows), the consumer wave runs as K row slices through
  the budget split's substrate (``MeshExecutor._execute_wave_sliced``),
  whose merge equals the unsplit wave. K is the measured ratio rounded
  down to a power of two dividing the wave capacity, at most
  ``BIGSLICE_ADAPTIVE_MAX_SPLIT``.
- **spec** — speculative stragglers: a watcher thread polls the hub's
  ``live_stragglers()`` and races a duplicate of a flagged task on a
  free host-tier permit (``_Limiter.try_acquire``). The first to finish
  wins by the task's atomic RUNNING → OK transition; the duplicate's
  store puts are idempotent (deterministic tasks write the same bytes).
  Exclusive, machine-combined and coded tasks are never speculated.
- **cost** — cost-driven shaping: with no ``device_budget_bytes``, the
  wave split and prefetch budget is the measured ``hbm_budget()`` ×
  ``BIGSLICE_ADAPTIVE_HEADROOM``.

Every decision lands in ``telemetry_summary()["adaptive"]``, the
``bigslice_adaptive_*`` Prometheus families and ``bigslice:adaptive``
trace instants.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, FrozenSet, List, Optional, Tuple

#: The individual policies BIGSLICE_ADAPTIVE composes; ``all`` = all
#: three. Order here is the canonical display order.
POLICIES = ("skew", "spec", "cost")

#: Straggler-watch poll interval (seconds). Coarse enough to be free,
#: fine enough that a straggler 3× beyond its siblings' p50 is caught
#: within a small fraction of the excess.
DEFAULT_POLL_S = 0.02

#: Fraction of the measured HBM limit the cost policy budgets one wave
#: working set at (the rest is program scratch, merged outputs, and
#: the estimate's own error bars).
DEFAULT_HEADROOM = 0.5

#: Upper bound on the skew policy's split factor: splitting is a
#: latency lever, not a partitioner — past a point the per-slice
#: dispatch overhead dominates.
DEFAULT_MAX_SPLIT = 8

#: Bounded decision log (newest kept): enough for a post-mortem, never
#: a leak on long-running serving sessions.
MAX_DECISIONS = 256


def policies_from_env(env: Optional[str] = None) -> FrozenSet[str]:
    """Parse ``BIGSLICE_ADAPTIVE`` (or an explicit value) into the
    engaged policy set. Unset/empty/``off`` = frozenset() — fully
    disengaged. Unknown tokens fail loudly: a typo'd knob silently
    running the static executor would defeat every A/B it exists
    for."""
    if env is None:
        env = os.environ.get("BIGSLICE_ADAPTIVE", "")
    env = env.strip().lower()
    if not env or env == "off":
        return frozenset()
    out = set()
    for tok in env.replace("+", ",").split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok == "all":
            out.update(POLICIES)
        elif tok in POLICIES:
            out.add(tok)
        else:
            raise ValueError(
                f"BIGSLICE_ADAPTIVE must be off|skew|spec|cost|all "
                f"(comma/plus combos), got {tok!r}"
            )
    return frozenset(out)


def planner_from_env(hub=None) -> Optional["AdaptivePlanner"]:
    """The session-construction entry point: an ``AdaptivePlanner``
    when ``BIGSLICE_ADAPTIVE`` engages at least one policy, else None
    (the chicken bit: callers hold ``planner is None`` and run the
    legacy path untouched)."""
    policies = policies_from_env()
    if not policies:
        return None
    return AdaptivePlanner(hub, policies)


class AdaptiveStats:
    """Decision attribution for the adaptive loop: the telemetry hub
    calls through to
    ``summary()`` / ``prometheus_lines()`` only when a planner is
    attached, which is what guarantees zero ``bigslice_adaptive_*``
    samples with the knob unset."""

    def __init__(self, policies, eventer=None):
        self._lock = threading.Lock()
        self.policies: Tuple[str, ...] = tuple(
            p for p in POLICIES if p in set(policies)
        )
        self._eventer = eventer
        # (policy, action) -> count. Actions are the decision verbs:
        # skew/split, spec/launched|won|wasted, cost/wave_budget|
        # wave_split|prefetch_clip|admit|shed.
        self._counts: Dict[Tuple[str, str], int] = {}
        self.decisions: List[dict] = []
        self._t0 = time.monotonic()

    def record(self, policy: str, action: str, **detail) -> None:
        """One decision: count it, log it (bounded), and emit a
        ``bigslice:adaptive`` instant so the tracer/slicetrace see the
        loop act in wave context. Never raises — adaptation must not
        be able to fail a run through its own bookkeeping."""
        entry = {
            "policy": policy, "action": action,
            "t_s": round(time.monotonic() - self._t0, 6),
        }
        entry.update({k: v for k, v in detail.items() if v is not None})
        with self._lock:
            key = (policy, action)
            self._counts[key] = self._counts.get(key, 0) + 1
            self.decisions.append(entry)
            if len(self.decisions) > MAX_DECISIONS:
                del self.decisions[: len(self.decisions) - MAX_DECISIONS]
        ev = self._eventer
        if ev is not None:
            try:
                ev("bigslice:adaptive", policy=policy, action=action,
                   **{k: v for k, v in detail.items() if v is not None})
            except Exception:
                pass

    def count(self, policy: str, action: str) -> int:
        with self._lock:
            return self._counts.get((policy, action), 0)

    @property
    def skew_splits(self) -> int:
        return self.count("skew", "split")

    @property
    def speculative_launched(self) -> int:
        return self.count("spec", "launched")

    @property
    def speculative_won(self) -> int:
        return self.count("spec", "won")

    @property
    def speculative_wasted(self) -> int:
        return self.count("spec", "wasted")

    def summary(self) -> dict:
        """The ``telemetry_summary()["adaptive"]`` payload."""
        with self._lock:
            counts: Dict[str, Dict[str, int]] = {}
            for (policy, action), n in sorted(self._counts.items()):
                counts.setdefault(policy, {})[action] = n
            return {
                "policies": list(self.policies),
                "counts": counts,
                "speculative": {
                    "launched": self._counts.get(
                        ("spec", "launched"), 0),
                    "won": self._counts.get(("spec", "won"), 0),
                    "wasted": self._counts.get(("spec", "wasted"), 0),
                },
                "decisions": [dict(d) for d in self.decisions],
            }

    def prometheus_lines(self, metric, line) -> None:
        with self._lock:
            counts = dict(self._counts)
            policies = self.policies
        metric("bigslice_adaptive_policy_engaged",
               "Adaptive-execution policies engaged by BIGSLICE_"
               "ADAPTIVE (exec/adaptive.py); absent entirely when the "
               "knob is unset.", "gauge")
        for p in POLICIES:
            line("bigslice_adaptive_policy_engaged", {"policy": p},
                 1 if p in policies else 0)
        metric("bigslice_adaptive_decisions_total",
               "Adaptive-planner decisions by policy and action "
               "(skew splits, speculative races, cost shaping, "
               "admission verdicts).", "counter")
        for (policy, action), n in sorted(counts.items()):
            line("bigslice_adaptive_decisions_total",
                 {"policy": policy, "action": action}, n)
        metric("bigslice_adaptive_speculative_total",
               "Speculative straggler duplicates by outcome (won = "
               "the duplicate's atomic RUNNING->OK beat the original; "
               "wasted = the original finished first).", "counter")
        for outcome in ("launched", "won", "wasted"):
            line("bigslice_adaptive_speculative_total",
                 {"outcome": outcome},
                 counts.get(("spec", outcome), 0))


class AdaptivePlanner:
    """The wave-boundary decision maker. Holds the hub (signal source),
    the engaged policy set, and the attribution stats the hub exports.
    One per Session; the mesh executor keeps a reference and consults
    it only where ``self.adaptive is not None`` — the structural form
    of the chicken bit."""

    def __init__(self, hub, policies, headroom: Optional[float] = None,
                 max_split: Optional[int] = None,
                 poll_s: Optional[float] = None):
        self.hub = hub
        self.policies = frozenset(policies)
        if headroom is None:
            headroom = float(os.environ.get(
                "BIGSLICE_ADAPTIVE_HEADROOM", DEFAULT_HEADROOM))
        self.headroom = max(0.01, min(1.0, float(headroom)))
        if max_split is None:
            max_split = int(os.environ.get(
                "BIGSLICE_ADAPTIVE_MAX_SPLIT", DEFAULT_MAX_SPLIT))
        self.max_split = max(2, int(max_split))
        if poll_s is None:
            poll_s = float(os.environ.get(
                "BIGSLICE_ADAPTIVE_POLL_S", DEFAULT_POLL_S))
        self.poll_s = max(0.001, float(poll_s))
        self.stats = AdaptiveStats(
            self.policies,
            eventer=getattr(hub, "_emit", None) if hub is not None
            else None,
        )
        # Cost decisions fire once per (op, action): the budget holds
        # for every wave of an op's run, and re-logging it thousands
        # of times would drown the decision log.
        self._cost_logged: set = set()
        self._lock = threading.Lock()

    # -- skew policy -------------------------------------------------------

    def skew_split_k(self, dep_ops, cap: int,
                     inv: Optional[int] = None) -> int:
        """The split factor for a consumer wave whose producers include
        a skew-flagged shuffle, or 0 (run unsplit). K is the measured
        ratio rounded down to a power of two dividing ``cap`` (only
        exact row-slices keep the slice program's prefix contract),
        capped by ``max_split``."""
        if "skew" not in self.policies or self.hub is None:
            return 0
        skew_of = getattr(self.hub, "skew_of_op", None)
        if skew_of is None:
            return 0
        worst: Optional[dict] = None
        worst_op = None
        for op in dep_ops:
            try:
                sk = skew_of(op)
            except Exception:
                sk = None
            if (sk is not None and sk.get("flagged")
                    and (worst is None
                         or sk["ratio"] > worst["ratio"])):
                worst, worst_op = sk, op
        if worst is None:
            return 0
        want = min(int(worst["ratio"]), self.max_split, int(cap))
        K = 1
        while K * 2 <= want:
            K <<= 1
        while K > 1 and cap % K:
            K >>= 1
        if K <= 1:
            return 0
        self.stats.record(
            "skew", "split", op=worst_op, k=K, inv=inv,
            ratio=round(float(worst["ratio"]), 3),
            hot_shard=worst.get("max_shard"),
            total_rows=worst.get("total_rows"),
        )
        return K

    # -- cost policy -------------------------------------------------------

    def cost_wave_budget(self, op: Optional[str] = None,
                         inv: Optional[int] = None) -> Optional[int]:
        """The measured per-device wave working-set budget: hbm_budget()
        × headroom, or None when the device plane has no limit (a CPU
        executor that never recorded one). Only consulted when the static
        device_budget_bytes knob is unset — an explicit knob always
        wins."""
        if "cost" not in self.policies or self.hub is None:
            return None
        device = getattr(self.hub, "device", None)
        if device is None:
            return None
        try:
            limit = device.hbm_budget()
        except Exception:
            return None
        if not limit:
            return None
        budget = int(int(limit) * self.headroom)
        if budget <= 0:
            return None
        if op is not None:
            with self._lock:
                fresh = ("wave_budget", op) not in self._cost_logged
                if fresh:
                    self._cost_logged.add(("wave_budget", op))
            if fresh:
                self.stats.record(
                    "cost", "wave_budget", op=op, inv=inv,
                    budget_bytes=budget,
                    hbm_limit_bytes=int(limit),
                    headroom=self.headroom,
                )
        return budget

    def note_cost_action(self, action: str, op: str, **detail) -> None:
        """Attribute one cost-shaped executor decision (wave split,
        prefetch clip), once per (action, op)."""
        with self._lock:
            if (action, op) in self._cost_logged:
                return
            self._cost_logged.add((action, op))
        self.stats.record("cost", action, op=op, **detail)

    # -- spec policy -------------------------------------------------------

    def watch(self, tasks, executor) -> Optional["_SpecWatcher"]:
        """Start a straggler watcher over one evaluation's task set
        (the evaluator calls this; None unless the spec policy is
        engaged and the hub can flag live stragglers)."""
        if "spec" not in self.policies or self.hub is None:
            return None
        if getattr(self.hub, "live_stragglers", None) is None:
            return None
        if getattr(executor, "speculate", None) is None:
            return None
        return _SpecWatcher(self, tasks, executor)


class _SpecWatcher:
    """One evaluation's straggler poller: maps the hub's live-straggler
    task keys back to Task objects and asks the executor to race a
    duplicate. One speculation attempt per task key per evaluation —
    losing a race twice teaches nothing the first loss didn't."""

    def __init__(self, planner: AdaptivePlanner, tasks, executor):
        self.planner = planner
        self.executor = executor
        self._by_key = {str(t.name): t for t in tasks}
        self._tried: set = set()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="adaptive-spec-watch"
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.planner.poll_s):
            try:
                self._tick()
            except Exception:
                # The watcher is advisory: a polling error must never
                # become an evaluation error.
                pass

    def _tick(self) -> None:
        for s in self.planner.hub.live_stragglers():
            key = s.get("task")
            if key is None or key in self._tried:
                continue
            task = self._by_key.get(key)
            if task is None:
                continue
            if getattr(task, "coded_group", None) is not None:
                # Coded coverage members already carry pre-paid k-of-n
                # redundancy; a speculative duplicate would double-spend
                # AND race the coverage-settle cancellation on the same
                # RUNNING task (the executor's speculate() refuses too —
                # this skip just avoids burning the one-try-per-key
                # budget on it).
                continue
            self._tried.add(key)
            stats = self.planner.stats
            inv = getattr(task.name, "inv_index", None)

            def attribute(outcome: str, key=key, inv=inv) -> None:
                stats.record("spec", outcome, task=key, inv=inv)

            if self.executor.speculate(task, on_outcome=attribute):
                stats.record(
                    "spec", "launched", task=key, inv=inv,
                    elapsed_s=s.get("elapsed_s"),
                    p50_s=s.get("p50_s"),
                )

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)
