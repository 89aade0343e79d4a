"""Coded k-of-n redundant combines: proactive straggler tolerance.

At a commutative-monoid combine boundary (a map-side combine that no
machine combiner shares) the planner over-decomposes the map side's
``k`` producer tasks into ``n = k + r`` coverage tasks whose partial
aggregates are assigned in *striped coverage groups*, so that any
``k`` of the ``n`` together cover every input unit. The consumer runs
as soon as a covering subset settles; the stragglers are cooperatively
cancelled; duplicate copies are masked before the consumer's
re-combine, so results stay bit-identical to the uncoded plan.

Striping, not erasure codes: unit ``u``'s partial is replicated on
owners ``{(u + j) mod n : j = 0..r}``. Each unit has ``r + 1`` distinct
owners, so any ``r`` losses leave every unit a surviving copy, and the
monoid's determinism makes every copy byte-identical (the masked read
picks one). Total work is ``k * (r + 1)`` units over ``n`` tasks; the
default ``r = ceil(k/8)``.

``BIGSLICE_CODED`` unset (or ``off``): no planner exists, the compiler
emits today's task graph, and no ``bigslice_coded_*`` sample is
exported. ``combine`` engages coding at combine boundaries.
``BIGSLICE_CODED_REDUNDANCY`` overrides ``r`` (an integer ≥ 1). Unknown
values fail loudly. The planner, the stripe and the cover names are the
JAX package's; a coverage member runs on the local executor
(``LocalExecutor._execute_coded``), on the card as on the CPU.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from bigslice_tpu_torch.exec.task import TaskName

#: The modes BIGSLICE_CODED accepts. ``combine`` = code the map side
#: of commutative-monoid combine boundaries.
MODES = ("off", "combine")

#: Bounded decision log (newest kept), same shape as AdaptiveStats.
MAX_DECISIONS = 256

#: Smallest producer set worth coding: k=1 has no straggler to
#: tolerate (the consumer waits on the only task either way).
MIN_K = 2


def plan_mode(env: Optional[str] = None) -> str:
    """Parse ``BIGSLICE_CODED`` (or an explicit value). Unset/empty =
    ``"off"``. Unknown values fail loudly — a typo'd knob silently
    running the uncoded plan would defeat every A/B it exists for."""
    if env is None:
        env = os.environ.get("BIGSLICE_CODED", "")
    env = env.strip().lower()
    if not env:
        return "off"
    if env not in MODES:
        raise ValueError(
            f"BIGSLICE_CODED must be one of {'|'.join(MODES)}, "
            f"got {env!r}"
        )
    return env


def redundancy(k: int, env: Optional[str] = None) -> int:
    """The redundancy ``r`` for a k-producer coverage group:
    ``BIGSLICE_CODED_REDUNDANCY`` when set (≥ 1, fail loudly), else
    ``ceil(k / 8)`` — +12.5% pre-paid work, tolerating one slow host
    per eight."""
    if env is None:
        env = os.environ.get("BIGSLICE_CODED_REDUNDANCY", "")
    env = env.strip()
    if env:
        try:
            r = int(env)
        except ValueError as e:
            raise ValueError(
                f"BIGSLICE_CODED_REDUNDANCY must be an integer ≥ 1, "
                f"got {env!r}"
            ) from e
        if r < 1:
            raise ValueError(
                f"BIGSLICE_CODED_REDUNDANCY must be ≥ 1, got {r}"
            )
        return r
    return max(1, math.ceil(k / 8))


class CoverageGroup:
    """One coded combine boundary: ``k`` input units over-decomposed
    into ``n = k + r`` striped coverage tasks. The group is the shared
    identity the compiler stamps on every member (``task.coded_group``)
    and on the consumer's dep (``TaskDep.coded``); the evaluator keys
    its k-of-n settle bookkeeping on it and the executor derives
    per-unit store names from it."""

    def __init__(self, inv_index: int, op: str, k: int, r: int):
        self.inv_index = inv_index
        self.op = op
        self.k = int(k)
        self.r = int(r)
        self.n = self.k + self.r
        # Filled by the compiler once the member tasks exist (the group
        # must be constructed first so each member can carry it).
        self.tasks: Tuple = ()

    def owners(self, u: int) -> List[int]:
        """The member indices owning unit ``u``'s partial aggregate,
        preference-ordered (the masked read tries them in this order,
        so every consumer deterministically prefers the same copy)."""
        return [(u + j) % self.n for j in range(self.r + 1)]

    def covers(self, i: int) -> List[int]:
        """The units member ``i`` computes, ascending. Striping gives
        each member at most ``r + 1`` units (fewer near the wrap,
        since unit indices stop at ``k``)."""
        return sorted(
            u for j in range(self.r + 1)
            if (u := (i - j) % self.n) < self.k
        )

    def cover_name(self, u: int, i: int) -> TaskName:
        """The store name member ``i`` writes unit ``u``'s partial-
        combine partitions under. Per-unit addressing is what makes
        duplicate masking possible: the consumer picks ONE owner's
        copy per unit instead of concatenating every member's
        output."""
        return TaskName(self.inv_index, f"{self.op}~cov{u}", i, self.n)

    def __repr__(self) -> str:
        return (f"CoverageGroup({self.op}, k={self.k}, r={self.r}, "
                f"n={self.n})")


class CodedStats:
    """Attribution for the coded plane, shaped like AdaptiveStats: the
    telemetry hub calls ``summary()`` / ``prometheus_lines()`` only
    when a planner is attached, which is what guarantees zero
    ``bigslice_coded_*`` samples with BIGSLICE_CODED unset."""

    def __init__(self, mode: str, eventer=None):
        self._lock = threading.Lock()
        self.mode = mode
        self._eventer = eventer
        # action -> count. Actions: group (a boundary coded), covered
        # (a covering k-subset settled), cancelled (a straggler member
        # cooperatively cancelled), masked (a duplicate-coverage copy
        # masked at consumer read), unit (a coverage unit computed),
        # recovered (coverage re-established after a loss).
        self._counts: Dict[str, int] = {}
        self.decisions: List[dict] = []
        self._t0 = time.monotonic()

    def record(self, action: str, **detail) -> None:
        """One coded-plane event: count it, log it (bounded), and emit
        a ``bigslice:coded`` instant for slicetrace's ``invN:coded``
        section. Never raises."""
        entry = {"action": action,
                 "t_s": round(time.monotonic() - self._t0, 6)}
        entry.update({k: v for k, v in detail.items()
                      if v is not None})
        with self._lock:
            self._counts[action] = self._counts.get(action, 0) + 1
            self.decisions.append(entry)
            if len(self.decisions) > MAX_DECISIONS:
                del self.decisions[: len(self.decisions)
                                   - MAX_DECISIONS]
        ev = self._eventer
        if ev is not None:
            try:
                ev("bigslice:coded", action=action,
                   **{k: v for k, v in detail.items()
                      if v is not None})
            except Exception:
                pass

    def count(self, action: str) -> int:
        with self._lock:
            return self._counts.get(action, 0)

    def summary(self) -> dict:
        """The ``telemetry_summary()["coded"]`` payload."""
        with self._lock:
            return {
                "mode": self.mode,
                "counts": dict(sorted(self._counts.items())),
                "decisions": [dict(d) for d in self.decisions],
            }

    def prometheus_lines(self, metric, line) -> None:
        with self._lock:
            counts = dict(self._counts)
            mode = self.mode
        metric("bigslice_coded_mode",
               "Coded-combine mode engaged by BIGSLICE_CODED "
               "(exec/codedplan.py); absent entirely when the knob "
               "is unset.", "gauge")
        line("bigslice_coded_mode", {"mode": mode}, 1)
        metric("bigslice_coded_events_total",
               "Coded k-of-n plane events: groups planned, coverage "
               "settled, straggler members cancelled, duplicate "
               "copies masked, units computed, coverage recovered "
               "after loss.", "counter")
        for action, n in sorted(counts.items()):
            line("bigslice_coded_events_total", {"action": action}, n)


class CodedPlanner:
    """The compile-time decision maker: whether a combine boundary is
    coded and with what ``(k, r)``. One per Session; the compiler and
    evaluator consult it only where ``planner is not None`` — the
    structural form of the chicken bit."""

    def __init__(self, hub=None, mode: str = "combine"):
        self.hub = hub
        self.mode = mode
        self.stats = CodedStats(
            mode,
            eventer=getattr(hub, "_emit", None) if hub is not None
            else None,
        )

    def group_for(self, inv_index: int, op: str,
                  k: int) -> Optional[CoverageGroup]:
        """A CoverageGroup for a k-producer combine boundary, or None
        when coding buys nothing (k < 2). The redundancy knob is read
        per boundary so tests can vary it without a fresh planner."""
        if self.mode != "combine" or k < MIN_K:
            return None
        r = redundancy(k)
        grp = CoverageGroup(inv_index, op, k, r)
        self.stats.record("group", op=op, inv=inv_index,
                          k=k, r=r, n=grp.n)
        return grp


def planner_from_env(hub=None) -> Optional[CodedPlanner]:
    """The session-construction entry point: a ``CodedPlanner`` when
    BIGSLICE_CODED engages a mode, else None (callers hold
    ``planner is None`` and run the legacy path untouched)."""
    mode = plan_mode()
    if mode == "off":
        return None
    return CodedPlanner(hub, mode)
