"""The deterministic fault-injection plane: a seeded chaos monkey.

A seeded ``FaultPlan`` with per-site rate and count budgets decides,
for each invocation of a named seam, whether that invocation fails and
how. The decision is a pure function of ``(seed, site, invocation
id)``, so the same seed reproduces the same faults: a chaos failure is
a replayable bug report, not a flake. The plan, its spec grammar and
its decision function are the JAX package's, byte for byte, so a spec
fires at the same invocation ids in both packages.

**Sites** are the named seams of ``SITES``, wired into every layer that
recovery depends on: store reads and writes, the frame codec, the
staging arena and its upload to the card, the device executor's group
dispatch, and the evaluator's resubmission. A seam asks the active plan
``fire(site)``; the plan counts the invocation (per site, in call
order), hashes ``(seed, site, invocation_id)`` to a uniform draw and,
while the site's count budget lasts, returns a ``Fault`` that tells the
seam what to do (raise a transient IO error, delete a committed file,
corrupt frame bytes, ...). With no plan every seam is one read of the
module flag ``ENABLED``.

**Spec grammar** (``BIGSLICE_CHAOS=seed:spec``)::

    spec  := rule ("," rule)*
    rule  := site "=" rate ["x" count] ["~" kind]

    BIGSLICE_CHAOS="7:store.read=0.05x4,codec.read=0.03x2~flip,io.read=0.2"

``rate`` is the per-invocation fire probability, ``count`` the site's
total fire budget (unlimited when omitted), ``kind`` the site's failure
mode (the first listed is the default). ``site`` may be an ``fnmatch``
glob (``store.*``); exact names are validated against the registry.

**Determinism.** Invocation ids count per site in call order. Where
threads interleave (the wave prefetcher, the task pool), the order of
the injection log may differ run to run; the sorted ``(site, kind,
inv_id)`` log and the results are what replay.

Every injected exception carries ``fault`` and ``fault_site``, so that
the telemetry hub attributes the recovery it then observes (LOST → ...
→ OK) to the injecting site. Faults that corrupt data instead of
raising (``codec.read``) surface through the codec's own
``CorruptionError`` → quarantine → ``Missing`` path.

``peer.lost`` and the ``hostloss`` kind name the multi-host plane,
which this package has not: their faults raise ``InjectedLoss`` (the
device executor surfaces ``hostloss`` as ``HostLostError``), so a spec
the JAX package accepts parses here too.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from fnmatch import fnmatchcase
from typing import Dict, List, NamedTuple, Optional, Tuple

# -- site registry ---------------------------------------------------------

SITES: Dict[str, dict] = {}


def _site(name: str, kinds: Tuple[str, ...], doc: str) -> None:
    SITES[name] = {"kinds": kinds, "default": kinds[0], "doc": doc}


_site("io.read", ("io",),
      "fileio.open_read: transient open failure (retried with bounded "
      "exponential backoff, BIGSLICE_IO_RETRIES)")
_site("io.commit", ("io",),
      "fileio.atomic_write commit (os.replace / object-store mv): "
      "transient failure, retried")
_site("store.put", ("io",),
      "FileStore.put entry: transient write failure before any frame "
      "is consumed, retried")
_site("store.read", ("lose", "slow"),
      "Store read: 'lose' = the committed output vanishes (file removed "
      "/ memory entry dropped) -> Missing -> DepLost -> producer "
      "recompute; 'slow' = a seeded deterministic per-read delay (a "
      "reproducible slow disk / hot host for straggler tests)")
_site("codec.read", ("flip", "truncate"),
      "codec.read_stream: corrupt one frame's body bytes (bit-flip -> "
      "checksum mismatch; truncate -> short body) -> CorruptionError -> "
      "quarantine + Missing")
_site("staging.assemble", ("io",),
      "staging.assemble entry (exec/staging.py): transient failure "
      "before any arena buffer is taken, retried by the device "
      "executor's staging path")
_site("shuffle.upload", ("io",),
      "the device executor's upload of a staged wave to the card "
      "(MeshExecutor._upload, and the arena's copy): transient failure "
      "before any copy is issued, retried over the same host data")
_site("spill.write", ("io",),
      "SpillExchange.put_partition entry (out-of-core shuffle spill "
      "write): transient failure before any frame is built, retried "
      "with bounded backoff")
_site("spill.read", ("lose",),
      "SpillExchange.read_partition: a spilled shuffle partition "
      "vanishes (file dropped) -> Missing -> DepLost -> the producer "
      "group recomputes and re-spills")
_site("mesh.dispatch", ("infra", "hostloss", "slow"),
      "the device executor's group dispatch: 'infra' = a device-runtime "
      "failure, the CUDA out-of-memory class (probation -> host-tier "
      "resubmit); 'hostloss' = a lost host (HostLostError, raised by "
      "name: no elastic mesh recovery here); 'slow' = a seeded "
      "deterministic pre-dispatch delay (a reproducible straggler)")
_site("peer.lost", ("lost",),
      "a peer's keepalive judged stale: the multi-host plane's seam, "
      "registered so that specs parse; nothing here fires it")
_site("eval.resubmit", ("lose",),
      "evaluator _submit: the submission is lost in flight (task marked "
      "LOST; the evaluator's ladder resubmits, bounded by "
      "MAX_CONSECUTIVE_LOST)")
_site("task.run", ("slow", "stuck", "lose"),
      "LocalExecutor._run, after the WAITING->RUNNING claim: 'slow' = "
      "a seeded deterministic delay before the body runs (a "
      "reproducible slow host — the coded/speculation A/B's straggler "
      "source, hit identically by coded and uncoded arms); 'stuck' = "
      "the task never completes until cooperatively cancelled (blocks "
      "on task.cancel_event -> TaskCancelled); 'lose' = the run is "
      "lost (task marked LOST, resubmitted by the evaluator's ladder)")
_site("coded.cover", ("lose", "slow", "stuck"),
      "coded coverage member's per-unit step (LocalExecutor."
      "_execute_coded; "
      "only fires when BIGSLICE_CODED engages): 'lose' = the member is "
      "lost mid-coverage -> LOST -> k-of-n absorbs up to r losses, "
      "r+1 degrade to the loud recompute ladder; 'slow' = a seeded "
      "per-unit delay; 'stuck' = the member wedges until the settled "
      "coverage cancels it")


def sites() -> Dict[str, dict]:
    """The seam registry: site -> {kinds, default, doc}."""
    return dict(SITES)


# -- faults and injected-exception taxonomy --------------------------------

class Fault(NamedTuple):
    site: str
    kind: str
    inv_id: int

    def describe(self) -> str:
        return f"{self.site}#{self.inv_id}~{self.kind}"


def _mark(e: BaseException, fault: Fault) -> BaseException:
    e.fault = fault
    e.fault_site = fault.site
    return e


class InjectedIOError(IOError):
    """A chaos-plane transient IO failure (retried by fileio's bounded
    backoff like any other transient OSError)."""


class InjectedLoss(RuntimeError):
    """A chaos-plane loss (output/submission vanished): the evaluator's
    LOST ladder is the recovery."""


class InjectedInfraError(RuntimeError):
    """A chaos-plane device-runtime failure. The message deliberately
    carries an infra marker (``resource_exhausted``) so the executor's
    fatal-vs-lost classifier routes it like a real XLA runtime error."""


def injected_error(fault: Fault) -> BaseException:
    """The exception a raising seam should throw for ``fault``."""
    if fault.kind == "io":
        return _mark(InjectedIOError(
            f"injected transient IO failure ({fault.describe()})"
        ), fault)
    if fault.kind == "infra":
        return _mark(InjectedInfraError(
            f"injected device fault: resource_exhausted "
            f"({fault.describe()})"
        ), fault)
    if fault.kind in ("hostloss", "lost"):
        # No multi-host plane here: a peer loss is a loss.
        return _mark(InjectedLoss(
            f"injected peer loss ({fault.describe()})"
        ), fault)
    return _mark(InjectedLoss(
        f"injected loss ({fault.describe()})"
    ), fault)


# Base for 'slow'-kind delays. The actual delay for a fault is
# base * (1 + _unit(seed, site + "#slow", inv_id)) — between 1x and 2x
# the base, a pure function of the plan seed, so a slow-host chaos plan
# replays the exact same straggler profile run over run.
DEFAULT_SLOW_S = 0.05


def slow_delay_s(fault: Fault) -> float:
    """The deterministic delay (seconds) a 'slow' fault carries."""
    base = float(os.environ.get("BIGSLICE_CHAOS_SLOW_S", DEFAULT_SLOW_S))
    p = _PLAN
    seed = p.seed if p is not None else 0
    return base * (1.0 + _unit(seed, fault.site + "#slow", fault.inv_id))


def absorb_slow(fault: Optional[Fault]) -> Optional[Fault]:
    """Seam helper for sites registered with the 'slow' kind: sleep the
    fault's deterministic delay and absorb it (return None) so the seam's
    raising ladder never sees it; any other fault (or None) passes
    through unchanged."""
    if fault is None or fault.kind != "slow":
        return fault
    time.sleep(slow_delay_s(fault))
    return None


# Upper bound on a 'stuck' fault's wedge: a stuck task that nothing
# ever cancels must eventually fail loudly (LOST via InjectedLoss)
# rather than hang a chicken-bit run forever — the bound is generous
# next to any test/CI cancellation latency.
STUCK_MAX_S = 120.0


def absorb_slow_or_stuck(fault: Optional[Fault],
                         task) -> Optional[Fault]:
    """Seam helper for task-body sites with 'slow' and 'stuck' kinds:
    'slow' sleeps its deterministic delay and is absorbed; 'stuck'
    parks on the task's cancel_event — the fault models a task that
    NEVER completes on its own, so the only exits are cooperative
    cancellation (raises TaskCancelled, the executor transitions the
    task to CANCELLED) or the loud STUCK_MAX_S timeout (raises
    InjectedLoss -> LOST -> resubmit ladder). Other faults (or None)
    pass through unchanged."""
    if fault is None:
        return None
    if fault.kind == "slow":
        # Cancel-aware sleep: a slowed task that coverage (or a
        # deadline) cancels mid-delay wakes immediately instead of
        # holding its executor slot — and its thread — for the full
        # injected delay.
        from bigslice_tpu_torch.exec.task import TaskCancelled

        if task.cancel_event.wait(timeout=slow_delay_s(fault)):
            raise TaskCancelled(task)
        return None
    if fault.kind == "stuck":
        from bigslice_tpu_torch.exec.task import TaskCancelled

        if task.cancel_event.wait(timeout=STUCK_MAX_S):
            raise TaskCancelled(task)
        raise _mark(InjectedLoss(
            f"injected stuck task never cancelled within "
            f"{STUCK_MAX_S:.0f}s ({fault.describe()})"
        ), fault)
    return fault


def fault_site_of(e: Optional[BaseException]) -> Optional[str]:
    """The injecting site in ``e``'s failure chain (``__cause__`` /
    ``__context__`` / TaskError-style ``.cause``), or None."""
    seen = set()
    stack = [e]
    while stack:
        err = stack.pop()
        if err is None or id(err) in seen:
            continue
        seen.add(id(err))
        site = getattr(err, "fault_site", None)
        if site is not None:
            return site
        stack.append(getattr(err, "cause", None))
        stack.append(err.__cause__)
        stack.append(err.__context__)
    return None


# -- the plan --------------------------------------------------------------

class Rule(NamedTuple):
    pattern: str
    rate: float
    count: Optional[int]        # total fire budget; None = unlimited
    kind: Optional[str]         # None = the site's default kind


def _unit(seed: int, site: str, inv_id: int) -> float:
    """Uniform [0, 1) draw, a pure function of (seed, site, inv_id)."""
    h = hashlib.sha256(f"{seed}:{site}:{inv_id}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


class FaultPlan:
    """A seeded, budgeted injection schedule over the site registry."""

    def __init__(self, seed: int, rules: List[Rule], spec: str = ""):
        self.seed = int(seed)
        self.rules = list(rules)
        self.spec = spec
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}     # site -> invocations seen
        self._fired: Dict[int, int] = {}     # rule index -> fires
        self._t0 = time.monotonic()
        self.log: List[dict] = []

    def _rule_for(self, site: str) -> Tuple[Optional[int], Optional[Rule]]:
        for i, r in enumerate(self.rules):
            if r.pattern == site or fnmatchcase(site, r.pattern):
                return i, r
        return None, None

    def fire(self, site: str) -> Optional[Fault]:
        """Consult the plan for one invocation of ``site``; returns the
        Fault to inject, or None. Counts the invocation either way (the
        determinism key)."""
        ri, rule = self._rule_for(site)
        with self._lock:
            inv = self._calls.get(site, 0)
            self._calls[site] = inv + 1
            if rule is None:
                return None
            if rule.count is not None and \
                    self._fired.get(ri, 0) >= rule.count:
                return None
            if _unit(self.seed, site, inv) >= rule.rate:
                return None
            self._fired[ri] = self._fired.get(ri, 0) + 1
            kind = rule.kind or SITES.get(site, {}).get("default", "io")
            fault = Fault(site, kind, inv)
            self.log.append({
                "site": site, "kind": kind, "inv_id": inv,
                "t_s": round(time.monotonic() - self._t0, 6),
            })
            return fault

    def snapshot(self) -> dict:
        """Counters + log for the recovery matrix / Prometheus export."""
        with self._lock:
            injected: Dict[str, int] = {}
            by_kind: Dict[str, Dict[str, int]] = {}
            for e in self.log:
                injected[e["site"]] = injected.get(e["site"], 0) + 1
                bk = by_kind.setdefault(e["site"], {})
                bk[e["kind"]] = bk.get(e["kind"], 0) + 1
            return {
                "seed": self.seed,
                "spec": self.spec,
                "calls": dict(self._calls),
                "injected": injected,
                "by_kind": by_kind,
                "log": [dict(e) for e in self.log],
            }


def parse_plan(spec: str) -> FaultPlan:
    """Parse ``seed:spec`` (see the module docstring's grammar)."""
    seed_s, sep, body = spec.partition(":")
    if not sep:
        raise ValueError(
            f"BIGSLICE_CHAOS must be 'seed:site=rate[xN][~kind],...', "
            f"got {spec!r}"
        )
    try:
        seed = int(seed_s)
    except ValueError as e:
        raise ValueError(f"chaos seed must be an integer: {seed_s!r}") \
            from e
    rules: List[Rule] = []
    for part in body.split(","):
        part = part.strip()
        if not part:
            continue
        site, eq, rhs = part.partition("=")
        site = site.strip()
        if not eq or not site:
            raise ValueError(f"bad chaos rule (no '='): {part!r}")
        kind: Optional[str] = None
        if "~" in rhs:
            rhs, kind = rhs.split("~", 1)
            kind = kind.strip()
        count: Optional[int] = None
        if "x" in rhs:
            rhs, count_s = rhs.split("x", 1)
            count = int(count_s)
            if count < 0:
                raise ValueError(f"bad chaos count in {part!r}")
        rate = float(rhs)
        if not 0.0 <= rate <= 1.0:
            raise ValueError(
                f"chaos rate must be in [0, 1], got {rate} in {part!r}"
            )
        glob = any(c in site for c in "*?[")
        if not glob and site not in SITES:
            raise ValueError(
                f"unknown chaos site {site!r} (known: "
                f"{', '.join(sorted(SITES))})"
            )
        if kind is not None and not glob and \
                kind not in SITES[site]["kinds"]:
            raise ValueError(
                f"site {site!r} has kinds {SITES[site]['kinds']}, "
                f"got {kind!r}"
            )
        rules.append(Rule(site, rate, count, kind))
    return FaultPlan(seed, rules, spec)


# -- process-global activation --------------------------------------------

_PLAN: Optional[FaultPlan] = None
ENABLED = False
#: Calls of ``fire`` and ``maybe_raise``, plan or not. Every seam reads
#: ``ENABLED`` first, so with no plan installed this stays where it was
#: (a count, not a lock: exact while no plan is installed).
CALLS = 0


def install(plan: FaultPlan) -> FaultPlan:
    global _PLAN, ENABLED
    _PLAN = plan
    ENABLED = True
    return plan


def clear() -> None:
    global _PLAN, ENABLED
    _PLAN = None
    ENABLED = False


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def install_from_env() -> Optional[FaultPlan]:
    spec = os.environ.get("BIGSLICE_CHAOS")
    if not spec:
        return None
    return install(parse_plan(spec))


def fire(site: str) -> Optional[Fault]:
    """The seam entry point: None without an active plan (a module
    global read + compare — the hot path's whole cost)."""
    global CALLS
    CALLS += 1
    p = _PLAN
    if p is None:
        return None
    return p.fire(site)


def maybe_raise(site: str) -> None:
    """Seam helper for raising sites: throw the injected exception when
    the plan says so, else return."""
    global CALLS
    CALLS += 1
    p = _PLAN
    if p is None:
        return
    f = p.fire(site)
    if f is not None:
        raise injected_error(f)


# A chaos env set before process start activates the plane everywhere
# without any code opt-in (the chaosslice CLI and CI smoke path).
install_from_env()
