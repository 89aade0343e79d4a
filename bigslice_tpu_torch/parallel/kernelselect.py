"""Measured per-op kernel selection: sort against hash against dense.

The JAX package's ``parallel/kernelselect.py``, ported. The device
executor has three lowerings for a keyed combine or shuffle boundary:
the sort and segmented scan (``parallel/segment.py``), the
open-addressed hash table (``parallel/hashagg.py``, the CUDA kernel K2
on the card and its plain version on the CPU) and the dense rank table
(``parallel/dense.py``). Without a selector the executor's defaults
decide: hash where ``FrameCombiner.hash_ops()`` classifies the
combiner, dense where a bound is declared or discovered.

``BIGSLICE_KERNEL_SELECT``: unset (or ``off``), no selector exists and
no selection code runs; the lowerings are the defaults, bit for bit.
An unknown value raises.

- ``static`` records the verdict of the executor's own gates (the
  keyutil rules, the combiner's classification, the overflow list, a
  dense bound, ``MeshExecutor(hash_aggregate=)``) with its reason and
  moves no lowering: on the card K2 is built, so the static choice for
  an eligible boundary is the hash lowering, which is the default.
- ``measured`` also races, once per op shape, the sort core
  (``segment.make_segmented_reduce_masked``) against the hash core
  (``hashagg.make_hash_combine``) on a corpus shaped by the hub's
  per-partition rows of the op, and takes the winner only when it beats
  the loser by ``PROBE_MIN_MARGIN`` (``PROBE_OVERRIDE_MARGIN`` and
  fully separated samples to overturn the static choice). Probes run in
  one process only: under ``torch.distributed`` with more than one rank
  each rank's clock would differ and so could its lowering, so a gang
  takes the static verdict.

The static reasons, against the JAX package's:

- ``static:cpu-scatter-wins``: the CPU, the same string as the JAX
  package's off-TPU verdict, so that CPU runs compare reason for reason;
- ``static:cuda-kernel``: the card, where K2 is built (the
  counterpart of ``static:mosaic-kernel``). The JAX package's
  ``static:tpu-no-kernel`` has no counterpart: a card without K2 fails
  at ``MeshExecutor`` construction.

The probe launches its kernels on the selector's device; its launches
are attributed to the op under kind ``kselect``, apart from the op's
wave launches (``DeviceTelemetry.record_launch``). The JAX package's
probes compile into its cross-session program cache; this package
compiles nothing, but its two probe programs enter the port's program
cache (``serve/programcache.py``) under kind ``kselect`` all the same:
a second selector of the process probing the same op shape finds both
there (``cross_session_hits``) and builds none (``program_builds``).

Re-selection: each decision keeps the per-partition snapshot it was
based on; ``observe_wave`` (the executor calls it after each
partitioned group's rows are recorded, through the adaptive planner
when one is attached) drops the decision when the op's profile shifts
by ``RESELECT_RATIO``, and the op's next wave program decides again.
``forget`` drops an op's decisions when a gate under them moves (a
retracted dense bound, a hash table that overflowed): the rerun
decides, and is recorded, again.

Every decision is attributed: counts and a bounded log in
``telemetry_summary()["kernel_select"]``, the Prometheus families
``bigslice_kernel_select_mode`` and ``bigslice_kernel_select_total``,
and ``bigslice:kernel_select`` trace instants that ``tools/slicetrace``
renders as an ``invN:kernels`` section. With the knob unset none of
them exists.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

MODES = ("off", "static", "measured")

#: The bounded decision log (the newest kept).
MAX_DECISIONS = 256

#: Probe rows when the hub has no per-partition rows of the op yet.
DEFAULT_PROBE_ROWS = 4096

#: The probe's row ceiling: a microbenchmark, not a rerun.
MAX_PROBE_ROWS = 1 << 16

#: A measured winner must beat the loser by this factor, or the static
#: choice stands (timer noise must not flip lowerings).
PROBE_MIN_MARGIN = 1.05

#: Overturning the static choice takes more than winning: the probe
#: times the combine core only, not what the lowering does to the
#: exchange after it, so a verdict against the static choice needs this
#: median margin and every winner sample faster than every loser
#: sample; anything weaker stands as ``measured:margin``.
PROBE_OVERRIDE_MARGIN = 1.25

#: Timed samples a candidate (after one warm-up call), interleaved
#: sort, hash, sort, hash; the verdict compares medians.
PROBE_ITERS = 5

#: observe_wave drops a decision when the op's max-partition or total
#: rows shift by this factor against the decision's snapshot.
RESELECT_RATIO = 2.0


def mode_from_env(env: Optional[str] = None) -> Optional[str]:
    """Parse ``BIGSLICE_KERNEL_SELECT``: unset, empty or ``off`` give
    None (no selector); ``static`` and ``measured`` pass through;
    anything else raises."""
    if env is None:
        env = os.environ.get("BIGSLICE_KERNEL_SELECT", "")
    env = env.strip().lower()
    if not env or env == "off":
        return None
    if env not in MODES:
        raise ValueError(
            f"BIGSLICE_KERNEL_SELECT must be off|static|measured, "
            f"got {env!r}"
        )
    return env


def selector_from_env(hub=None, device=None) -> Optional["KernelSelector"]:
    """A ``KernelSelector`` when the knob engages a mode, else None."""
    mode = mode_from_env()
    if mode is None:
        return None
    return KernelSelector(mode, hub, device=device)


def process_count() -> int:
    """The ranks of this job: ``torch.distributed``'s world size, or 1
    where it is not initialised (reference ``jax.process_count()``)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


class KernelSelectStats:
    """Decision attribution: the hub calls ``summary()`` and
    ``prometheus_lines()`` only when a selector is attached, so with the
    knob unset no ``bigslice_kernel_select_*`` sample exists."""

    def __init__(self, mode: str, eventer=None):
        self._lock = threading.Lock()
        self.mode = mode
        self._eventer = eventer
        # (kernel, reason) -> count.
        self._counts: Dict[Tuple[str, str], int] = {}
        self.decisions: List[dict] = []
        self._t0 = time.monotonic()

    def record(self, kernel: str, reason: str, **detail) -> None:
        """One selection: count it, log it (bounded) and emit a
        ``bigslice:kernel_select`` instant. Never raises."""
        entry = {
            "kernel": kernel, "reason": reason,
            "t_s": round(time.monotonic() - self._t0, 6),
        }
        entry.update({k: v for k, v in detail.items() if v is not None})
        with self._lock:
            key = (kernel, reason)
            self._counts[key] = self._counts.get(key, 0) + 1
            self.decisions.append(entry)
            if len(self.decisions) > MAX_DECISIONS:
                del self.decisions[: len(self.decisions) - MAX_DECISIONS]
        ev = self._eventer
        if ev is not None:
            try:
                ev("bigslice:kernel_select", kernel=kernel, reason=reason,
                   **{k: v for k, v in detail.items() if v is not None})
            except Exception:  # noqa: BLE001 — attribution never fails a run
                pass

    def count(self, kernel: str, reason: Optional[str] = None) -> int:
        with self._lock:
            if reason is not None:
                return self._counts.get((kernel, reason), 0)
            return sum(n for (k, _), n in self._counts.items()
                       if k == kernel)

    @property
    def samples(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def summary(self) -> dict:
        """The ``telemetry_summary()["kernel_select"]`` payload."""
        with self._lock:
            counts: Dict[str, Dict[str, int]] = {}
            for (kernel, reason), n in sorted(self._counts.items()):
                counts.setdefault(kernel, {})[reason] = n
            return {
                "mode": self.mode,
                "counts": counts,
                "decisions": [dict(d) for d in self.decisions],
            }

    def prometheus_lines(self, metric, line) -> None:
        with self._lock:
            counts = dict(self._counts)
            mode = self.mode
        metric("bigslice_kernel_select_mode",
               "Kernel selection mode engaged by BIGSLICE_KERNEL_SELECT "
               "(parallel/kernelselect.py); absent when the knob is "
               "unset.", "gauge")
        for m in ("static", "measured"):
            line("bigslice_kernel_select_mode", {"mode": m},
                 1 if m == mode else 0)
        metric("bigslice_kernel_select_total",
               "Kernel selector lowering decisions by chosen kernel and "
               "reason (sort / hash / dense per combine or shuffle "
               "boundary).", "counter")
        for (kernel, reason), n in sorted(counts.items()):
            line("bigslice_kernel_select_total",
                 {"kernel": kernel, "reason": reason}, n)


class KernelSelector:
    """The per-boundary lowering decision maker, one a session. The
    device executor consults it only where ``kernel_select is not
    None``. Decisions are cached per (op, site)."""

    def __init__(self, mode: str, hub=None, device=None):
        self.mode = mode
        self.hub = hub
        # The device the probes run on and the static verdict reads
        # (the session passes its executor's); cuda unless asked.
        self.device = torch.device("cuda" if device is None else device)
        self.stats = KernelSelectStats(
            mode, eventer=getattr(hub, "_emit", None)
            if hub is not None else None)
        self._lock = threading.Lock()
        # (opbase, site) -> {"kernel", "reason", "skew": snapshot}
        self._decisions: Dict[Tuple[str, str], dict] = {}
        # opbase -> the hub's op name (a repeated invocation suffixes
        # it; the executor passes the real one at observe time).
        self._hub_alias: Dict[str, str] = {}
        # The invocation the executor is building a program for, so
        # that instants land in the right invN section (attribution
        # only, never keyed on).
        self.current_inv: Optional[int] = None
        # probe signature -> {"winner", "walls_ms", ...}: once per op
        # shape, shared by ops of the same signature.
        self._probes: Dict[tuple, dict] = {}

    # -- decision ----------------------------------------------------------

    def choose(self, opbase: str, site: str, *, nkeys: int, nvals: int,
               ops: Tuple[str, ...], key_dtypes: Tuple[str, ...],
               val_dtypes: Tuple[str, ...], hash_eligible: bool,
               dense_bound: bool) -> str:
        """The lowering of one boundary, ``"dense" | "hash" | "sort"``
        (reference ``:252-290``). ``hash_eligible`` is the executor's
        gate verdict, which is also what it does without a selector
        (the JAX package's ``legacy_hash`` only mattered on a TPU without
        its kernel); ``dense_bound`` a declared or discovered bound (the
        dense table takes precedence)."""
        dkey = (opbase, site)
        with self._lock:
            cached = self._decisions.get(dkey)
        if cached is not None:
            return cached["kernel"]
        if dense_bound:
            kernel, reason, evidence = "dense", "dense-bound", {}
        elif not hash_eligible:
            kernel, reason, evidence = "sort", "hash-ineligible", {}
        else:
            kernel, reason, evidence = self._static_choice(opbase)
            if self.mode == "measured":
                kernel, reason, evidence = self._measured_choice(
                    opbase, site, kernel, reason, evidence,
                    nkeys=nkeys, nvals=nvals, ops=ops,
                    key_dtypes=key_dtypes, val_dtypes=val_dtypes,
                )
        decision = {"kernel": kernel, "reason": reason,
                    "skew": self._skew_snapshot(opbase)}
        with self._lock:
            # The first decision wins a race: every later caller must
            # agree with the lowering that ran.
            cached = self._decisions.setdefault(dkey, decision)
        if cached is decision:
            self.stats.record(kernel, reason, op=opbase, site=site,
                              inv=self.current_inv, **evidence)
        return cached["kernel"]

    def _static_choice(self, opbase: str) -> Tuple[str, str, dict]:
        """The verdict without a probe for an eligible boundary
        (reference ``:292-320``): the hash lowering on both devices, on
        the CPU by the JAX package's measurement of its scatter path, on
        the card because K2 is built (the executor refuses to start
        without it)."""
        evidence = {}
        device = getattr(self.hub, "device", None) \
            if self.hub is not None else None
        if device is not None:
            b = device.cost_bytes(opbase)
            if b:
                evidence["cost_bytes"] = int(b)
        if self.device.type != "cuda":
            return "hash", "static:cpu-scatter-wins", evidence
        return "hash", "static:cuda-kernel", evidence

    # -- measured probes ---------------------------------------------------

    def _measured_choice(self, opbase: str, site: str,
                         static_kernel: str, static_reason: str,
                         static_evidence: dict, *, nkeys, nvals, ops,
                         key_dtypes, val_dtypes):
        if process_count() > 1:
            # Clocks differ across ranks; a rank-diverging lowering
            # would deadlock the exchange.
            return static_kernel, "static:multiprocess", static_evidence
        rows, distinct, skew = self._probe_corpus_shape(opbase)
        sig = ("kselect", nkeys, nvals, tuple(ops), tuple(key_dtypes),
               tuple(val_dtypes), rows, distinct)
        with self._lock:
            probe = self._probes.get(sig)
        if probe is None:
            try:
                probe = self._run_probe(opbase, sig, rows, distinct,
                                        nkeys, nvals, ops, val_dtypes)
            except Exception as e:  # noqa: BLE001 — a probe never fails a run
                probe = {"winner": None, "error": repr(e)}
            with self._lock:
                probe = self._probes.setdefault(sig, probe)
        evidence = dict(static_evidence)
        evidence.update({k: v for k, v in probe.items() if k != "winner"})
        evidence["probe_rows"] = rows
        if skew is not None:
            evidence["max_rows"] = skew.get("max_rows")
        if probe.get("winner") is None:
            return static_kernel, "measured:probe-failed", evidence
        walls = probe.get("walls_ms", {})
        if len(walls) < 2 or min(walls.values()) <= 0:
            return static_kernel, "measured:margin", evidence
        winner = min(walls, key=walls.get)
        margin = max(walls.values()) / min(walls.values())
        if margin < PROBE_MIN_MARGIN:
            return static_kernel, "measured:margin", evidence
        if winner == static_kernel:
            return winner, "measured:probe", evidence
        # Against the static choice: decisive (the override margin) and
        # repeatable (the winner's slowest beats the loser's fastest).
        samples = probe.get("walls_all_ms") or {
            k: [v] for k, v in walls.items()}
        loser = next(k for k in walls if k != winner)
        separated = (max(samples.get(winner, [float("inf")]))
                     < min(samples.get(loser, [0.0])))
        if margin >= PROBE_OVERRIDE_MARGIN and separated:
            return winner, "measured:probe", evidence
        return static_kernel, "measured:margin", evidence

    def _probe_corpus_shape(self, opbase: str):
        """Probe rows from the hub's max-partition rows of the op, or
        ``DEFAULT_PROBE_ROWS`` at its first boundary; clamped to
        256..``MAX_PROBE_ROWS``, a quarter of them distinct keys."""
        skew = self._skew_snapshot(opbase)
        rows = DEFAULT_PROBE_ROWS
        if skew is not None and skew.get("max_rows"):
            rows = int(skew["max_rows"])
        rows = max(256, min(int(rows), MAX_PROBE_ROWS))
        distinct = max(1, rows // 4)
        return rows, distinct, skew

    def _skew_snapshot(self, opbase: str) -> Optional[dict]:
        hub = self.hub
        if hub is None:
            return None
        with self._lock:
            hub_op = self._hub_alias.get(opbase, opbase)
        try:
            return hub.skew_of_op(hub_op)
        except Exception:  # noqa: BLE001
            return None

    def _run_probe(self, opbase: str, sig: tuple, rows: int,
                   distinct: int, nkeys: int, nvals: int, ops,
                   val_dtypes) -> dict:
        """Time the sort core against the hash core on a deterministic
        corpus of the op's shape (reference ``:406-486``): one warm-up
        call each, then ``PROBE_ITERS`` interleaved samples, the device
        synchronised before and after each (else the wall would be the
        enqueue). The hash core's overflow is recorded, not refused:
        its time stands, as in the reference."""
        from bigslice_tpu_torch.parallel import cuda_kernels, hashagg, segment

        ops = tuple(ops)
        device = self.device

        def cfn(a, b):
            out = []
            for op, x, y in zip(ops, a, b):
                if op == "add":
                    out.append(x + y)
                elif op == "max":
                    out.append(torch.maximum(x, y))
                else:
                    out.append(torch.minimum(x, y))
            return tuple(out)

        t0 = time.perf_counter()
        sort_core = segment.make_segmented_reduce_masked(nkeys, nvals, cfn)
        hash_core = hashagg.make_hash_combine(nkeys, nvals, ops)
        build_s = time.perf_counter() - t0

        rng = np.random.default_rng(0xB165)
        keys = tuple(
            torch.from_numpy(rng.integers(0, distinct, rows)
                             .astype(np.int32)).to(device)
            for _ in range(nkeys))
        vals = tuple(torch.ones(rows, dtype=getattr(torch, str(d)),
                                device=device) for d in val_dtypes)
        valid = torch.ones(rows, dtype=torch.bool, device=device)
        overflow: List[torch.Tensor] = []

        def run_sort():
            return sort_core(valid, keys, vals)

        def run_hash():
            m, k, v, ov = hash_core(valid, keys, vals)
            overflow.append(ov)
            return m, k, v, ov

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        # The probe's launches: the op's, under kind "kselect", never
        # its wave launches (a sink of our own even without a hub).
        dev = getattr(self.hub, "device", None) \
            if self.hub is not None else None
        inv = self.current_inv

        def sink(name, cost):
            if dev is not None:
                dev.record_launch(opbase, inv, name, cost, kind="kselect")

        progs = {"sort": run_sort, "hash": run_hash}
        if dev is not None and sig is not None:
            # Both candidates enter the program cache (reference
            # :455-466), purely structural (no user function): a second
            # selector of the process probing this op shape finds them
            # there, kind "kselect".
            from bigslice_tpu_torch.utils.devicetelemetry import serve_key

            arg_sig = (device.type,) + tuple(
                (str(t.dtype), tuple(t.shape)) for t in (valid,) + keys
                + vals)
            for name in progs:
                key_parts = (name,) + sig[1:]
                dev.probe_program(
                    opbase, inv, "kselect",
                    serve_key(opbase, "kselect", key_parts, ()), arg_sig,
                    ("kselect", key_parts), build_s / len(progs))
        samples: Dict[str, List[float]] = {n: [] for n in progs}
        with cuda_kernels.launch_sink(sink):
            for fn in progs.values():
                fn()  # warm-up
            sync()
            for _ in range(PROBE_ITERS):
                for name, fn in progs.items():
                    sync()
                    t0 = time.perf_counter()
                    fn()
                    sync()
                    samples[name].append(time.perf_counter() - t0)
        walls_ms = {n: round(float(np.median(s)) * 1e3, 4)
                    for n, s in samples.items()}
        winner = min(walls_ms, key=walls_ms.get)
        # The most rows one call could not place (the kernel's claims
        # race, so calls may differ).
        hash_overflow = max(int(o) for o in overflow)
        out = {
            "winner": winner,
            "walls_ms": walls_ms,
            "walls_all_ms": {n: [round(x * 1e3, 4) for x in s]
                             for n, s in samples.items()},
        }
        if hash_overflow:
            out["hash_overflow_rows"] = hash_overflow
        return out

    # -- the decision set and re-selection --------------------------------

    def token(self, opbase: str) -> tuple:
        """The op's live decisions, repr-stable (reference :488-499):
        folded into the executor's session-local program key and the
        cross-session serve digest, so that programs built under
        different selections never share an identity."""
        with self._lock:
            return tuple(sorted(
                (site, d["kernel"])
                for (op, site), d in self._decisions.items()
                if op == opbase
            ))

    def decision(self, opbase: str, site: str) -> Optional[str]:
        with self._lock:
            d = self._decisions.get((opbase, site))
            return None if d is None else d["kernel"]

    def forget(self, opbase: str) -> None:
        """Drop ``opbase``'s decisions, so that its next consult decides
        again: the executor calls it where a gate under a decision moves
        (a retracted dense bound, the hash table's overflow list), which
        a cached verdict would otherwise outlive."""
        with self._lock:
            for key in [k for k in self._decisions if k[0] == opbase]:
                del self._decisions[key]

    def observe_wave(self, opbase: str,
                     hub_op: Optional[str] = None) -> None:
        """The re-selection consult (reference ``:519-548``): when the
        op's per-partition profile has shifted by ``RESELECT_RATIO``
        against a decision's snapshot, drop the decision (and the
        probes), so that the op's next wave program decides again.
        ``hub_op`` is the hub's name for the op where it differs from
        ``opbase``."""
        if self.mode != "measured":
            return
        if hub_op is not None and hub_op != opbase:
            with self._lock:
                self._hub_alias[opbase] = hub_op
        now = self._skew_snapshot(opbase)
        if not now:
            return
        stale: List[Tuple[str, str]] = []
        with self._lock:
            for (op, site), d in self._decisions.items():
                if op != opbase:
                    continue
                if d["kernel"] not in ("hash", "sort"):
                    # Dense-bound and hash-ineligible verdicts are
                    # static facts: no shift changes them.
                    continue
                if self._shifted(d.get("skew"), now):
                    stale.append((op, site))
            for key in stale:
                del self._decisions[key]
            if stale:
                self._probes.clear()
        for op, site in stale:
            self.stats.record(
                "reselect", "measured:skew-shift", op=op, site=site,
                inv=self.current_inv, max_rows=now.get("max_rows"),
                total_rows=now.get("total_rows"))

    @staticmethod
    def _shifted(then: Optional[dict], now: dict) -> bool:
        if not then:
            # Decided before the op had a measured profile: the first
            # measurement is a shift.
            return bool(now.get("total_rows"))
        for field in ("max_rows", "total_rows"):
            a = float(then.get(field) or 0.0)
            b = float(now.get(field) or 0.0)
            if a <= 0 and b <= 0:
                continue
            lo, hi = min(a, b), max(a, b)
            if lo <= 0 or hi / lo >= RESELECT_RATIO:
                return True
        return False
