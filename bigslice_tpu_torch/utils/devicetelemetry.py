"""Device-plane telemetry: kernel launches and their declared cost,
builds, the program cache, HBM watermarks, donation effectiveness.

The telemetry hub carries this recorder as ``hub.device``:

1. **Kernel cost.** Torch has no counterpart of XLA's
   ``cost_analysis()``, so each hand-written kernel declares the bytes
   and operations of a launch from its arguments
   (``parallel/cuda_kernels.cost``). The wrapper reports every launch
   it counts into ``cuda_kernels.LAUNCHES`` to the op whose context it
   runs in (``cuda_kernels.launch_sink``), and this recorder sums the
   launches, declared bytes and operations per op and kernel;
   ``total_cost_bytes()`` is the running sum of the declared bytes of
   every launch it heard (the serving plane's cost gate reads it).
2. **Builds and programs.** The kernels' and ``native/``'s first-use
   builds (wall time, and whether the digest's ``.so`` was already
   built: a cache hit) are process-wide records read at summary time.
   The port compiles no wave program: a wave program is a Python
   closure that launches the kernels, rebuilt on every wave in
   microseconds, so ``summary()["compile"]`` stays empty. What the
   JAX package's program-cache accounting counts is kept per op and
   program kind (``record_program``, ``probe_program``): a program
   built after a miss (``program_builds``, with its build seconds), a
   hit in the executor's session-local table (``cache_hits``), and a
   hit in the process-wide tier (``cross_session_hits``,
   ``serve/programcache.py``): a program some earlier Session of the
   process built.
3. **HBM.** A per-wave watermark from the CUDA caching allocator
   (allocated, reserved and peak bytes, against the card's memory);
   where the device has no allocator (the CPU), the bytes of the
   tensors the executor holds stand in. ``hbm_budget()`` is the card's
   memory from ``torch.cuda.mem_get_info``: the spill planner's
   measured budget.
4. **Donation.** Bytes of the storages a wave owned against the
   bytes ``_donate`` freed (a storage its output still uses stays).

Every entry point is lock-protected, exception-safe and O(1).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

# Retained per-op records (iterative drivers mint fresh #N-suffixed
# ops each invocation).
MAX_OPS = 1024

# Per-wave HBM watermark samples retained for the summary (the rollup
# peak keeps accumulating past the bound).
MAX_HBM_SAMPLES = 256

def build_records() -> List[dict]:
    """The process's first-use builds: the CUDA kernel library and
    each native host kernel, with wall seconds and whether the digest's
    ``.so`` was already on disk (a cache hit)."""
    out: List[dict] = []
    try:
        from bigslice_tpu_torch.parallel import cuda_kernels

        out.extend(dict(b) for b in cuda_kernels.BUILDS)
    except Exception:  # noqa: BLE001 — telemetry never fails a run
        pass
    try:
        from bigslice_tpu_torch import native

        out.extend(dict(b) for b in native.BUILDS)
    except Exception:  # noqa: BLE001
        pass
    return out


def serve_key(op: str, kind: str, key_parts, fns, extra=None
              ) -> Optional[str]:
    """The cross-session digest of a program (``serve/programcache``,
    reference ``DeviceTelemetry.instrument``): None when ``fns`` is None
    (never shared), a function defeats fingerprinting, or the tier is
    off (``BIGSLICE_PROGRAM_CACHE=0``)."""
    if fns is None:
        return None
    try:
        from bigslice_tpu_torch.serve import programcache as pc

        if pc.cache_capacity() <= 0:
            return None
        fp = pc.fn_fingerprint(fns)
        if fp is None:
            return None
        return pc.serve_digest(op, kind, key_parts, extra, fp)
    except Exception:  # noqa: BLE001 — the cache is never a dependency
        return None


class _OpDeviceRecord:
    def __init__(self, inv: Optional[int] = None):
        self.inv = inv
        # wave programs: kind -> [built, session hits, cross-session
        # hits, build seconds]
        self.programs: Dict[str, List[float]] = {}
        # kernel launches: kernel -> [launches, bytes, flops]
        self.kernels: Dict[str, List[float]] = {}
        # the kernel selector's probe launches (kind "kselect"), kept
        # apart from the op's wave launches
        self.kselect_kernels: Dict[str, List[float]] = {}
        # donation effectiveness
        self.donation_expected_bytes = 0
        self.donation_aliased_bytes = 0
        self.donation_buffers = 0
        self.donation_aliased_buffers = 0
        # the shuffle's exchange: buckets x rows sent between slots, and
        # the backend that moved them (None on one slot: all local)
        self.exchange_waves = 0
        self.exchange_messages = 0
        self.exchange_bytes = 0
        self.exchange_backend: Optional[str] = None
        # the part of them on a 2-D mesh's DCN stage, and what one flat
        # exchange over the same grid would have sent across it
        self.dcn_messages = 0
        self.dcn_bytes = 0
        self.flat_dcn_messages = 0
        self.flat_dcn_bytes = 0
        # shuffle-plan attribution (exec/shuffleplan.py)
        self.plan_counts: Dict[str, int] = {}
        self.plan_reason = ""
        self.plan_est_bytes = 0
        self.plan_budget_bytes = 0
        self.spill_bytes = 0
        self.spill_rows = 0
        self.spill_partitions = 0
        self.spill_map_waves = 0

    @property
    def flops(self) -> float:
        return sum(k[2] for k in self.kernels.values())

    @property
    def bytes_accessed(self) -> float:
        return sum(k[1] for k in self.kernels.values())


class DeviceTelemetry:
    """The device-plane recorder the telemetry hub owns
    (``hub.device``)."""

    def __init__(self, eventer=None):
        self._lock = threading.Lock()
        self._ops: Dict[str, _OpDeviceRecord] = {}
        self._hbm: List[dict] = []
        self._hbm_peak_bytes = 0
        self._hbm_limit_bytes: Optional[int] = None
        self._hbm_source: Optional[str] = None
        self._eventer = eventer
        self.device = None
        # Declared bytes of every launch heard, monotonic (op records
        # may be evicted).
        self._cost_bytes_total = 0.0

    def set_device(self, device) -> None:
        """The executor's device: ``cuda`` samples its allocator and
        answers ``hbm_budget``."""
        self.device = device

    def _emit(self, name: str, **fields) -> None:
        ev = self._eventer
        if ev is None:
            return
        try:
            ev(name, **fields)
        except Exception:  # noqa: BLE001 — telemetry never fails a run
            pass

    def _op(self, op: str, inv: Optional[int]) -> _OpDeviceRecord:
        rec = self._ops.get(op)
        if rec is None:
            while len(self._ops) >= MAX_OPS:
                del self._ops[next(iter(self._ops))]
            rec = self._ops[op] = _OpDeviceRecord(inv)
        if rec.inv is None:
            rec.inv = inv
        return rec

    # -- kernel launches ----------------------------------------------------

    def record_launch(self, op: str, inv: Optional[int], kernel: str,
                      cost: Optional[dict] = None,
                      kind: Optional[str] = None) -> None:
        """One kernel launch attributed to ``op``, with the declared
        ``{"bytes", "flops"}`` of ``cuda_kernels.cost``. ``kind``
        ``"kselect"`` is a kernel selector's probe
        (``parallel/kernelselect.py``): summed apart, under
        ``summary()["kselect"]``, and in no total."""
        cost = cost or {}
        with self._lock:
            rec = self._op(op, inv)
            table = rec.kselect_kernels if kind == "kselect" else rec.kernels
            k = table.setdefault(kernel, [0, 0.0, 0.0])
            k[0] += 1
            k[1] += float(cost.get("bytes") or 0)
            k[2] += float(cost.get("flops") or 0)
            self._cost_bytes_total += float(cost.get("bytes") or 0)

    def total_cost_bytes(self) -> float:
        """The declared bytes of every launch this recorder heard, the
        probes' too (reference ``:673``, where it is the compiled
        programs' bytes-accessed): the serving plane's cost gate reads
        its delta over an invocation."""
        with self._lock:
            return self._cost_bytes_total

    # -- wave programs ------------------------------------------------------

    def record_program(self, op: str, inv: Optional[int], kind: str,
                       outcome: str, build_s: float = 0.0) -> None:
        """One wave program's first call at an argument signature
        (``built`` after a miss, ``cross_session`` from the process-wide
        tier) or a later one (``hit``, the session-local table)."""
        col = {"built": 0, "hit": 1, "cross_session": 2}[outcome]
        with self._lock:
            rec = self._op(op, inv)
            p = rec.programs.setdefault(kind, [0, 0, 0, 0.0])
            p[col] += 1
            if outcome == "built":
                p[3] += max(0.0, float(build_s))

    def probe_program(self, op: str, inv: Optional[int], kind: str,
                      key: Optional[str], sig: tuple, spec,
                      build_s: float) -> None:
        """A program's first call at ``sig`` in its executor: a hit in
        the process-wide tier when ``key`` (``serve_key``) is held
        there, else a build, published under ``key``."""
        outcome = "built"
        if key is not None:
            try:
                from bigslice_tpu_torch.serve.programcache import (
                    global_program_cache,
                )

                cache = global_program_cache()
                if cache.get(key, sig) is not None:
                    outcome = "cross_session"
                else:
                    cache.put(key, sig, spec, build_s)
            except Exception:  # noqa: BLE001 — never fails a run
                pass
        self.record_program(op, inv, kind, outcome, build_s)

    def cost_bytes(self, op: str) -> float:
        """The declared bytes of ``op``'s wave launches so far (the
        kernel selector's static evidence; 0 for an op with none)."""
        with self._lock:
            rec = self._ops.get(op)
            return rec.bytes_accessed if rec is not None else 0.0

    # -- HBM watermarks -----------------------------------------------------

    def sample_hbm(self, device=None, op: Optional[str] = None,
                   inv: Optional[int] = None, wave: Optional[int] = None,
                   live_bytes=None) -> Optional[dict]:
        """One device-memory watermark: the CUDA caching allocator's
        stats (``utils/resources.allocator_stats``) on ``cuda``, else
        ``live_bytes()`` (the bytes of the tensors the executor holds),
        the CPU's fallback. Returns the recorded sample; never
        raises."""
        from bigslice_tpu_torch.utils import resources

        device = device if device is not None else self.device
        try:
            stats = resources.allocator_stats(device) \
                if device is not None else None
            if stats:
                return self.record_hbm(
                    stats["bytes_in_use"], stats["peak_bytes_in_use"],
                    stats.get("bytes_limit"), source="memory_stats",
                    op=op, inv=inv, wave=wave,
                    reserved_bytes=stats.get("reserved_bytes"))
            in_use = int(live_bytes()) if live_bytes is not None else 0
            return self.record_hbm(in_use, in_use, None,
                                   source="live_tensors", op=op, inv=inv,
                                   wave=wave)
        except Exception:  # noqa: BLE001 — telemetry never fails a run
            return None

    def record_hbm(self, bytes_in_use: int, peak_bytes: int,
                   limit_bytes: Optional[int], source: str = "",
                   op: Optional[str] = None, inv: Optional[int] = None,
                   wave: Optional[int] = None,
                   reserved_bytes: Optional[int] = None) -> dict:
        sample = {
            "bytes_in_use": int(bytes_in_use),
            "peak_bytes": int(max(peak_bytes, bytes_in_use)),
        }
        if reserved_bytes is not None:
            sample["reserved_bytes"] = int(reserved_bytes)
        if op is not None:
            sample["op"] = op
        if wave is not None:
            sample["wave"] = int(wave)
        if limit_bytes:
            sample["limit_bytes"] = int(limit_bytes)
            sample["frac"] = round(
                sample["bytes_in_use"] / int(limit_bytes), 4
            )
        with self._lock:
            self._hbm_peak_bytes = max(self._hbm_peak_bytes,
                                       sample["peak_bytes"])
            if limit_bytes:
                self._hbm_limit_bytes = max(
                    self._hbm_limit_bytes or 0, int(limit_bytes)
                )
            if source:
                self._hbm_source = source
            self._hbm.append(sample)
            if len(self._hbm) > MAX_HBM_SAMPLES:
                del self._hbm[0]
        self._emit("bigslice:hbm", op=op, inv=inv, wave=wave,
                   bytes_in_use=sample["bytes_in_use"],
                   peak_bytes=sample["peak_bytes"],
                   reserved_bytes=sample.get("reserved_bytes"),
                   limit_bytes=sample.get("limit_bytes"),
                   frac=sample.get("frac"))
        return sample

    def hbm_peak_bytes(self) -> int:
        with self._lock:
            return self._hbm_peak_bytes

    def hbm_budget(self) -> Optional[int]:
        """The card's memory (``torch.cuda.mem_get_info``'s total) when
        the recorder's device is ``cuda``, else the largest limit a
        sample observed; None when neither is known (the CPU): the
        ``auto`` shuffle planner's budget when no knob is set."""
        import torch

        device = self.device
        if device is not None and torch.device(device).type == "cuda":
            try:
                _, total = torch.cuda.mem_get_info(device)
                return int(total)
            except Exception:  # noqa: BLE001
                pass
        with self._lock:
            return self._hbm_limit_bytes

    # -- donation effectiveness -----------------------------------------------

    def record_donation(self, op: str, inv: Optional[int],
                        expected_bytes: int, aliased_bytes: int,
                        buffers: int = 0,
                        aliased_buffers: int = 0) -> None:
        """One wave's donation outcome: bytes of the owned staged
        inputs ``_donate`` was to free, against bytes the caching
        allocator got back (its allocated bytes before and after)."""
        with self._lock:
            rec = self._op(op, inv)
            rec.donation_expected_bytes += max(0, int(expected_bytes))
            rec.donation_aliased_bytes += max(0, int(aliased_bytes))
            rec.donation_buffers += max(0, int(buffers))
            rec.donation_aliased_buffers += max(0, int(aliased_buffers))
        self._emit("bigslice:donation", op=op, inv=inv,
                   expected_bytes=int(expected_bytes),
                   aliased_bytes=int(aliased_bytes))

    # -- exchange attribution -------------------------------------------------

    def record_exchange(self, op: str, inv: Optional[int],
                        wave: Optional[int], messages: int = 0,
                        nbytes: int = 0,
                        backend: Optional[str] = None,
                        dcn_messages: int = 0, dcn_bytes: int = 0,
                        flat_dcn_messages: int = 0,
                        flat_dcn_bytes: int = 0) -> None:
        """One wave's exchange: buckets and their bytes (bucket
        capacity times row bytes, valid rows or padding), and the
        process group's backend that moved them (None on one slot, where
        the exchange is the identity seam and every byte stays local).
        On a 2-D mesh ``dcn_*`` is the part of them its DCN stage moved
        (the rest rode ICI), and ``flat_dcn_*`` what one flat exchange
        over the same grid would have sent across DCN."""
        with self._lock:
            rec = self._op(op, inv)
            rec.exchange_waves += 1
            rec.exchange_messages += max(0, int(messages))
            rec.exchange_bytes += max(0, int(nbytes))
            rec.dcn_messages += max(0, int(dcn_messages))
            rec.dcn_bytes += max(0, int(dcn_bytes))
            rec.flat_dcn_messages += max(0, int(flat_dcn_messages))
            rec.flat_dcn_bytes += max(0, int(flat_dcn_bytes))
            if backend is not None:
                rec.exchange_backend = backend
        self._emit("bigslice:exchange", op=op, inv=inv, wave=wave,
                   messages=int(messages), bytes=int(nbytes))

    # -- shuffle-plan attribution -------------------------------------------

    def record_shuffle_plan(self, op: str, inv: Optional[int],
                            plan: str, reason: str = "",
                            est_bytes: Optional[int] = None,
                            budget_bytes: Optional[int] = None,
                            spill_bytes: int = 0, spill_rows: int = 0,
                            partitions: int = 0,
                            map_waves: int = 0) -> None:
        """One shuffle boundary's exchange decision
        (``exec/shuffleplan.py``): ``in_program`` or ``spill``, why, and
        what a spilled exchange wrote."""
        with self._lock:
            rec = self._op(op, inv)
            rec.plan_counts[plan] = rec.plan_counts.get(plan, 0) + 1
            rec.plan_reason = reason
            if est_bytes:
                rec.plan_est_bytes = max(rec.plan_est_bytes,
                                         int(est_bytes))
            if budget_bytes:
                rec.plan_budget_bytes = int(budget_bytes)
            rec.spill_bytes += max(0, int(spill_bytes))
            rec.spill_rows += max(0, int(spill_rows))
            rec.spill_partitions += max(0, int(partitions))
            if map_waves:
                rec.spill_map_waves = int(map_waves)
        self._emit("bigslice:spill", op=op, inv=inv, plan=plan,
                   reason=reason, est_bytes=est_bytes,
                   budget_bytes=budget_bytes,
                   spill_bytes=int(spill_bytes),
                   spill_rows=int(spill_rows),
                   partitions=int(partitions),
                   map_waves=int(map_waves))

    # -- queries ----------------------------------------------------------

    def status_line(self) -> Optional[str]:
        """The live ``hbm %`` annotation of the status display, with a
        spill tail when the spill exchange ran."""
        with self._lock:
            if not self._hbm:
                return None
            cur = self._hbm[-1]
            peak = self._hbm_peak_bytes
            limit = self._hbm_limit_bytes
            spill = sum(r.spill_bytes for r in self._ops.values())
        tail = f", spilled {spill / 1e6:.0f}MB" if spill else ""
        mb = cur["bytes_in_use"] / 1e6
        if limit:
            return (f"  hbm {100.0 * cur['bytes_in_use'] / limit:.0f}%"
                    f" in use ({mb:.0f}MB,"
                    f" peak {100.0 * peak / limit:.0f}%{tail})")
        return (f"  device mem {mb:.0f}MB in use (no allocator "
                f"limit{tail})")

    def snapshot(self) -> dict:
        """The device plane's mergeable snapshot (the ``device`` section
        of ``TelemetryHub.snapshot()``, reference
        utils/devicetelemetry.py:869): flat per-op counters that add
        across ranks, under the JAX package's names (``compiles``,
        ``cache_hits`` and ``cross_session_hits`` count this package's
        wave programs built, found in the session's table and in the
        process-wide tier; ``compile_s`` their build seconds; ``flops``
        and ``bytes_accessed`` the kernels' declared work), and the HBM
        watermark, which merges by max."""
        with self._lock:
            ops: Dict[str, dict] = {}
            for op, rec in self._ops.items():
                progs = list(rec.programs.values())
                ops[op] = {
                    "inv": rec.inv,
                    "compiles": int(sum(p[0] for p in progs)),
                    "cache_hits": int(sum(p[1] + p[2] for p in progs)),
                    "cross_session_hits": int(sum(p[2] for p in progs)),
                    "fallbacks": 0,
                    "compile_s": float(sum(p[3] for p in progs)),
                    "flops": rec.flops,
                    "bytes_accessed": rec.bytes_accessed,
                    "donation_expected_bytes": rec.donation_expected_bytes,
                    "donation_aliased_bytes": rec.donation_aliased_bytes,
                    "donation_buffers": rec.donation_buffers,
                    "donation_aliased_buffers":
                        rec.donation_aliased_buffers,
                    "exchange_waves": rec.exchange_waves,
                    "dcn_messages": rec.dcn_messages,
                    "dcn_bytes": rec.dcn_bytes,
                    "ici_messages": rec.exchange_messages - rec.dcn_messages,
                    "ici_bytes": rec.exchange_bytes - rec.dcn_bytes,
                    "flat_dcn_messages": rec.flat_dcn_messages,
                    "flat_dcn_bytes": rec.flat_dcn_bytes,
                    "plan_counts": dict(rec.plan_counts),
                    "spill_bytes": rec.spill_bytes,
                    "spill_rows": rec.spill_rows,
                    "spill_partitions": rec.spill_partitions,
                }
            hbm: dict = {"peak_bytes": self._hbm_peak_bytes,
                         "samples": len(self._hbm)}
            if self._hbm_limit_bytes:
                hbm["limit_bytes"] = self._hbm_limit_bytes
            if self._hbm_source:
                hbm["source"] = self._hbm_source
        return {"ops": ops, "hbm": hbm}

    def summary(self) -> dict:
        """The ``telemetry_summary()["device"]`` payload."""
        with self._lock:
            kernels = {}
            kselect = {}
            tot_launches = 0
            tot_flops = tot_bytes = 0.0
            donation = {}
            don_expected = don_aliased = 0
            shuffle_plan: dict = {}
            sp_tot: dict = {"spill_bytes": 0, "spill_rows": 0,
                            "spill_partitions": 0,
                            "spill_boundaries": 0,
                            "in_program_boundaries": 0}
            exchange = {}
            ex_tot = {"exchange_messages": 0, "exchange_bytes": 0}
            programs = {}
            pr_tot = [0, 0, 0, 0.0]
            for op, rec in self._ops.items():
                if rec.programs:
                    programs[op] = {
                        kind: {"built": int(p[0]), "hits": int(p[1]),
                               "cross_session_hits": int(p[2]),
                               "build_s": round(p[3], 6)}
                        for kind, p in sorted(rec.programs.items())
                    }
                    for p in rec.programs.values():
                        for i in range(4):
                            pr_tot[i] += p[i]
                if rec.kernels:
                    kernels[op] = {
                        name: {"launches": int(k[0]), "bytes": k[1],
                               "flops": k[2]}
                        for name, k in sorted(rec.kernels.items())
                    }
                    tot_launches += sum(int(k[0])
                                        for k in rec.kernels.values())
                    tot_bytes += rec.bytes_accessed
                    tot_flops += rec.flops
                if rec.kselect_kernels:
                    kselect[op] = {
                        name: {"launches": int(k[0]), "bytes": k[1],
                               "flops": k[2]}
                        for name, k in sorted(rec.kselect_kernels.items())
                    }
                if rec.donation_buffers:
                    eff = (rec.donation_aliased_bytes
                           / rec.donation_expected_bytes
                           if rec.donation_expected_bytes else 0.0)
                    donation[op] = {
                        "expected_bytes": rec.donation_expected_bytes,
                        "aliased_bytes": rec.donation_aliased_bytes,
                        "buffers": rec.donation_buffers,
                        "aliased_buffers": rec.donation_aliased_buffers,
                        "effectiveness": round(eff, 4),
                    }
                    don_expected += rec.donation_expected_bytes
                    don_aliased += rec.donation_aliased_bytes
                if rec.plan_counts:
                    entry = {
                        "plans": dict(rec.plan_counts),
                        "reason": rec.plan_reason,
                    }
                    if rec.plan_est_bytes:
                        entry["est_bytes"] = rec.plan_est_bytes
                    if rec.plan_budget_bytes:
                        entry["budget_bytes"] = rec.plan_budget_bytes
                    if rec.spill_bytes or rec.plan_counts.get("spill"):
                        entry.update({
                            "spill_bytes": rec.spill_bytes,
                            "spill_rows": rec.spill_rows,
                            "partitions": rec.spill_partitions,
                            "map_waves": rec.spill_map_waves,
                        })
                        op_hbm = [s["bytes_in_use"] for s in self._hbm
                                  if s.get("op") == op]
                        if op_hbm:
                            entry["max_wave_hbm_bytes"] = max(op_hbm)
                    shuffle_plan[op] = entry
                    sp_tot["spill_bytes"] += rec.spill_bytes
                    sp_tot["spill_rows"] += rec.spill_rows
                    sp_tot["spill_partitions"] += rec.spill_partitions
                    sp_tot["spill_boundaries"] += \
                        rec.plan_counts.get("spill", 0)
                    sp_tot["in_program_boundaries"] += \
                        rec.plan_counts.get("in_program", 0)
                    if rec.plan_budget_bytes:
                        sp_tot["budget_bytes"] = max(
                            sp_tot.get("budget_bytes", 0),
                            rec.plan_budget_bytes,
                        )
                if rec.exchange_waves:
                    exchange[op] = {
                        "waves": rec.exchange_waves,
                        "messages": rec.exchange_messages,
                        "bytes": rec.exchange_bytes,
                    }
                    if rec.exchange_backend is not None:
                        exchange[op]["exchange_backend"] = \
                            rec.exchange_backend
                    ex_tot["exchange_messages"] += rec.exchange_messages
                    ex_tot["exchange_bytes"] += rec.exchange_bytes
            hbm: dict = {}
            if self._hbm:
                hbm = {
                    "samples": len(self._hbm),
                    "source": self._hbm_source,
                    "current_bytes": self._hbm[-1]["bytes_in_use"],
                    "peak_bytes": self._hbm_peak_bytes,
                    "per_wave": list(self._hbm[-32:]),
                }
                if "reserved_bytes" in self._hbm[-1]:
                    hbm["reserved_bytes"] = self._hbm[-1]["reserved_bytes"]
                if self._hbm_limit_bytes:
                    hbm["limit_bytes"] = self._hbm_limit_bytes
                    hbm["peak_frac"] = round(
                        self._hbm_peak_bytes / self._hbm_limit_bytes, 4
                    )
            peak = self._hbm_peak_bytes
        totals = {
            "launches": tot_launches,
            "flops": tot_flops,
            "bytes_accessed": tot_bytes,
            "hbm_peak_bytes": peak,
            "donation_effectiveness": round(
                don_aliased / don_expected, 4
            ) if don_expected else None,
            # The wave programs (the JAX package's compiles, cache_hits
            # and cross_session_hits): built after a miss, session-local
            # hits, process-wide hits.
            "program_builds": int(pr_tot[0]),
            "cache_hits": int(pr_tot[1]),
            "cross_session_hits": int(pr_tot[2]),
            "program_build_s": round(pr_tot[3], 6),
        }
        if exchange:
            totals.update(ex_tot)
        splan: dict = {}
        if shuffle_plan:
            splan = {"ops": shuffle_plan, "totals": dict(sp_tot)}
            splan["totals"]["hbm_peak_bytes"] = peak
            if sp_tot.get("budget_bytes"):
                splan["totals"]["within_budget"] = bool(
                    peak <= sp_tot["budget_bytes"])
        out = {
            # The JAX package's per-op program compiles: none in the
            # port, which builds kernels (``builds``), not programs.
            "compile": {},
            "kernels": kernels,
            "builds": build_records(),
            "programs": programs,
            "hbm": hbm,
            "donation": donation,
            "exchange": exchange,
            "shuffle_plan": splan,
            "totals": totals,
        }
        if kselect:
            # A kernel selector's probes (BIGSLICE_KERNEL_SELECT=measured).
            out["kselect"] = kselect
        return out

    def prometheus_lines(self, metric, line) -> None:
        """Append this recorder's counters and gauges through the hub's
        Prometheus helpers (``metric(name, help, type)``, ``line(name,
        labels, value)``)."""
        with self._lock:
            ops = dict(self._ops)
            hbm_last = self._hbm[-1] if self._hbm else None
            hbm_peak = self._hbm_peak_bytes
            hbm_limit = self._hbm_limit_bytes
        metric("bigslice_kernel_launches_total",
               "Hand-written kernel launches per op and kernel.",
               "counter")
        metric("bigslice_kernel_bytes_total",
               "Declared bytes of kernel launches per op and kernel.",
               "counter")
        metric("bigslice_kernel_flops_total",
               "Declared operations of kernel launches per op and kernel.",
               "counter")
        for op, rec in ops.items():
            for name, k in sorted(rec.kernels.items()):
                labels = {"op": op, "kernel": name}
                line("bigslice_kernel_launches_total", labels, int(k[0]))
                line("bigslice_kernel_bytes_total", labels, f"{k[1]:.0f}")
                line("bigslice_kernel_flops_total", labels, f"{k[2]:.0f}")
        metric("bigslice_donation_bytes_total",
               "Wave-input bytes donated (expected) and given back to "
               "the caching allocator (aliased).", "counter")
        for op, rec in ops.items():
            if rec.donation_buffers:
                line("bigslice_donation_bytes_total",
                     {"op": op, "kind": "expected"},
                     rec.donation_expected_bytes)
                line("bigslice_donation_bytes_total",
                     {"op": op, "kind": "aliased"},
                     rec.donation_aliased_bytes)
        metric("bigslice_exchange_bytes_total",
               "Exchange bucket bytes per op.", "counter")
        for op, rec in ops.items():
            if rec.exchange_waves:
                line("bigslice_exchange_bytes_total", {"op": op},
                     rec.exchange_bytes)
        if any(rec.plan_counts for rec in ops.values()):
            metric("bigslice_shuffle_plan_total",
                   "Shuffle-boundary exchange decisions per op "
                   "(in_program or spill).", "counter")
            metric("bigslice_shuffle_spill_bytes_total",
                   "Bytes written through the spill exchange per op.",
                   "counter")
            for op, rec in ops.items():
                for plan, n in sorted(rec.plan_counts.items()):
                    line("bigslice_shuffle_plan_total",
                         {"op": op, "plan": plan}, n)
                if rec.spill_bytes:
                    line("bigslice_shuffle_spill_bytes_total",
                         {"op": op}, rec.spill_bytes)
        if hbm_last is not None:
            metric("bigslice_hbm_bytes",
                   "Device-memory watermark (the CUDA caching "
                   "allocator; the executor's tensors on the CPU).",
                   "gauge")
            line("bigslice_hbm_bytes", {"kind": "in_use"},
                 hbm_last["bytes_in_use"])
            line("bigslice_hbm_bytes", {"kind": "peak"}, hbm_peak)
            if "reserved_bytes" in hbm_last:
                line("bigslice_hbm_bytes", {"kind": "reserved"},
                     hbm_last["reserved_bytes"])
            if hbm_limit:
                line("bigslice_hbm_bytes", {"kind": "limit"}, hbm_limit)
