"""The fleet telemetry plane: rank-tagged snapshots, merged through a
store (reference utils/fleettelemetry.py; this package's copy, since the
port imports nothing of the JAX package).

The hub (``utils/telemetry.py``) and the device recorder
(``utils/devicetelemetry.py``) aggregate in process-local state, and
over ``torch.distributed`` ranks each rank sees its own slots only. This
module is the post-hoc merge:

1. **Mergeable snapshots**: ``TelemetryHub.snapshot()`` and
   ``DeviceTelemetry.snapshot()`` export every signal family in a
   serializable, rank-tagged form whose fields merge without loss:
   counters add, per-partition vectors add elementwise, maxima take the
   max, and task durations ride *fixed-bin histograms*
   (``DUR_BUCKETS_S``), so that a merged quantile is within one bin of
   the raw-sample value (``hist_quantile``).
2. **Store-mediated exchange**: each rank's ``FleetExporter`` writes its
   snapshot through a ``FileStore`` (any fsspec URL) periodically and at
   every run's end; rank 0 reads every rank's file and merges. No
   collective and no sync on the hot path.
3. **Fleet rendering**: ``merge_snapshots`` gives the
   ``telemetry_summary(scope="fleet")`` payload (per-op skew,
   stragglers, waves, programs and exchange, the fleet rollup and each
   rank's part), and ``prometheus_fleet_text`` renders rank-labelled
   ``bigslice_*{rank=...}`` series for ``/debug/fleet``.

The device section's ``compiles``, ``cache_hits`` and
``cross_session_hits`` count this package's wave programs (built, found
in the session's table, found in the process-wide tier), as the device
recorder's summary does; the exchange splits its bytes by axis: ``dcn``
for the 2-D mesh's second stage, ``ici`` for the rest (a 1-D mesh is all
``ici``).

Knobs (read lazily; unset, nothing is exported and no file is written;
``BIGSLICE_TELEMETRY=0`` turns the hub off and every snapshot with it):

- ``BIGSLICE_FLEET_DIR``: the store URL prefix of the export (also
  ``Session(fleet_dir=)``).
- ``BIGSLICE_FLEET_EXPORT_S``: the periodic export's interval in
  seconds (default 10; <= 0 turns the thread off: the run-end and
  shutdown exports still happen).
- ``BIGSLICE_FLEET_WAIT_S``: how long rank 0 waits for its peers' files
  before it merges what exists (default 5).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

# Fixed duration-histogram bin upper edges (seconds), log-spaced from
# sub-millisecond tasks to multi-minute stragglers. Fixed bins are the
# mergeability contract: two ranks' histograms merge by elementwise
# add, and any quantile estimated from the merged counts is within one
# bin of the exact value — the acceptance bound the fleet summary
# carries. Changing these invalidates cross-version merges; bump the
# snapshot ``schema`` field if you must.
DUR_BUCKETS_S = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 180.0, 600.0,
)

SNAPSHOT_SCHEMA = 1

# Deterministic per-rank artifact names under the store prefix: rank 0
# (and offline consumers) probe these directly — no listing API needed
# on the store, which keeps the seam as thin as partition reads.
SNAP_NAME = "telemetry-rank{rank:05d}.json"
FLIGHT_NAME = "flightrec-rank{rank:05d}.json"
MERGED_NAME = "fleet.json"
POSTMORTEM_NAME = "postmortem.json"

# Bounds on merged list-valued fields (stragglers ride along verbatim,
# rank-tagged; a fleet of pathological ops must not balloon the merged
# doc).
MAX_MERGED_STRAGGLERS = 64

_OP_SUM_KEYS = (
    "boundaries", "rows_hist_sum", "rows_hist_count", "staging_s",
    "exposed_s", "compute_s", "staged_waves",
)
_DEV_SUM_KEYS = (
    "compiles", "cache_hits", "cross_session_hits", "fallbacks",
    "compile_s", "flops", "bytes_accessed",
    "donation_expected_bytes", "donation_aliased_bytes",
    "donation_buffers", "donation_aliased_buffers",
    "exchange_waves", "dcn_messages", "dcn_bytes", "ici_messages",
    "ici_bytes", "flat_dcn_messages", "flat_dcn_bytes",
    "spill_bytes", "spill_rows", "spill_partitions",
)


def process_rank() -> int:
    """This process's rank (0 without a process group: a plain session is
    rank 0 of a fleet of one)."""
    from bigslice_tpu_torch.utils import distributed

    try:
        return int(distributed.process_index())
    except Exception:  # noqa: BLE001
        return 0


def process_count() -> int:
    from bigslice_tpu_torch.utils import distributed

    try:
        return int(distributed.process_count())
    except Exception:  # noqa: BLE001
        return 1


# -- fixed-bin duration histograms ----------------------------------------


def duration_hist(durations) -> dict:
    """A raw duration sample list as a fixed-bin mergeable histogram
    (the snapshot replacement for the hub's process-local quantile
    lists)."""
    buckets = [0] * (len(DUR_BUCKETS_S) + 1)
    total = 0.0
    mx = 0.0
    n = 0
    for d in durations or ():
        d = max(0.0, float(d))
        total += d
        if d > mx:
            mx = d
        n += 1
        for i, le in enumerate(DUR_BUCKETS_S):
            if d <= le:
                buckets[i] += 1
                break
        else:
            buckets[-1] += 1
    return {"buckets": buckets, "sum": round(total, 9), "count": n,
            "max": round(mx, 9)}


def merge_hist(a: Optional[dict], b: Optional[dict]) -> dict:
    """Elementwise histogram merge — the whole point of fixed bins."""
    a = a or duration_hist(())
    b = b or duration_hist(())
    nb = len(DUR_BUCKETS_S) + 1
    ab = list(a.get("buckets") or [])[:nb]
    bb = list(b.get("buckets") or [])[:nb]
    ab += [0] * (nb - len(ab))
    bb += [0] * (nb - len(bb))
    return {
        "buckets": [x + y for x, y in zip(ab, bb)],
        "sum": float(a.get("sum") or 0.0) + float(b.get("sum") or 0.0),
        "count": int(a.get("count") or 0) + int(b.get("count") or 0),
        "max": max(float(a.get("max") or 0.0),
                   float(b.get("max") or 0.0)),
    }


def hist_quantile(h: Optional[dict], p: float) -> float:
    """Quantile estimated from a fixed-bin histogram by linear
    interpolation within the target bin. Error bound: the true
    quantile lies in the same bin as the returned value, so the
    estimate is within one bin width — the fleet-vs-single-process
    equivalence bound."""
    if not h:
        return 0.0
    count = int(h.get("count") or 0)
    if count <= 0:
        return 0.0
    mx = float(h.get("max") or 0.0)
    target = max(0.0, min(1.0, float(p))) * (count - 1) + 1.0
    buckets = h.get("buckets") or []
    cum = 0.0
    lo = 0.0
    for i, le in enumerate(DUR_BUCKETS_S):
        c = buckets[i] if i < len(buckets) else 0
        if c and cum + c >= target:
            frac = (target - cum) / c
            return min(lo + (le - lo) * frac, mx if mx > 0 else le)
        cum += c
        lo = le
    return mx if mx > 0 else lo


def hist_stats(h: Optional[dict]) -> dict:
    """The summary()-shaped per-op ``tasks`` rollup from a merged
    histogram (p50/p90 within one bin of the raw-sample values)."""
    h = h or duration_hist(())
    return {
        "n": int(h.get("count") or 0),
        "p50_s": round(hist_quantile(h, 0.5), 6),
        "p90_s": round(hist_quantile(h, 0.9), 6),
        "max_s": round(float(h.get("max") or 0.0), 6),
        "total_s": round(float(h.get("sum") or 0.0), 6),
    }


def _add_vec(dst: List[int], src) -> List[int]:
    src = [int(v) for v in (src or ())]
    if len(dst) < len(src):
        dst.extend([0] * (len(src) - len(dst)))
    for i, v in enumerate(src):
        dst[i] += v
    return dst


def _add_map(dst: Dict[str, float], src: Optional[dict]) -> None:
    for k, v in (src or {}).items():
        try:
            dst[k] = dst.get(k, 0) + v
        except TypeError:
            pass


# -- the fleet merge ------------------------------------------------------


def merge_snapshots(snaps: List[dict],
                    skew_ratio: Optional[float] = None,
                    skew_min_rows: Optional[int] = None) -> dict:
    """Merge N rank-tagged snapshots into the
    ``telemetry_summary(scope="fleet")`` payload: the same shape the
    single-process ``summary()`` produces (per-op tasks / stragglers /
    skew / waves sections, device plane, rollups) plus per-rank
    attribution (``per_rank``, rank-tagged stragglers,
    ``skew.per_rank_rows``). Counters add, vectors add elementwise,
    maxima take max, quantiles come from the merged fixed-bin
    histograms; the skew ratio/flag is recomputed from the merged
    partition vector — each rank only saw its addressable slice, so
    only the merged vector carries the true fleet skew."""
    from bigslice_tpu_torch.utils import telemetry as telemetry_mod

    if skew_ratio is None:
        skew_ratio = telemetry_mod.DEFAULT_SKEW_RATIO
    if skew_min_rows is None:
        skew_min_rows = telemetry_mod.DEFAULT_SKEW_MIN_ROWS

    snaps = [s for s in (snaps or []) if isinstance(s, dict)]
    ranks = sorted({int(s.get("rank") or 0) for s in snaps})
    nranks = max(
        [int(s.get("nranks") or 1) for s in snaps] + [len(ranks), 1]
    )

    # -- host plane: per-op accumulation across ranks ------------------
    acc: Dict[str, dict] = {}
    states: Dict[str, int] = {}
    per_rank: Dict[str, dict] = {}
    rec_recovered: Dict[str, int] = {}
    rec_fatal: Dict[str, int] = {}
    rec_lat = duration_hist(())
    rec_pending = 0
    drain_timeouts = 0
    for s in snaps:
        rank = int(s.get("rank") or 0)
        for op, o in (s.get("ops") or {}).items():
            a = acc.setdefault(op, {
                "inv": o.get("inv"),
                "durations": duration_hist(()),
                "stragglers": [],
                "part_rows": [], "part_bytes": [],
                "rows_hist": [], "phase_counts": {},
                "stage_phases": {}, "max_wave": -1,
                "per_rank_rows": {},
                **{k: 0 for k in _OP_SUM_KEYS},
            })
            if a["inv"] is None:
                a["inv"] = o.get("inv")
            a["durations"] = merge_hist(a["durations"],
                                        o.get("durations"))
            for st in (o.get("stragglers") or ())[:16]:
                if len(a["stragglers"]) < MAX_MERGED_STRAGGLERS:
                    tagged = dict(st)
                    tagged.setdefault("rank", rank)
                    a["stragglers"].append(tagged)
            _add_vec(a["part_rows"], o.get("part_rows"))
            _add_vec(a["part_bytes"], o.get("part_bytes"))
            _add_vec(a["rows_hist"], o.get("rows_hist"))
            contributed = sum(int(v) for v in (o.get("part_rows")
                                               or ()))
            if contributed:
                a["per_rank_rows"][str(rank)] = (
                    a["per_rank_rows"].get(str(rank), 0) + contributed
                )
            for k in _OP_SUM_KEYS:
                a[k] += o.get(k) or 0
            a["max_wave"] = max(a["max_wave"],
                                int(o.get("max_wave", -1)))
            _add_map(a["phase_counts"], o.get("phase_counts"))
            _add_map(a["stage_phases"], o.get("stage_phases"))
        _add_map(states, s.get("task_states"))
        rec = s.get("recovery") or {}
        _add_map(rec_recovered, rec.get("recovered"))
        _add_map(rec_fatal, rec.get("fatal"))
        rec_lat = merge_hist(rec_lat, rec.get("latency"))
        rec_pending += int(rec.get("pending") or 0)
        drain_timeouts += int(s.get("drain_timeouts") or 0)
        pr = {
            "ts": s.get("ts"),
            "ops": len(s.get("ops") or {}),
            "task_states": dict(s.get("task_states") or {}),
        }
        dev = s.get("device") or {}
        dev_ops = dev.get("ops") or {}
        pr["compiles"] = sum(int(o.get("compiles") or 0)
                             for o in dev_ops.values())
        pr["cache_hits"] = sum(int(o.get("cache_hits") or 0)
                               for o in dev_ops.values())
        pr["exchange_messages"] = sum(
            int(o.get("dcn_messages") or 0)
            + int(o.get("ici_messages") or 0)
            for o in dev_ops.values()
        )
        pr["hbm_peak_bytes"] = int(
            (dev.get("hbm") or {}).get("peak_bytes") or 0
        )
        per_rank[str(rank)] = pr

    # -- render per-op summary-shaped entries --------------------------
    ops: Dict[str, dict] = {}
    flagged_ops: List[str] = []
    straggler_total = 0
    total_staging = total_hidden = 0.0
    for op, a in acc.items():
        entry: dict = {"inv": a["inv"]}
        if a["durations"]["count"]:
            entry["tasks"] = hist_stats(a["durations"])
            entry["tasks"]["hist"] = a["durations"]
        if a["stragglers"]:
            entry["stragglers"] = list(a["stragglers"])
            straggler_total += len(a["stragglers"])
        if a["part_rows"]:
            ratio, max_shard, median, total = \
                telemetry_mod.TelemetryHub._skew_of(a["part_rows"])
            flagged = (total >= skew_min_rows and ratio >= skew_ratio)
            entry["skew"] = {
                "rows": list(a["part_rows"]),
                "bytes": list(a["part_bytes"]),
                "total_rows": total,
                "median_rows": median,
                "ratio": round(ratio, 3),
                "max_shard": max_shard,
                "flagged": flagged,
                "boundaries": a["boundaries"],
                "per_rank_rows": dict(a["per_rank_rows"]),
            }
            if flagged:
                flagged_ops.append(op)
        if a["staged_waves"] or a["max_wave"] >= 0:
            hidden = max(0.0, a["staging_s"] - a["exposed_s"])
            eff = (hidden / a["staging_s"]
                   if a["staging_s"] > 0 else 0.0)
            entry["waves"] = {
                "n_waves": a["max_wave"] + 1,
                "staged": a["staged_waves"],
                "staging_s": round(a["staging_s"], 6),
                "exposed_s": round(a["exposed_s"], 6),
                "hidden_s": round(hidden, 6),
                "compute_s": round(a["compute_s"], 6),
                "overlap_efficiency": round(eff, 4),
                "phases": {k: int(v)
                           for k, v in a["phase_counts"].items()},
            }
            if a["stage_phases"]:
                entry["waves"]["staging_breakdown"] = {
                    k: round(v, 6) for k, v in a["stage_phases"].items()
                }
            total_staging += a["staging_s"]
            total_hidden += hidden
        ops[op] = entry

    out = {
        "scope": "fleet",
        "nranks": nranks,
        "ranks": ranks,
        "merged_from": len(snaps),
        "ops": ops,
        "task_states": {k: int(v) for k, v in states.items()},
        "skew_flagged_ops": sorted(flagged_ops),
        "straggler_total": straggler_total,
        "overlap_efficiency": round(
            total_hidden / total_staging, 4
        ) if total_staging > 0 else None,
        "per_rank": per_rank,
    }
    if rec_recovered or rec_fatal or rec_pending:
        out["recovery"] = {
            "recovered": {k: int(v) for k, v in rec_recovered.items()},
            "fatal": {k: int(v) for k, v in rec_fatal.items()},
            "recovered_total": int(sum(rec_recovered.values())),
            "fatal_total": int(sum(rec_fatal.values())),
            "pending": rec_pending,
            "latency": hist_stats(rec_lat) if rec_lat["count"] else None,
        }
    if drain_timeouts:
        out["drain"] = {"timeouts": drain_timeouts}
    out["device"] = _merge_device(snaps)
    return out


def _merge_device(snaps: List[dict]) -> dict:
    """The device plane's fleet merge: per-op counters add across
    ranks (each rank compiled / exchanged / sampled its own slice of
    the gang), HBM watermarks take the fleet max with per-rank
    attribution."""
    ops: Dict[str, dict] = {}
    hbm_peak = 0
    hbm_limit = 0
    hbm_per_rank: Dict[str, int] = {}
    sources = set()
    for s in snaps:
        rank = int(s.get("rank") or 0)
        dev = s.get("device") or {}
        for op, o in (dev.get("ops") or {}).items():
            a = ops.setdefault(op, {
                "inv": o.get("inv"), "plan_counts": {},
                **{k: 0 for k in _DEV_SUM_KEYS},
            })
            if a["inv"] is None:
                a["inv"] = o.get("inv")
            for k in _DEV_SUM_KEYS:
                a[k] += o.get(k) or 0
            _add_map(a["plan_counts"], o.get("plan_counts"))
        hbm = dev.get("hbm") or {}
        peak = int(hbm.get("peak_bytes") or 0)
        if peak:
            hbm_per_rank[str(rank)] = max(
                hbm_per_rank.get(str(rank), 0), peak
            )
        hbm_peak = max(hbm_peak, peak)
        hbm_limit = max(hbm_limit, int(hbm.get("limit_bytes") or 0))
        if hbm.get("source"):
            sources.add(str(hbm["source"]))

    compile_ops = {}
    exchange = {}
    totals = {k: 0 for k in _DEV_SUM_KEYS}
    for op, a in ops.items():
        for k in _DEV_SUM_KEYS:
            totals[k] += a[k]
        if a["compiles"] or a["cache_hits"] or a["fallbacks"]:
            compile_ops[op] = {
                "inv": a["inv"],
                "compiles": int(a["compiles"]),
                "cache_hits": int(a["cache_hits"]),
                "cross_session_hits": int(a["cross_session_hits"]),
                "fallbacks": int(a["fallbacks"]),
                "compile_s": round(float(a["compile_s"]), 6),
                "flops": a["flops"],
                "bytes_accessed": a["bytes_accessed"],
            }
        if a["exchange_waves"]:
            entry = {
                "waves": int(a["exchange_waves"]),
                "dcn_messages": int(a["dcn_messages"]),
                "dcn_bytes": int(a["dcn_bytes"]),
                "ici_messages": int(a["ici_messages"]),
                "ici_bytes": int(a["ici_bytes"]),
            }
            if a["flat_dcn_messages"]:
                entry["flat_dcn_messages"] = int(a["flat_dcn_messages"])
                entry["flat_dcn_bytes"] = int(a["flat_dcn_bytes"])
            exchange[op] = entry
    out = {
        "compile": compile_ops,
        "exchange": exchange,
        "hbm": {
            "peak_bytes": hbm_peak,
            "per_rank": hbm_per_rank,
        },
        "totals": {
            "compiles": int(totals["compiles"]),
            "cache_hits": int(totals["cache_hits"]),
            "cross_session_hits": int(totals["cross_session_hits"]),
            "fallbacks": int(totals["fallbacks"]),
            "compile_s": round(float(totals["compile_s"]), 6),
            "flops": totals["flops"],
            "bytes_accessed": totals["bytes_accessed"],
            "dcn_messages": int(totals["dcn_messages"]),
            "dcn_bytes": int(totals["dcn_bytes"]),
            "ici_messages": int(totals["ici_messages"]),
            "ici_bytes": int(totals["ici_bytes"]),
            "spill_bytes": int(totals["spill_bytes"]),
            "hbm_peak_bytes": hbm_peak,
        },
    }
    if hbm_limit:
        out["hbm"]["limit_bytes"] = hbm_limit
    if sources:
        out["hbm"]["source"] = sorted(sources)
    return out


# -- rank-labelled Prometheus export --------------------------------------


def prometheus_fleet_text(snaps: List[dict]) -> str:
    """Rank-labelled ``bigslice_*{rank=...}`` series from N rank
    snapshots — the scrape surface of ``/debug/fleet?format=prom``.
    Same exposition conventions as the hub's ``prometheus_text()``;
    every sample carries the originating rank so fleet dashboards can
    slice per host."""
    from bigslice_tpu_torch.utils.telemetry import _escape_label

    out: List[str] = []

    def metric(name, help_, type_):
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {type_}")

    def line(name, labels, value):
        lab = ",".join(
            f'{k}="{_escape_label(v)}"' for k, v in labels.items()
        )
        out.append(f"{name}{{{lab}}} {value}" if lab
                   else f"{name} {value}")

    snaps = sorted(
        (s for s in (snaps or []) if isinstance(s, dict)),
        key=lambda s: int(s.get("rank") or 0),
    )
    metric("bigslice_fleet_ranks",
           "Ranks whose telemetry snapshot was merged.", "gauge")
    line("bigslice_fleet_ranks", {}, len(snaps))

    metric("bigslice_task_state_total",
           "Task state transitions observed, by rank and state.",
           "counter")
    for s in snaps:
        r = int(s.get("rank") or 0)
        for st, n in sorted((s.get("task_states") or {}).items()):
            line("bigslice_task_state_total",
                 {"rank": r, "state": st}, int(n))

    metric("bigslice_task_duration_seconds",
           "Completed task durations per rank (fixed-bin merged "
           "histogram).", "histogram")
    for s in snaps:
        r = int(s.get("rank") or 0)
        h = duration_hist(())
        for o in (s.get("ops") or {}).values():
            h = merge_hist(h, o.get("durations"))
        if not h["count"]:
            continue
        cum = 0
        for i, le in enumerate(DUR_BUCKETS_S):
            cum += h["buckets"][i]
            line("bigslice_task_duration_seconds_bucket",
                 {"rank": r, "le": repr(le)}, cum)
        cum += h["buckets"][-1]
        line("bigslice_task_duration_seconds_bucket",
             {"rank": r, "le": "+Inf"}, cum)
        line("bigslice_task_duration_seconds_sum", {"rank": r},
             f"{h['sum']:.6f}")
        line("bigslice_task_duration_seconds_count", {"rank": r},
             h["count"])

    metric("bigslice_op_straggler_total",
           "Straggler-flagged tasks per rank and op.", "counter")
    metric("bigslice_shuffle_partition_rows_sum",
           "Rows this rank observed at its addressable shuffle "
           "partitions.", "counter")
    for s in snaps:
        r = int(s.get("rank") or 0)
        for op, o in sorted((s.get("ops") or {}).items()):
            if o.get("stragglers"):
                line("bigslice_op_straggler_total",
                     {"rank": r, "op": op}, len(o["stragglers"]))
            rows = sum(int(v) for v in (o.get("part_rows") or ()))
            if rows:
                line("bigslice_shuffle_partition_rows_sum",
                     {"rank": r, "op": op}, rows)

    metric("bigslice_compile_total",
           "XLA compilations / instrumented-cache hits per rank and "
           "op.", "counter")
    metric("bigslice_exchange_messages_total",
           "Collective-exchange messages per rank and axis kind.",
           "counter")
    metric("bigslice_hbm_bytes",
           "Device-memory peak watermark per rank.", "gauge")
    for s in snaps:
        r = int(s.get("rank") or 0)
        dev = s.get("device") or {}
        for op, o in sorted((dev.get("ops") or {}).items()):
            if o.get("compiles"):
                line("bigslice_compile_total",
                     {"rank": r, "op": op, "result": "compile"},
                     int(o["compiles"]))
            if o.get("cache_hits"):
                line("bigslice_compile_total",
                     {"rank": r, "op": op, "result": "cache_hit"},
                     int(o["cache_hits"]))
            if o.get("fallbacks"):
                line("bigslice_compile_total",
                     {"rank": r, "op": op, "result": "fallback"},
                     int(o["fallbacks"]))
            for axis, key in (("dcn", "dcn_messages"),
                              ("ici", "ici_messages")):
                if o.get(key):
                    line("bigslice_exchange_messages_total",
                         {"rank": r, "op": op, "axis": axis},
                         int(o[key]))
        peak = int((dev.get("hbm") or {}).get("peak_bytes") or 0)
        if peak:
            line("bigslice_hbm_bytes", {"rank": r, "kind": "peak"},
                 peak)
    out.append("")
    return "\n".join(out)


# -- store-mediated export / pull -----------------------------------------


def _aux_store(url: str):
    from bigslice_tpu_torch.exec.store import FileStore

    return FileStore(url)


def load_snapshots(url: str, max_ranks: int = 4096) -> List[dict]:
    """Pull every rank's snapshot from a store prefix — offline (no
    live session; the ``obsdump --fleet`` path). Probes deterministic
    rank names, widening to each snapshot's declared ``nranks`` so a
    missing rank 0 doesn't hide the rest."""
    store = _aux_store(url)
    snaps: List[dict] = []
    declared = 1
    misses = 0
    r = 0
    while r < max_ranks and (r < declared or misses < 2):
        data = store.get_aux(SNAP_NAME.format(rank=r))
        if data is None:
            misses += 1
        else:
            misses = 0
            try:
                s = json.loads(data)
                if isinstance(s, dict):
                    snaps.append(s)
                    declared = max(declared,
                                   int(s.get("nranks") or 1))
            except Exception:
                pass
        r += 1
    return snaps


class FleetExporter:
    """One rank's snapshot exporter + (on rank 0) the fleet puller.

    Owned by the Session when a fleet dir is configured and telemetry
    is on. Writes ``telemetry-rank<r>.json`` under the store prefix
    periodically (daemon thread), at every run end, and at shutdown;
    never raises into the run (telemetry must never break it). Rank 0
    additionally merges all ranks' files into ``fleet.json`` at close
    and collates per-rank flight-recorder dumps into
    ``postmortem.json`` on fatal outcomes."""

    def __init__(self, hub, url: str, rank: Optional[int] = None,
                 nranks: Optional[int] = None,
                 period_s: Optional[float] = None):
        self.hub = hub
        self.url = str(url)
        self.rank = process_rank() if rank is None else int(rank)
        self.nranks = process_count() if nranks is None \
            else int(nranks)
        if period_s is None:
            try:
                period_s = float(
                    os.environ.get("BIGSLICE_FLEET_EXPORT_S", "10")
                )
            except ValueError:
                period_s = 10.0
        self.period_s = period_s
        self._store = _aux_store(self.url)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    @staticmethod
    def _wait_s() -> float:
        try:
            return float(os.environ.get("BIGSLICE_FLEET_WAIT_S", "5"))
        except ValueError:
            return 5.0

    def start(self) -> None:
        """Spawn the periodic export thread (no-op when the period
        knob is <= 0 — run-end and shutdown exports still happen)."""
        if self.period_s <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="fleet-export"
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.export()
            except Exception:  # telemetry must never break the run
                pass

    def export(self) -> Optional[dict]:
        """Write this rank's current snapshot (atomic rename — readers
        never see a partial file). Returns the snapshot doc."""
        try:
            doc = self.hub.snapshot(rank=self.rank,
                                    nranks=self.nranks)
            data = json.dumps(doc, default=str).encode()
            self._store.put_aux(SNAP_NAME.format(rank=self.rank),
                                data)
            return doc
        except Exception:
            return None

    def pull(self, wait_for_all: bool = False,
             timeout_s: Optional[float] = None) -> List[dict]:
        """Read every rank's snapshot file; this rank's entry is
        replaced by a live snapshot (its file may lag a period).
        ``wait_for_all`` blocks (bounded) until all ``nranks`` files
        exist — the shutdown merge path."""
        if timeout_s is None:
            timeout_s = self._wait_s()
        expect = max(self.nranks, 1)
        deadline = time.monotonic() + max(0.0, timeout_s)
        while True:
            snaps: Dict[int, dict] = {}
            for r in range(expect):
                if r == self.rank:
                    continue
                try:
                    data = self._store.get_aux(
                        SNAP_NAME.format(rank=r)
                    )
                    if data is not None:
                        s = json.loads(data)
                        if isinstance(s, dict):
                            snaps[r] = s
                except Exception:
                    pass
            try:
                snaps[self.rank] = self.hub.snapshot(
                    rank=self.rank, nranks=self.nranks
                )
            except Exception:
                pass
            if (not wait_for_all or len(snaps) >= expect
                    or time.monotonic() >= deadline):
                return [snaps[r] for r in sorted(snaps)]
            time.sleep(0.1)

    def fleet_summary(self, wait_for_all: bool = False) -> dict:
        """Pull + merge: the ``telemetry_summary(scope='fleet')``
        payload. Works on every rank (any rank may be asked; rank 0
        is the conventional merger)."""
        return merge_snapshots(self.pull(wait_for_all=wait_for_all))

    # -- flight-recorder collation (the post-mortem bundle) ------------

    def export_flight(self, doc: dict) -> None:
        """Push this rank's flight-recorder doc through the store so
        the coordinator can collate a multihost failure into one
        bundle."""
        try:
            data = json.dumps(doc, default=str).encode()
            self._store.put_aux(FLIGHT_NAME.format(rank=self.rank),
                                data)
        except Exception:
            pass

    def collate_flights(self,
                        wait_s: Optional[float] = None
                        ) -> Optional[str]:
        """Coordinator-only: gather every rank's flight dump (bounded
        wait for slow peers) into one ``postmortem.json`` bundle under
        the store prefix — the one coherent artifact a multihost
        failure leaves behind. Returns the bundle's aux name, or None
        (non-coordinator / nothing found / write failed)."""
        if self.rank != 0:
            return None
        if wait_s is None:
            wait_s = self._wait_s()
        expect = max(self.nranks, 1)
        deadline = time.monotonic() + max(0.0, wait_s)
        by_rank: Dict[str, dict] = {}
        while True:
            for r in range(expect):
                key = str(r)
                if key in by_rank:
                    continue
                try:
                    data = self._store.get_aux(
                        FLIGHT_NAME.format(rank=r)
                    )
                    if data is not None:
                        by_rank[key] = json.loads(data)
                except Exception:
                    pass
            if len(by_rank) >= expect or time.monotonic() >= deadline:
                break
            time.sleep(0.1)
        if not by_rank:
            return None
        bundle = {
            "schema": SNAPSHOT_SCHEMA,
            "nranks": self.nranks,
            "ranks_collected": sorted(by_rank, key=int),
            "ts": time.time(),
            "by_rank": by_rank,
        }
        try:
            self._store.put_aux(
                POSTMORTEM_NAME,
                json.dumps(bundle, default=str).encode(),
            )
        except Exception:
            return None
        # Mirror the bundle beside the local flight dumps too (when a
        # dump dir is configured) so the operator's post-mortem
        # directory is self-contained.
        try:
            from bigslice_tpu_torch.utils.telemetry import TelemetryHub

            dirname = TelemetryHub.flightrec_dir()
            if dirname:
                os.makedirs(dirname, exist_ok=True)
                with open(os.path.join(dirname, POSTMORTEM_NAME),
                          "w") as fp:
                    json.dump(bundle, fp, indent=1, default=str)
        except Exception:
            pass
        return POSTMORTEM_NAME

    def close(self) -> None:
        """Final export; rank 0 also waits (bounded) for peer files
        and writes the merged ``fleet.json`` beside them."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        self.export()
        if self.rank == 0:
            try:
                merged = merge_snapshots(self.pull(wait_for_all=True))
                self._store.put_aux(
                    MERGED_NAME,
                    json.dumps(merged, default=str).encode(),
                )
            except Exception:
                pass
