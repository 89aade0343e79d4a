"""Offline trace analyzer (cmd/slicetrace analog).

A copy of the JAX package's ``tools/slicetrace.py``: it reads only the
trace file, with the standard library and this package's telemetry hub
(``TelemetryHub._skew_of`` and ``STAGE_PHASES``), so the same report
comes from a trace of either package.

Reads a session's Chrome trace file (``Session(trace_path=...)``) and
prints, per invocation, the reference's report sections
(cmd/slicetrace/main.go:100-160, session.go:20-180):

- ``invN:summary`` — caller location and stringified run args (from
  the ``bigslice:invocation:N`` instant the session records);
- ``invN:slice`` — per op: shard count, start offset, wall span
  (first task start → last task end);
- ``invN:task:quartile`` — per-task duration min/q1/q2/q3/max and
  total;

plus the telemetry-hub sections (utils/telemetry.py):

- ``invN:straggler`` — per op, tasks whose duration exceeded
  STRAGGLER_FACTOR × the op's median (computed from the task events
  themselves, so any trace — including pre-hub ones — renders it);
- ``invN:skew`` — per-op shuffle-boundary per-shard row totals,
  max/median ratio and the hot shard (from ``bigslice:shuffleSizes``
  instants the hub records);
- ``invN:overlap`` — per-op wave-pipeline accounting: staging time,
  the compute-exposed part, the prefetch-hidden part, and the overlap
  efficiency percentage (from ``bigslice:waveStaging`` /
  ``bigslice:waveRun`` instants);
- ``invN:staging`` — the staging-breakdown companion: per op, where
  staging time went (read / decode / assemble / upload — the staging
  fast path's stages, exec/staging.py). Rendered only for traces whose
  staging instants carry the breakdown fields.
- ``invN:recovery`` — per op × attributed fault site, lost tasks the
  recovery ladder brought back and the loss→OK latency (from
  ``bigslice:taskRecovered`` instants; the chaos plane's replayable
  recovery evidence, utils/faultinject.py + tools/chaosslice.py);
- ``invN:compile`` — per op, XLA compilations vs instrumented-cache
  hits, compile wall time, and the cost-analysis FLOPs / bytes
  accessed (from ``bigslice:compile`` instants — the JAX package's
  compile attribution). This package compiles no wave program and
  emits no such instant, so the section renders only for traces that
  carry them (a JAX package session's);
- ``invN:kernels`` — the kernel selector's decisions, per op and site:
  the lowering, its reason and its evidence (``bigslice:kernel_select``
  instants, parallel/kernelselect.py, ``BIGSLICE_KERNEL_SELECT``);
- ``invN:device`` — per-wave HBM watermarks (allocator stats, or the
  live-array fallback on CPU meshes) and per-op donation
  effectiveness (``bigslice:hbm`` / ``bigslice:donation`` instants).
- ``invN:exchange`` — per-op collective-exchange messages/bytes split
  by interconnect axis kind (dcn vs ici, plus the flat-exchange DCN
  counterfactual; ``bigslice:exchange`` instants — the 2-D DCN × ICI
  hierarchy's measured traffic-reduction column).

Traces from older sessions (no ``inv`` task args) fall back to one
flat all-ops quartile table.

``--merge`` joins N per-rank trace files (one per SPMD process; the
fleet plane's ``trace-rank<r>.json`` convention) into ONE correlated
timeline: each rank is a lane, invocations are matched across files by
the correlation id their ``bigslice:invocation:N`` instants carry
(minted once per serve request — identical on every rank by the
same-driver contract), and the per-rank shuffle/compile/exchange
contributions render side by side with a fleet rollup. Rank identity
comes from the ``bigslice:sessionStart`` instant's ``rank`` field,
falling back to a ``rank<k>`` filename component, then file order.

Usage: python -m bigslice_tpu_torch.tools.slicetrace TRACE.json
       python -m bigslice_tpu_torch.tools.slicetrace --merge R0.json R1.json ...
"""

from __future__ import annotations

import json
import os
import re
import sys
from typing import Dict, List

# Straggler flagging threshold for the offline report — mirrors the
# live hub's default (utils/telemetry.py DEFAULT_STRAGGLER_FACTOR).
STRAGGLER_FACTOR = 3.0
STRAGGLER_MIN_SIBLINGS = 3


def quartiles(xs: List[float]):
    xs = sorted(xs)
    n = len(xs)

    def q(p: float) -> float:
        if n == 1:
            return xs[0]
        i = p * (n - 1)
        lo = int(i)
        hi = min(lo + 1, n - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (i - lo)

    return xs[0], q(0.25), q(0.5), q(0.75), xs[-1]


def _op_rows(tasks: List[dict]):
    """Aggregate task events (one per run) into per-op rows, ordered by
    first start."""
    by_op: Dict[str, List[dict]] = {}
    for ev in tasks:
        by_op.setdefault(ev["name"], []).append(ev)
    rows = []
    for op, evs in by_op.items():
        durs = [e["dur"] / 1e3 for e in evs]
        start = min(e["ts"] for e in evs) / 1e3
        end = max(e["ts"] + e["dur"] for e in evs) / 1e3
        shards = max(
            (e.get("args", {}).get("shards", 0) for e in evs), default=0
        )
        rows.append({
            "op": op, "n": len(evs), "shards": shards, "start": start,
            "span": end - start, "durs": durs,
        })
    rows.sort(key=lambda r: r["start"])
    return rows


def _print_inv(out: List[str], inv, summary: dict, tasks: List[dict],
               telem: Dict[str, List[dict]] = None):
    telem = telem or {}
    out.append(f"# inv{inv}:summary")
    out.append(f"  location  {summary.get('location', '?')}")
    if summary.get("args"):
        out.append(f"  args      {summary['args']}")
    rows = _op_rows(tasks)
    out.append(f"# inv{inv}:slice")
    out.append(f"  {'op':<28} {'shards':>6} {'start_ms':>10} "
               f"{'span_ms':>10}")
    for r in rows:
        out.append(f"  {r['op'][:28]:<28} {r['shards']:>6} "
                   f"{r['start']:>10.2f} {r['span']:>10.2f}")
    out.append(f"# inv{inv}:task:quartile")
    out.append(f"  {'op':<28} {'n':>5} {'min_ms':>9} {'q1_ms':>9} "
               f"{'med_ms':>9} {'q3_ms':>9} {'max_ms':>9} {'total_ms':>10}")
    for r in rows:
        mn, q1, q2, q3, mx = quartiles(r["durs"])
        out.append(
            f"  {r['op'][:28]:<28} {r['n']:>5} {mn:>9.2f} {q1:>9.2f} "
            f"{q2:>9.2f} {q3:>9.2f} {mx:>9.2f} {sum(r['durs']):>10.2f}"
        )
    _print_straggler(out, inv, rows, tasks)
    _print_skew(out, inv, telem.get("skew", ()))
    _print_overlap(out, inv, telem.get("staging", ()),
                   telem.get("runs", ()))
    _print_recovery(out, inv, telem.get("recovery", ()))
    _print_compile(out, inv, telem.get("compile", ()))
    _print_device(out, inv, telem.get("hbm", ()),
                  telem.get("donation", ()))
    _print_exchange(out, inv, telem.get("exchange", ()))
    _print_spill(out, inv, telem.get("spill", ()))
    _print_adaptive(out, inv, telem.get("adaptive", ()))
    _print_kernels(out, inv, telem.get("kernels", ()))
    _print_coded(out, inv, telem.get("coded", ()))
    out.append("")


def _print_straggler(out: List[str], inv, rows, tasks: List[dict]):
    """Tasks whose duration exceeded STRAGGLER_FACTOR x their op's
    median — recomputed from the task events, so every trace renders
    this section."""
    out.append(f"# inv{inv}:straggler "
               f"(task > {STRAGGLER_FACTOR:g}x op median)")
    out.append(f"  {'op':<28} {'n':>5} {'med_ms':>9} {'max_ms':>9}  "
               f"flagged")
    for r in rows:
        if len(r["durs"]) < STRAGGLER_MIN_SIBLINGS + 1:
            continue
        _, _, med, _, mx = quartiles(r["durs"])
        flagged = [
            ev for ev in tasks
            if ev["name"] == r["op"]
            and ev["dur"] / 1e3 > STRAGGLER_FACTOR * med
        ]
        names = ", ".join(
            f"shard {ev.get('args', {}).get('shard', '?')} "
            f"({ev['dur'] / 1e3:.1f}ms)"
            for ev in flagged[:4]
        ) or "-"
        out.append(f"  {r['op'][:28]:<28} {len(r['durs']):>5} "
                   f"{med:>9.2f} {mx:>9.2f}  {names}")


def _print_skew(out: List[str], inv, events):
    """Per-op shuffle-boundary skew from bigslice:shuffleSizes instants
    (the LAST instant per op carries the accumulated totals)."""
    last: Dict[str, dict] = {}
    for ev in events:
        a = ev.get("args", {})
        if a.get("op"):
            last[a["op"]] = a
    if not last:
        return
    out.append(f"# inv{inv}:skew (per-shard rows at shuffle "
               f"boundaries, max/median)")
    out.append(f"  {'op':<28} {'rows':>10} {'max':>9} {'median':>9} "
               f"{'ratio':>7} {'hot':>4}  flagged")
    for op, a in sorted(last.items()):
        out.append(
            f"  {op[:28]:<28} {a.get('total_rows', 0):>10} "
            f"{a.get('max_rows', 0):>9} {a.get('median_rows', 0):>9.0f} "
            f"{a.get('ratio', 0):>7.2f} {a.get('max_shard', -1):>4}  "
            f"{'YES' if a.get('flagged') else 'no'}"
        )


# Staging-breakdown phases a waveStaging instant may carry — derived
# from the hub's single source of truth (telemetry emits each "<k>_s"
# accumulator as a "<k>_ms" instant field).
from bigslice_tpu_torch.utils.telemetry import TelemetryHub

STAGE_PHASES = tuple(k[:-2] + "_ms" for k in TelemetryHub.STAGE_PHASES)


def _print_overlap(out: List[str], inv, staging, runs):
    """Per-op wave-pipeline accounting from bigslice:waveStaging /
    bigslice:waveRun instants: how much staging the prefetcher hid,
    and (when the staging fast path recorded it) WHERE the staging
    time went — the read/decode/assemble/upload breakdown."""
    agg: Dict[str, dict] = {}
    for ev in staging:
        a = ev.get("args", {})
        d = agg.setdefault(a.get("op", "?"), {
            "waves": 0, "ms": 0.0, "exposed_ms": 0.0, "compute_ms": 0.0,
            **{p: 0.0 for p in STAGE_PHASES},
        })
        d["waves"] += 1
        d["ms"] += a.get("ms", 0.0)
        d["exposed_ms"] += a.get("exposed_ms", 0.0)
        for p in STAGE_PHASES:
            d[p] += a.get(p, 0.0) or 0.0
    for ev in runs:
        a = ev.get("args", {})
        if a.get("op") in agg:
            agg[a["op"]]["compute_ms"] += a.get("ms", 0.0)
    if not agg:
        return
    out.append(f"# inv{inv}:overlap (wave staging hidden by prefetch)")
    out.append(f"  {'op':<28} {'waves':>5} {'stage_ms':>9} "
               f"{'expos_ms':>9} {'hide_ms':>9} {'comp_ms':>9} "
               f"{'overlap':>8}")
    for op, d in sorted(agg.items()):
        hidden = max(0.0, d["ms"] - d["exposed_ms"])
        eff = hidden / d["ms"] if d["ms"] > 0 else 0.0
        out.append(
            f"  {op[:28]:<28} {d['waves']:>5} {d['ms']:>9.2f} "
            f"{d['exposed_ms']:>9.2f} {hidden:>9.2f} "
            f"{d['compute_ms']:>9.2f} {eff:>7.1%}"
        )
    if not any(any(d[p] for p in STAGE_PHASES)
               for d in agg.values()):
        return  # pre-fast-path trace: no breakdown to render
    out.append(f"# inv{inv}:staging (where staging time went)")
    out.append(f"  {'op':<28} {'read_ms':>9} {'decode_ms':>10} "
               f"{'assemb_ms':>10} {'upload_ms':>10}")
    for op, d in sorted(agg.items()):
        if not any(d[p] for p in STAGE_PHASES):
            continue
        out.append(
            f"  {op[:28]:<28} {d['read_ms']:>9.2f} "
            f"{d['decode_ms']:>10.2f} {d['assemble_ms']:>10.2f} "
            f"{d['upload_ms']:>10.2f}"
        )


def _print_recovery(out: List[str], inv, events):
    """Recovery-ladder section from bigslice:taskRecovered instants:
    per op × attributed fault site, how many lost tasks came back and
    how long loss→OK took (the chaos plane's recovery evidence,
    utils/faultinject.py)."""
    agg: Dict[tuple, List[float]] = {}
    for ev in events:
        a = ev.get("args", {})
        key = (a.get("op", "?"), a.get("site", "organic"))
        agg.setdefault(key, []).append(
            float(a.get("latency_s", 0.0)) * 1e3
        )
    if not agg:
        return
    out.append(f"# inv{inv}:recovery (lost tasks recovered, by "
               f"attributed fault site)")
    out.append(f"  {'op':<28} {'site':<18} {'n':>4} {'med_ms':>9} "
               f"{'max_ms':>9}")
    for (op, site), lats in sorted(agg.items()):
        _, _, med, _, mx = quartiles(lats)
        out.append(
            f"  {op[:28]:<28} {site[:18]:<18} {len(lats):>4} "
            f"{med:>9.2f} {mx:>9.2f}"
        )


def _print_compile(out: List[str], inv, events):
    """Device-plane compile attribution from bigslice:compile instants
    (utils/devicetelemetry.py): per op, how many XLA compilations, the
    wall time they cost, and the cost-analysis totals."""
    agg: Dict[str, dict] = {}
    for ev in events:
        a = ev.get("args", {})
        d = agg.setdefault(a.get("op", "?"), {
            "n": 0, "ms": 0.0, "flops": 0.0, "bytes": 0.0,
            "kinds": set(),
        })
        d["n"] += 1
        d["ms"] += a.get("ms", 0.0) or 0.0
        d["flops"] += a.get("flops", 0.0) or 0.0
        d["bytes"] += a.get("bytes_accessed", 0.0) or 0.0
        if a.get("kind"):
            d["kinds"].add(a["kind"])
    if not agg:
        return
    out.append(f"# inv{inv}:compile (XLA compilations, cost analysis)")
    out.append(f"  {'op':<28} {'n':>4} {'wall_ms':>10} {'mflops':>9} "
               f"{'MB_acc':>8}  kinds")
    for op, d in sorted(agg.items()):
        out.append(
            f"  {op[:28]:<28} {d['n']:>4} {d['ms']:>10.1f} "
            f"{d['flops'] / 1e6:>9.2f} {d['bytes'] / 1e6:>8.2f}  "
            f"{','.join(sorted(d['kinds'])) or '-'}"
        )


def _print_device(out: List[str], inv, hbm, donation):
    """Per-wave HBM watermarks and donation effectiveness from
    bigslice:hbm / bigslice:donation instants."""
    if hbm:
        out.append(f"# inv{inv}:device (per-wave HBM watermark)")
        out.append(f"  {'op':<28} {'wave':>4} {'in_use_MB':>10} "
                   f"{'peak_MB':>8} {'of_limit':>8}")
        for ev in hbm[-16:]:
            a = ev.get("args", {})
            frac = a.get("frac")
            # A group's closing sample carries wave None: shown as -1,
            # as a sample without the field is.
            wave = a.get("wave")
            out.append(
                f"  {str(a.get('op', '?'))[:28]:<28} "
                f"{-1 if wave is None else wave:>4} "
                f"{(a.get('bytes_in_use', 0) or 0) / 1e6:>10.1f} "
                f"{(a.get('peak_bytes', 0) or 0) / 1e6:>8.1f} "
                f"{format(frac, '>7.1%') if frac is not None else '      ?'}"
            )
    if donation:
        agg: Dict[str, List[float]] = {}
        for ev in donation:
            a = ev.get("args", {})
            d = agg.setdefault(a.get("op", "?"), [0.0, 0.0])
            d[0] += a.get("expected_bytes", 0) or 0
            d[1] += a.get("aliased_bytes", 0) or 0
        out.append(f"# inv{inv}:device:donation (donated vs aliased)")
        out.append(f"  {'op':<28} {'donated_MB':>11} {'aliased_MB':>11} "
                   f"{'eff':>6}")
        for op, (exp, ali) in sorted(agg.items()):
            eff = ali / exp if exp else 0.0
            out.append(f"  {op[:28]:<28} {exp / 1e6:>11.2f} "
                       f"{ali / 1e6:>11.2f} {eff:>5.1%}")


def _print_exchange(out: List[str], inv, events):
    """Per-op collective-exchange attribution split by interconnect
    axis kind, from bigslice:exchange instants (the 2-D DCN × ICI
    hierarchy's measured DCN-traffic column; flat_dcn is the
    1-stage-exchange counterfactual over the same topology)."""
    agg: Dict[str, dict] = {}
    for ev in events:
        a = ev.get("args", {})
        d = agg.setdefault(a.get("op", "?"), {
            "waves": 0, "dcn_m": 0, "dcn_b": 0, "ici_m": 0,
            "ici_b": 0, "flat_m": 0,
        })
        d["waves"] += 1
        d["dcn_m"] += a.get("dcn_messages", 0) or 0
        d["dcn_b"] += a.get("dcn_bytes", 0) or 0
        d["ici_m"] += a.get("ici_messages", 0) or 0
        d["ici_b"] += a.get("ici_bytes", 0) or 0
        d["flat_m"] += a.get("flat_dcn_messages", 0) or 0
    if not agg:
        return
    out.append(f"# inv{inv}:exchange (collective messages by axis kind)")
    out.append(f"  {'op':<28} {'waves':>5} {'dcn_msg':>8} "
               f"{'dcn_MB':>8} {'ici_msg':>8} {'ici_MB':>8} "
               f"{'vs_flat':>8}")
    for op, d in sorted(agg.items()):
        red = (f"{d['flat_m'] / d['dcn_m']:.1f}x"
               if d["dcn_m"] and d["flat_m"] else "-")
        out.append(
            f"  {op[:28]:<28} {d['waves']:>5} {d['dcn_m']:>8} "
            f"{d['dcn_b'] / 1e6:>8.2f} {d['ici_m']:>8} "
            f"{d['ici_b'] / 1e6:>8.2f} {red:>8}"
        )


def _print_spill(out: List[str], inv, events):
    """Per-boundary shuffle-plan decisions from bigslice:spill
    instants (exec/shuffleplan.py): the chosen exchange, the
    estimate-vs-budget evidence, and what the store-mediated spill
    path moved (bytes, partitions, map waves → reduce sub-waves)."""
    if not events:
        return
    out.append(f"# inv{inv}:spill (shuffle plan / out-of-core spill)")
    out.append(f"  {'op':<28} {'plan':>10} {'est_MB':>8} "
               f"{'budget_MB':>9} {'spill_MB':>9} {'parts':>6} "
               f"{'waves':>5} {'subw':>5}  reason")
    for ev in events[-16:]:
        a = ev.get("args", {})

        def mb(v):
            return f"{(v or 0) / 1e6:.1f}" if v else "-"

        out.append(
            f"  {str(a.get('op', '?'))[:28]:<28} "
            f"{str(a.get('plan', '?')):>10} "
            f"{mb(a.get('est_bytes')):>8} "
            f"{mb(a.get('budget_bytes')):>9} "
            f"{mb(a.get('spill_bytes')):>9} "
            f"{a.get('partitions', 0):>6} "
            f"{a.get('map_waves', 0):>5} "
            f"{a.get('sub_waves', 0):>5}  {a.get('reason', '')}"
        )


def _print_adaptive(out: List[str], inv, events):
    """Adaptive-loop decisions from bigslice:adaptive instants
    (exec/adaptive.py): which policy fired, what it did, and the
    measured evidence it acted on — absent entirely when
    BIGSLICE_ADAPTIVE is off (the planner never emits)."""
    if not events:
        return
    out.append(f"# inv{inv}:adaptive (telemetry-driven decisions)")
    out.append(f"  {'policy':<6} {'action':<14} {'target':<28} "
               f"evidence")
    for ev in events[-24:]:
        a = dict(ev.get("args", {}))
        policy = str(a.pop("policy", "?"))
        action = str(a.pop("action", "?"))
        target = str(a.pop("op", None) or a.pop("task", None)
                     or a.pop("pipeline", None) or "-")
        a.pop("inv", None)
        evidence = " ".join(
            f"{k}={a[k]}" for k in sorted(a)
        ) or "-"
        out.append(f"  {policy:<6} {action:<14} {target[:28]:<28} "
                   f"{evidence}")


def _print_coded(out: List[str], inv, events):
    """Coded-plane lifecycle from bigslice:coded instants
    (exec/codedplan.py): group sizing, coverage settles, straggler
    cancellations and masked duplicate reads — absent entirely when
    BIGSLICE_CODED is unset (the planner never attaches)."""
    if not events:
        return
    out.append(f"# inv{inv}:coded (k-of-n coverage events)")
    out.append(f"  {'action':<14} {'op':<28} detail")
    for ev in events[-24:]:
        a = dict(ev.get("args", {}))
        action = str(a.pop("action", "?"))
        op = str(a.pop("op", None) or "-")
        a.pop("inv", None)
        detail = " ".join(f"{k}={a[k]}" for k in sorted(a)) or "-"
        out.append(f"  {action:<14} {op[:28]:<28} {detail}")


def _print_kernels(out: List[str], inv, events):
    """Kernel-selector lowering decisions from bigslice:kernel_select
    instants (parallel/kernelselect.py): which kernel each combine/
    shuffle boundary got, why (static signal vs measured probe), and
    the probe evidence — absent entirely when BIGSLICE_KERNEL_SELECT
    is unset (the selector never emits)."""
    if not events:
        return
    out.append(f"# inv{inv}:kernels (kernel-selector decisions)")
    out.append(f"  {'kernel':<8} {'reason':<24} {'op':<24} evidence")
    for ev in events[-24:]:
        a = dict(ev.get("args", {}))
        kernel = str(a.pop("kernel", "?"))
        reason = str(a.pop("reason", "?"))
        op = str(a.pop("op", None) or "-")
        a.pop("inv", None)
        a.pop("site", None)
        evidence = " ".join(f"{k}={a[k]}" for k in sorted(a)) or "-"
        out.append(f"  {kernel:<8} {reason[:24]:<24} {op[:24]:<24} "
                   f"{evidence}")


def analyze(path: str) -> str:
    with open(path) as fp:
        doc = json.load(fp)
    tasks_by_inv: Dict[object, List[dict]] = {}
    summaries: Dict[object, dict] = {}
    telem_by_inv: Dict[object, Dict[str, List[dict]]] = {}
    _telem_names = {
        "bigslice:shuffleSizes": "skew",
        "bigslice:waveStaging": "staging",
        "bigslice:waveRun": "runs",
        "bigslice:taskRecovered": "recovery",
        "bigslice:compile": "compile",
        "bigslice:hbm": "hbm",
        "bigslice:donation": "donation",
        "bigslice:exchange": "exchange",
        "bigslice:spill": "spill",
        "bigslice:adaptive": "adaptive",
        "bigslice:kernel_select": "kernels",
        "bigslice:coded": "coded",
    }
    n_tasks = n_instants = 0
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "X":
            n_tasks += 1
            inv = ev.get("args", {}).get("inv")
            tasks_by_inv.setdefault(inv, []).append(ev)
        elif ev.get("ph") == "i":
            n_instants += 1
            args = ev.get("args", {})
            name = str(ev.get("name", ""))
            if name.startswith("bigslice:invocation:"):
                summaries[args.get("inv")] = args
            elif name in _telem_names:
                telem_by_inv.setdefault(
                    args.get("inv"), {}
                ).setdefault(_telem_names[name], []).append(ev)
    out = [f"{path}: {n_tasks} task runs, {n_instants} events"]
    known = sorted(
        k for k in set(tasks_by_inv) | set(telem_by_inv)
        if k is not None
    )
    for inv in known:
        _print_inv(out, inv, summaries.get(inv, {}),
                   tasks_by_inv.get(inv, []), telem_by_inv.get(inv))
    legacy = tasks_by_inv.get(None)
    if legacy:
        # Pre-inv-tagging traces: no invocation identity exists, so
        # print ONLY the flat all-ops quartile table (a summary/slice
        # section would be placeholder data).
        out.append("# all-ops (legacy trace without invocation tags)")
        out.append(
            f"  {'op':<28} {'n':>5} {'min_ms':>9} {'q1_ms':>9} "
            f"{'med_ms':>9} {'q3_ms':>9} {'max_ms':>9} {'total_ms':>10}"
        )
        for r in _op_rows(legacy):
            mn, q1, q2, q3, mx = quartiles(r["durs"])
            out.append(
                f"  {r['op'][:28]:<28} {r['n']:>5} {mn:>9.2f} "
                f"{q1:>9.2f} {q2:>9.2f} {q3:>9.2f} {mx:>9.2f} "
                f"{sum(r['durs']):>10.2f}"
            )
        out.append("")
    return "\n".join(out)


def _rank_of(path: str, doc: dict, fallback: int) -> int:
    """Rank identity of one trace file: the ``bigslice:sessionStart``
    instant's ``rank`` field (stamped only on multi-process sessions),
    else a ``rank<k>`` component in the filename (the fleet plane's
    ``trace-rank<r>.json`` convention), else the file's position on the
    command line."""
    for ev in doc.get("traceEvents", []):
        if (ev.get("ph") == "i"
                and str(ev.get("name", "")) == "bigslice:sessionStart"):
            rank = ev.get("args", {}).get("rank")
            if rank is not None:
                return int(rank)
            break
    m = re.search(r"rank(\d+)", os.path.basename(path))
    if m:
        return int(m.group(1))
    return fallback


def _scan_rank(doc: dict):
    """One rank's trace, bucketed the same way ``analyze`` buckets a
    single file: (tasks_by_inv, summaries_by_inv, telem_by_inv)."""
    tasks: Dict[object, List[dict]] = {}
    summaries: Dict[object, dict] = {}
    telem: Dict[object, Dict[str, List[dict]]] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "X":
            tasks.setdefault(
                ev.get("args", {}).get("inv"), []
            ).append(ev)
        elif ev.get("ph") == "i":
            args = ev.get("args", {})
            name = str(ev.get("name", ""))
            if name.startswith("bigslice:invocation:"):
                summaries[args.get("inv")] = args
            elif name == "bigslice:shuffleSizes":
                telem.setdefault(args.get("inv"), {}).setdefault(
                    "skew", []
                ).append(ev)
            elif name == "bigslice:compile":
                telem.setdefault(args.get("inv"), {}).setdefault(
                    "compile", []
                ).append(ev)
            elif name == "bigslice:exchange":
                telem.setdefault(args.get("inv"), {}).setdefault(
                    "exchange", []
                ).append(ev)
    return tasks, summaries, telem


def _fleet_skew_rows(events) -> List[int]:
    """Sum one rank's shuffleSizes contributions into a per-partition
    row vector. Each instant carries THIS CALL's rows (with optional
    global ``indices`` placement — the multi-process addressable-shard
    path), so summing every event reconstructs the rank's totals."""
    vec: List[int] = []
    for ev in events:
        a = ev.get("args", {})
        rows = a.get("rows")
        if not rows:
            continue
        indices = a.get("indices")
        if indices is None or len(indices) != len(rows):
            indices = list(range(len(rows)))
        top = max(indices) + 1
        if top > len(vec):
            vec.extend([0] * (top - len(vec)))
        for i, r in zip(indices, rows):
            vec[i] += int(r or 0)
    return vec


def analyze_merged(paths: List[str]) -> str:
    """Join N per-rank trace files into one correlated fleet timeline:
    rank lanes per invocation, cross-rank skew rollup, and per-rank
    compile/exchange attribution side by side. Invocations correlate
    by the ``corr`` id their ``bigslice:invocation:N`` instants carry
    (identical on every rank by the SPMD same-driver contract),
    falling back to the inv index for pre-corr traces."""
    ranks: Dict[int, dict] = {}
    for k, path in enumerate(paths):
        with open(path) as fp:
            doc = json.load(fp)
        rank = _rank_of(path, doc, k)
        tasks, summaries, telem = _scan_rank(doc)
        ranks[rank] = {
            "path": path, "tasks": tasks, "summaries": summaries,
            "telem": telem,
        }
    out = [f"fleet: {len(ranks)} rank trace(s) merged"]
    for rank in sorted(ranks):
        out.append(f"  rank {rank}  {ranks[rank]['path']}")
    out.append("")
    # Correlate invocations across ranks: corr id when present (the
    # serve plane mints one per request; Session.run defaults invN),
    # else the bare inv index.
    groups: Dict[object, Dict[int, object]] = {}
    order: List[object] = []
    for rank in sorted(ranks):
        r = ranks[rank]
        invs = sorted(
            i for i in set(r["tasks"]) | set(r["telem"])
            | set(r["summaries"]) if i is not None
        )
        for inv in invs:
            corr = r["summaries"].get(inv, {}).get("corr") or inv
            if corr not in groups:
                groups[corr] = {}
                order.append(corr)
            groups[corr][rank] = inv
    for corr in order:
        members = groups[corr]
        # Label the section by the lowest participating rank's inv
        # index (identical across ranks under the same-driver contract).
        inv0 = members[min(members)]
        summary = ranks[min(members)]["summaries"].get(inv0, {})
        out.append(f"# inv{inv0}:summary (corr={corr}, "
                   f"ranks={sorted(members)})")
        out.append(f"  location  {summary.get('location', '?')}")
        if summary.get("args"):
            out.append(f"  args      {summary['args']}")
        out.append(f"# inv{inv0}:lanes (per-rank op timeline)")
        out.append(f"  {'rank':>4} {'op':<28} {'n':>5} {'start_ms':>10} "
                   f"{'span_ms':>10} {'total_ms':>10}")
        for rank in sorted(members):
            evs = ranks[rank]["tasks"].get(members[rank], [])
            for r in _op_rows(evs):
                out.append(
                    f"  {rank:>4} {r['op'][:28]:<28} {r['n']:>5} "
                    f"{r['start']:>10.2f} {r['span']:>10.2f} "
                    f"{sum(r['durs']):>10.2f}"
                )
        _print_fleet_skew(out, inv0, ranks, members)
        _print_fleet_compile(out, inv0, ranks, members)
        _print_fleet_exchange(out, inv0, ranks, members)
        out.append("")
    return "\n".join(out)


def _print_fleet_skew(out: List[str], inv, ranks, members):
    """Cross-rank shuffle skew: each rank's contribution vector plus
    the fleet rollup (elementwise sum across ranks — by construction
    this equals what a single-process run of the same pipeline would
    record, since every rank reports its addressable shards at their
    global partition offsets)."""
    per_op: Dict[str, Dict[int, List[int]]] = {}
    for rank in sorted(members):
        telem = ranks[rank]["telem"].get(members[rank], {})
        by_op: Dict[str, List[dict]] = {}
        for ev in telem.get("skew", ()):
            op = ev.get("args", {}).get("op")
            if op:
                by_op.setdefault(op, []).append(ev)
        for op, evs in by_op.items():
            vec = _fleet_skew_rows(evs)
            if vec:
                per_op.setdefault(op, {})[rank] = vec
    if not per_op:
        return
    from bigslice_tpu_torch.utils.telemetry import TelemetryHub

    out.append(f"# inv{inv}:skew (fleet rollup; per-rank rows summed "
               f"at global partition offsets)")
    out.append(f"  {'op':<28} {'lane':>6} {'rows':>10} {'max':>9} "
               f"{'ratio':>7} {'hot':>4}")
    for op, by_rank in sorted(per_op.items()):
        width = max(len(v) for v in by_rank.values())
        merged = [0] * width
        for vec in by_rank.values():
            for i, r in enumerate(vec):
                merged[i] += r
        for rank in sorted(by_rank):
            vec = by_rank[rank]
            ratio, hot, _, total = TelemetryHub._skew_of(vec)
            out.append(
                f"  {op[:28]:<28} {rank:>6} {total:>10} "
                f"{max(vec):>9} {ratio:>7.2f} {hot:>4}"
            )
        ratio, hot, _, total = TelemetryHub._skew_of(merged)
        out.append(
            f"  {op[:28]:<28} {'fleet':>6} {total:>10} "
            f"{max(merged):>9} {ratio:>7.2f} {hot:>4}"
        )


def _print_fleet_compile(out: List[str], inv, ranks, members):
    """Per-rank compile attribution side by side — with the AOT seam
    live on every rank, identical counts per rank are the expected
    signature (deterministic compilation); divergence is the signal."""
    rows = []
    for rank in sorted(members):
        telem = ranks[rank]["telem"].get(members[rank], {})
        agg: Dict[str, dict] = {}
        for ev in telem.get("compile", ()):
            a = ev.get("args", {})
            d = agg.setdefault(a.get("op", "?"),
                               {"n": 0, "ms": 0.0, "kinds": set()})
            d["n"] += 1
            d["ms"] += a.get("ms", 0.0) or 0.0
            if a.get("kind"):
                d["kinds"].add(a["kind"])
        for op, d in sorted(agg.items()):
            rows.append((rank, op, d))
    if not rows:
        return
    out.append(f"# inv{inv}:compile (per-rank XLA compile attribution)")
    out.append(f"  {'rank':>4} {'op':<28} {'n':>4} {'wall_ms':>10}  "
               f"kinds")
    for rank, op, d in rows:
        out.append(
            f"  {rank:>4} {op[:28]:<28} {d['n']:>4} {d['ms']:>10.1f}  "
            f"{','.join(sorted(d['kinds'])) or '-'}"
        )


def _print_fleet_exchange(out: List[str], inv, ranks, members):
    """Per-rank exchange attribution (collective messages by axis)."""
    rows = []
    for rank in sorted(members):
        telem = ranks[rank]["telem"].get(members[rank], {})
        agg: Dict[str, dict] = {}
        for ev in telem.get("exchange", ()):
            a = ev.get("args", {})
            d = agg.setdefault(a.get("op", "?"),
                               {"dcn_m": 0, "dcn_b": 0, "ici_m": 0,
                                "ici_b": 0})
            d["dcn_m"] += a.get("dcn_messages", 0) or 0
            d["dcn_b"] += a.get("dcn_bytes", 0) or 0
            d["ici_m"] += a.get("ici_messages", 0) or 0
            d["ici_b"] += a.get("ici_bytes", 0) or 0
        for op, d in sorted(agg.items()):
            rows.append((rank, op, d))
    if not rows:
        return
    out.append(f"# inv{inv}:exchange (per-rank collective messages)")
    out.append(f"  {'rank':>4} {'op':<28} {'dcn_msg':>8} {'dcn_MB':>8} "
               f"{'ici_msg':>8} {'ici_MB':>8}")
    for rank, op, d in rows:
        out.append(
            f"  {rank:>4} {op[:28]:<28} {d['dcn_m']:>8} "
            f"{d['dcn_b'] / 1e6:>8.2f} {d['ici_m']:>8} "
            f"{d['ici_b'] / 1e6:>8.2f}"
        )


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m bigslice_tpu_torch.tools.slicetrace TRACE.json\n"
              "       python -m bigslice_tpu_torch.tools.slicetrace --merge "
              "R0.json R1.json ...",
              file=sys.stderr)
        return 2
    try:
        if argv[0] == "--merge":
            if not argv[1:]:
                print("--merge needs at least one trace file",
                      file=sys.stderr)
                return 2
            print(analyze_merged(argv[1:]))
            return 0
        for path in argv:
            print(analyze(path))
    except BrokenPipeError:  # `slicetrace t.json | head` is fine
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
