"""Chaos runner: run a pipeline under a deterministic fault plan and
report the recovery matrix.

Runs a known-answer shuffle pipeline twice, fault-free and then under a
seeded ``BIGSLICE_CHAOS``-style plan (``utils/faultinject.py``), checks
that the results are bit-identical, and prints a **recovery matrix**:
for each injection site, how many faults fired, how many lost tasks the
ladder brought back (attributed to the site through the error chain's
markers; corruption surfaces in the ``organic`` bucket), how many
turned fatal, and the loss → OK time-to-recovery quantiles. The plan is
seeded, so a failing matrix replays: the same spec fires the same
faults at the same ``(site, invocation_id)``.

Usage:
    python -m bigslice_tpu_torch.tools.chaosslice \
        -chaos "7:store.read=0.08x6,codec.read=0.05x2~flip,io.read=0.2x3" \
        [-rows N] [-shards S] [-nkeys K] [-mesh] [-shuffle spill] \
        [-device cuda|cpu] [-json OUT.json] [-list-sites]

``-chaos`` defaults to ``$BIGSLICE_CHAOS``. The local runs use
``LocalExecutor`` with a ``FileStore`` in a temporary directory (the
file and codec sites); ``-mesh`` runs ``MeshExecutor`` (the dispatch,
staging, upload and memory-loss sites). ``-device`` defaults to
``cuda``. It exits 0 when the chaos run completed bit-identical to the
fault-free run, 1 when it did not, 2 on a bad plan.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np

from bigslice_tpu_torch.utils import faultinject


def _pipeline(shards: int, keys, vals):
    import bigslice_tpu_torch as bs

    return bs.Reduce(bs.Const(shards, keys, vals), lambda a, b: a + b)


def _run_once(use_mesh: bool, store_dir, rows: int, shards: int,
              nkeys: int, device: str):
    """One full session run; returns (sorted rows, telemetry summary,
    wall seconds)."""
    from bigslice_tpu_torch.exec.session import Session

    rng = np.random.RandomState(11)
    keys = rng.randint(0, nkeys, rows).astype(np.int32)
    vals = rng.randint(0, 100, rows).astype(np.int32)
    if use_mesh:
        from bigslice_tpu_torch.exec.meshexec import MeshExecutor

        executor = MeshExecutor(device=device)
    else:
        from bigslice_tpu_torch.exec import store as store_mod
        from bigslice_tpu_torch.exec.local import LocalExecutor

        executor = LocalExecutor(store=store_mod.FileStore(store_dir),
                                 device=device)
    sess = Session(executor=executor)
    t0 = time.monotonic()
    try:
        res = sess.run(_pipeline(shards, keys, vals))
        out = sorted(res.rows())
    finally:
        wall = time.monotonic() - t0
        summary = sess.telemetry_summary()
        sess.shutdown()
    return out, summary, wall


def _matrix(plan_snap: dict, recovery: dict) -> list:
    """Rows of the site × injected/recovered/fatal matrix."""
    by_site = (recovery or {}).get("by_site", {})
    sites = sorted(set(plan_snap.get("injected", {}))
                   | set(by_site))
    rows = []
    for site in sites:
        rec = by_site.get(site, {})
        lat = rec.get("latency", {})
        rows.append({
            "site": site,
            "injected": plan_snap.get("injected", {}).get(site, 0),
            "recovered": rec.get("recovered", 0),
            "fatal": rec.get("fatal", 0),
            "ttr_p50_s": lat.get("p50_s"),
            "ttr_p90_s": lat.get("p90_s"),
            "ttr_max_s": lat.get("max_s"),
        })
    return rows


def _print_matrix(rows: list) -> None:
    print(f"  {'site':<20} {'injected':>8} {'recovered':>9} "
          f"{'fatal':>6} {'ttr_p50_ms':>11} {'ttr_max_ms':>11}")
    for r in rows:
        p50 = (f"{r['ttr_p50_s'] * 1e3:.1f}"
               if r["ttr_p50_s"] is not None else "-")
        mx = (f"{r['ttr_max_s'] * 1e3:.1f}"
              if r["ttr_max_s"] is not None else "-")
        print(f"  {r['site']:<20} {r['injected']:>8} "
              f"{r['recovered']:>9} {r['fatal']:>6} {p50:>11} "
              f"{mx:>11}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="chaosslice",
        description="run a pipeline under a deterministic fault plan "
                    "and emit the recovery matrix",
    )
    p.add_argument("-chaos", default=None,
                   help="seed:spec plan (default: $BIGSLICE_CHAOS)")
    p.add_argument("-rows", type=int, default=20000)
    p.add_argument("-shards", type=int, default=8)
    p.add_argument("-nkeys", type=int, default=199)
    p.add_argument("-mesh", action="store_true",
                   help="run on the device executor (MeshExecutor)")
    p.add_argument("-device", default="cuda", choices=("cuda", "cpu"),
                   help="the executors' device (cpu in tests)")
    p.add_argument("-shuffle", default=None,
                   choices=("in_program", "spill", "auto"),
                   help="force the shuffle plan (BIGSLICE_SHUFFLE) for "
                        "both runs — 'spill' exercises the out-of-core "
                        "spill exchange's spill.read/spill.write sites "
                        "(device executor only)")
    p.add_argument("-json", dest="json_path", default=None)
    p.add_argument("-list-sites", action="store_true")
    args = p.parse_args(argv)

    if args.list_sites:
        for name, info in sorted(faultinject.sites().items()):
            kinds = "/".join(info["kinds"])
            print(f"{name:<20} [{kinds}] {info['doc']}")
        return 0

    import os

    spec = args.chaos or os.environ.get("BIGSLICE_CHAOS")
    if not spec:
        print("chaosslice: no plan (-chaos or $BIGSLICE_CHAOS)",
              file=sys.stderr)
        return 2

    try:
        parsed = faultinject.parse_plan(spec)
    except ValueError as e:
        print(f"chaosslice: bad plan: {e}", file=sys.stderr)
        return 2

    prev_shuffle = os.environ.get("BIGSLICE_SHUFFLE")
    if args.shuffle:
        # Both runs (baseline AND chaos) take the forced plan, so the
        # bit-identical verdict measures recovery, not the exchange.
        os.environ["BIGSLICE_SHUFFLE"] = args.shuffle
    try:
        with tempfile.TemporaryDirectory(prefix="chaosslice-") as tmp:
            # Fault-free baseline first: the ground truth the chaos run
            # must match bit-for-bit.
            faultinject.clear()
            baseline, _, base_wall = _run_once(
                args.mesh, f"{tmp}/base", args.rows, args.shards,
                args.nkeys, args.device,
            )
            plan = faultinject.install(parsed)
            err = None
            try:
                chaos_rows, summary, chaos_wall = _run_once(
                    args.mesh, f"{tmp}/chaos", args.rows, args.shards,
                    args.nkeys, args.device,
                )
            except Exception as e:  # noqa: BLE001 — reported, never
                err = e              # raised
                chaos_rows, summary, chaos_wall = None, {}, 0.0
            finally:
                faultinject.clear()
    finally:
        # In-process callers (tests) must not inherit the forced plan.
        if args.shuffle:
            if prev_shuffle is None:
                os.environ.pop("BIGSLICE_SHUFFLE", None)
            else:
                os.environ["BIGSLICE_SHUFFLE"] = prev_shuffle

    snap = plan.snapshot()
    recovery = summary.get("recovery", {})
    matrix = _matrix(snap, recovery)
    match = chaos_rows == baseline

    print(f"chaosslice: plan seed={snap['seed']} "
          f"({sum(snap['injected'].values())} faults injected over "
          f"{len(snap['log'])} log entries)")
    print(f"# recovery matrix "
          f"(site x injected/recovered/fatal, time-to-recovery)")
    _print_matrix(matrix)
    if err is not None:
        site = faultinject.fault_site_of(err) or "?"
        print(f"run FAILED (fault site {site}): {err!r}")
    else:
        print(f"results {'bit-identical to' if match else 'DIVERGED from'}"
              f" fault-free run "
              f"({len(baseline)} keys; base {base_wall:.2f}s, "
              f"chaos {chaos_wall:.2f}s)")

    if args.json_path:
        doc = {
            "spec": spec,
            "mesh": bool(args.mesh),
            "device": args.device,
            "shuffle": args.shuffle,
            "rows": args.rows,
            "shards": args.shards,
            "ok": err is None,
            "bit_identical": bool(match),
            "error": repr(err) if err is not None else None,
            "wall_s": {"baseline": round(base_wall, 3),
                       "chaos": round(chaos_wall, 3)},
            "matrix": matrix,
            "plan": snap,
            "recovery": recovery,
            "drain": summary.get("drain"),
        }
        with open(args.json_path, "w") as fp:
            json.dump(doc, fp, indent=2)
        print(f"wrote {args.json_path}")

    return 0 if (err is None and match) else 1


if __name__ == "__main__":
    sys.exit(main())
