"""Observability artifact dump: run a representative workload, save the
Chrome trace and the telemetry summary.

The JAX package's ``tools/obsdump.py``, ported. One command smokes the
whole observability stack (the tracer, then ``tools/slicetrace``; the
telemetry hub, then its summary) and leaves an inspectable trace and
summary behind.

The workload exercises every signal family: a waved keyed Reduce (S = 4
shards on the device executor's one device slot: four waves through the
prefetch pipeline, so the overlap accounting fills) over a mildly skewed
key space (the shuffle boundary's rows a partition), with K1 routing
every row and K2 combining on the map side; the summary's ``device``
section lists their launches.

``--fleet STORE_URL`` is the offline fleet merge: instead of running a
workload it reads every rank's exported snapshot
(``telemetry-rank*.json``, written by ``Session(fleet_dir=)``) from the
store and merges them into one ``scope="fleet"`` summary, the document
rank 0 serves at ``/debug/fleet`` (``utils/fleettelemetry.py``).

Usage:
    python -m bigslice_tpu_torch.tools.obsdump --trace TRACE.json \\
        --summary SUMMARY.json [--rows N] [--device cuda|cpu]
    python -m bigslice_tpu_torch.tools.obsdump --fleet STORE_URL \\
        [--summary FLEET.json]
"""

from __future__ import annotations

import argparse
import json
import sys


def run_workload(trace_path: str, rows: int = 1 << 16,
                 device: str = "cuda") -> dict:
    """Run the instrumented workload on ``MeshExecutor(device)``; returns
    the telemetry summary (the Chrome trace lands at ``trace_path`` at
    shutdown)."""
    import numpy as np

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.meshexec import MeshExecutor
    from bigslice_tpu_torch.exec.session import Session

    executor = MeshExecutor(device=device)
    num_shards = 4 * executor.nmesh
    sess = Session(executor=executor, trace_path=trace_path)
    try:
        rng = np.random.RandomState(7)
        # Zipf-ish keys: a visibly hot head without collapsing onto one
        # key, so the skew section carries real numbers.
        keys = (rng.zipf(1.3, rows) % (1 << 12)).astype(np.int32)
        vals = np.ones(rows, dtype=np.int32)
        res = sess.run(bs.Reduce(bs.Const(num_shards, keys, vals),
                                 lambda a, b: a + b))
        n = sum(len(f) for f in res.frames())
        summary = sess.telemetry_summary()
        summary["workload"] = {
            "rows": rows, "shards": num_shards,
            "devices": executor.nmesh, "device": str(executor.device),
            "distinct_keys": int(n),
        }
    finally:
        sess.shutdown()  # writes the trace
    return summary


def fleet_merge(store_url: str) -> dict:
    """Read every rank's exported snapshot from the store and merge them
    into the ``scope="fleet"`` summary (the offline counterpart of rank
    0's live merge)."""
    from bigslice_tpu_torch.utils import fleettelemetry as fleet_mod

    snaps = fleet_mod.load_snapshots(store_url)
    if not snaps:
        raise SystemExit(
            f"obsdump: no telemetry-rank*.json snapshots under "
            f"{store_url!r} (was the session run with "
            f"BIGSLICE_FLEET_DIR?)")
    return fleet_mod.merge_snapshots(snaps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="obsdump",
        description="dump Chrome trace + telemetry summary artifacts",
    )
    ap.add_argument("--trace", help="Chrome trace output path (JSON)")
    ap.add_argument("--summary", help="telemetry summary output path (JSON)")
    ap.add_argument("--rows", type=int, default=1 << 16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device executor's device (cpu in tests)")
    ap.add_argument("--fleet", metavar="STORE_URL",
                    help="offline mode: read and merge every rank's "
                         "exported snapshot from this store URL instead "
                         "of running a workload")
    args = ap.parse_args(argv)
    if args.fleet:
        doc = fleet_merge(args.fleet)
        text = json.dumps(doc, indent=2, sort_keys=True)
        if args.summary:
            with open(args.summary, "w") as fp:
                fp.write(text + "\n")
            print(f"obsdump: fleet summary ({len(doc.get('ranks', []))}"
                  f" ranks) -> {args.summary}", file=sys.stderr)
        else:
            print(text)
        return 0
    if not args.trace or not args.summary:
        ap.error("--trace and --summary are required "
                 "(unless --fleet is given)")
    summary = run_workload(args.trace, rows=args.rows, device=args.device)
    with open(args.summary, "w") as fp:
        json.dump(summary, fp, indent=2, sort_keys=True, default=str)
    print(f"obsdump: trace -> {args.trace}", file=sys.stderr)
    print(f"obsdump: telemetry summary -> {args.summary}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
