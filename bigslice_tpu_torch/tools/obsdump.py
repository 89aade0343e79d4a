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

``--fleet STORE_URL``, the JAX package's offline fleet merge, raises
``ObservabilityNotPorted``, as ``Session.telemetry_summary(scope=
"fleet")`` does: the fleet plane (``utils/fleettelemetry.py``) is not
ported yet.

Usage:
    python -m bigslice_tpu_torch.tools.obsdump --trace TRACE.json \\
        --summary SUMMARY.json [--rows N] [--device cuda|cpu]
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
    """The offline fleet merge: not ported; raises by name."""
    from bigslice_tpu_torch.exec.session import ObservabilityNotPorted

    raise ObservabilityNotPorted(
        f"obsdump --fleet {store_url}: the fleet merge "
        f"(utils/fleettelemetry.py) is not ported yet")


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
                    help="offline fleet merge (not ported: raises)")
    args = ap.parse_args(argv)
    if args.fleet:
        fleet_merge(args.fleet)
    if not args.trace or not args.summary:
        ap.error("--trace and --summary are required")
    summary = run_workload(args.trace, rows=args.rows, device=args.device)
    with open(args.summary, "w") as fp:
        json.dump(summary, fp, indent=2, sort_keys=True, default=str)
    print(f"obsdump: trace -> {args.trace}", file=sys.stderr)
    print(f"obsdump: telemetry summary -> {args.summary}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
