"""Repeat the two-rank host-tier word count and count its failures.

    python3 tools_torch_hostdist_repeat.py [--launches N] [--runs K]
                                           [--context host|smoke]
                                           [--device cpu] [--out FILE]

Each launch starts two fresh ranks (``multihost_smoke.launch``, gloo,
both on the one card unless ``--device cpu``). With ``--context smoke``
each rank first runs ``multihost_smoke``'s k-means step and keyed
Reduce at ``tests/test_torch_kernels_gpu.py::
test_spmd_two_ranks_share_the_card_over_gloo``'s sizes, as that mode
does before its host check; with ``--context host`` (the default) it
runs nothing before. Then each rank runs the host-tier word count of
``multihost_smoke._hostdist_check`` (ReaderFunc, Flatmap, Map, Reduce
over 4 shards, every host task on its owner rank ``shard % 2``) K
times, each in a fresh ``spmd_session``, and checks the counts.

A run that raises, or counts wrong, is recorded with its error, every
``Task.mark_lost`` of the rank during the run (the task, its count of
consecutive losses, the error's text, the thread), the exchange's miss
reasons (``HostTaskExchange.miss_reason``) and the keepalive's verdict
(its lost peers, the peer's beat age). The last line of the output is
one JSON object: the launches, runs and failures, each failure's
record, the seconds and the card's name and power limit; ``--out``
also gets it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def _card(device: str) -> str:
    if device == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _want() -> dict:
    want: dict = {}
    for shard in range(4):
        for (batch,) in _gen_lines(shard):
            for line in batch:
                for w in line.split():
                    want[w] = want.get(w, 0) + 1
    return want


VOCAB = ["gpu", "mesh", "nvlink", "hbm", "sm"]


def _gen_lines(shard):
    yield ([" ".join(VOCAB[(shard + j + i) % len(VOCAB)]
                     for j in range(3)) for i in range(6)],)


def _rank(args) -> int:
    """One rank of a launch: the runs, and a JSON report under --dir."""
    import numpy as np
    import torch

    torch.set_num_threads(2)
    from bigslice_tpu_torch.exec import task as task_mod

    rank = int(os.environ["RANK"])
    t0 = time.monotonic()
    losses: list = []
    mark_lost = task_mod.Task.mark_lost

    def logged(self, error=None):
        mark_lost(self, error)
        losses.append({"t": round(time.monotonic() - t0, 4),
                       "task": str(self.name),
                       "count": self.consecutive_lost,
                       "error": repr(error)[:600],
                       "thread": threading.current_thread().name})

    task_mod.Task.mark_lost = logged

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.spmd import spmd_session
    from bigslice_tpu_torch.tools import multihost_smoke as ms
    from bigslice_tpu_torch.utils import distributed

    @bs.func
    def host_wordcount(shards: int):
        lines = bs.ReaderFunc(shards, _gen_lines, out=[str])
        words = bs.Flatmap(lines, lambda line: [(w,) for w in line.split()],
                           out=[str])
        ones = bs.Map(words, lambda w: (w, 1), out=[str, np.int32])
        return bs.Reduce(ones, lambda a, b: a + b)

    distributed.initialize(device=args.device, backend="gloo")
    mesh = distributed.global_mesh()
    report = {"rank": rank, "context": args.context, "runs": []}
    if args.context == "smoke":
        ns = ms._parser().parse_args([
            "--rows", str(1 << 18), "--keyspace", str(1 << 14),
            "--shards", "8", "--threads", "2"])
        report.update(ms._kmeans_check(mesh, rank, 2, ns))
        red = ms._reduce_check(mesh, ns)
        report["reduce_rows_ok"] = red["reduce_rows_ok"]
    want = _want()
    for i in range(args.runs):
        mesh.barrier()
        del losses[:]
        sess = spmd_session(mesh=mesh)
        hd = sess.executor._hostdist
        r0 = time.perf_counter()
        try:
            got = dict(sess.run(host_wordcount, 4).rows())
            err = None if got == want else f"wrong counts {got}"
        except Exception as e:  # noqa: BLE001 — the record under test
            err = repr(e)[:2000]
        ka = distributed.get_keepalive()
        peer = 1 - rank
        report["runs"].append({
            "run": i, "ok": err is None, "error": err,
            "seconds": time.perf_counter() - r0,
            "losses": list(losses),
            "miss_reason": {f"{k[0]} p{k[1]}": v
                            for k, v in hd.miss_reason.items()},
            "keepalive_lost": ka.lost_peers(),
            "peer_beat_age_s": ka.age(peer),
            "fetched": len(hd.fetched)})
        mesh.barrier()
        sess.shutdown()
        mesh.barrier()
    with open(os.path.join(args.dir, f"rank{rank}.json"), "w") as fh:
        json.dump(report, fh)
    mesh.barrier()
    distributed.shutdown()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--launches", type=int, default=10)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--context", default="host", choices=("host", "smoke"))
    ap.add_argument("--device", default=None, help="cpu (default: cuda)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank:
        return _rank(args)
    if args.device != "cpu":
        import torch

        if not torch.cuda.is_available():
            print("tools_torch_hostdist_repeat: no CUDA device",
                  file=sys.stderr)
            return 2
    sys.path.insert(0, REPO)
    from bigslice_tpu_torch.tools import multihost_smoke as ms

    t0 = time.perf_counter()
    runs = failed = 0
    failures, launch_errors = [], []
    for li in range(args.launches):
        d = tempfile.mkdtemp(prefix="hostdist-repeat-")
        cmd = [sys.executable, os.path.abspath(__file__), "--rank",
               "--dir", d, "--runs", str(args.runs), "--context",
               args.context]
        if args.device:
            cmd += ["--device", args.device]
        res = ms.launch(2, cmd, deadline_s=120 + 60 * args.runs,
                        env={"PYTHONPATH": REPO})
        reps = []
        for r in range(2):
            path = os.path.join(d, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as fh:
                    reps.append(json.load(fh))
        if res.rc != 0 or len(reps) != 2:
            launch_errors.append({"launch": li, "rc": res.rc,
                                  "stderr": [s[-3000:] for s in res.stderr]})
            continue
        for i in range(args.runs):
            runs += 1
            per_rank = [rep["runs"][i] for rep in reps]
            if not all(r["ok"] for r in per_rank):
                failed += 1
                failures.append({"launch": li, "run": i,
                                 "ranks": per_rank})
        print(f"launch {li}: {args.runs} runs, failed so far {failed} of "
              f"{runs}", flush=True)
    summary = {"launches": args.launches, "runs_per_launch": args.runs,
               "context": args.context, "runs": runs, "failed": failed,
               "launch_errors": launch_errors, "failures": failures,
               "seconds": time.perf_counter() - t0,
               "card": _card(args.device or "cuda")}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)
    print(json.dumps({k: v for k, v in summary.items()
                      if k not in ("failures", "launch_errors")}
                     | {"n_launch_errors": len(launch_errors)}))
    return 0 if not launch_errors else 1


if __name__ == "__main__":
    sys.exit(main())
