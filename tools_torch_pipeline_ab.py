"""Prefetch depth 0 against depth 1 on one GPU, in alternating pairs.

    python3 tools_torch_pipeline_ab.py [--pairs N] [--shards S ...]

Runs ``chip_smoke.py``'s reduce-wave (``Reduce(Const(S, keys, ones),
add)`` over 2**25 int32 keys uniform over 2**20 from RandomState(42))
on two executors, both with the staging arena: prefetch depth 0 (the
serial loop) and depth 1 (the default). Each executor serves every one
of its runs (its arena kept), and each run's tasks are discarded after
it. After two warm-up runs a side, ``--pairs`` pairs run, the order
alternating pair by pair; a run is the session, the run and reading
every shard back. Prints each side's median and quartiles, the pairs
depth 1 won, and the card's name and power limit. Needs a GPU.
"""

from __future__ import annotations

import argparse
import gc
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--shards", type=int, nargs="+", default=[4, 16])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tools_torch_pipeline_ab: needs a GPU", file=sys.stderr)
        return 2
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.task import iter_tasks

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    n = 1 << 25
    keys = np.random.RandomState(42).randint(0, 1 << 20, n).astype(np.int32)
    ones = np.ones(n, np.int32)
    for S in args.shards:
        exs = {d: bs.MeshExecutor(prefetch_depth=d) for d in (0, 1)}

        def run(depth: int) -> float:
            ex = exs[depth]
            t0 = time.perf_counter()
            res = bs.Session(executor=ex).run(
                bs.Reduce(bs.Const(S, keys, ones), lambda a, b: a + b))
            for shard in range(S):
                list(res.reader(shard, ()))
            wall = time.perf_counter() - t0
            for t in iter_tasks(res.tasks):
                ex.discard(t)
            del res
            gc.collect()
            return wall

        for depth in (0, 1, 0, 1):
            run(depth)
        walls = {0: [], 1: []}
        for p in range(args.pairs):
            for depth in ((0, 1) if p % 2 == 0 else (1, 0)):
                walls[depth].append(run(depth))
        won = sum(w1 < w0 for w0, w1 in zip(walls[0], walls[1]))
        for depth, ws in walls.items():
            q1, _, q3 = statistics.quantiles(ws, n=4)
            print(f"reduce-wave {n} rows, S={S}, prefetch depth {depth}: "
                  f"median {statistics.median(ws):.4f} s, quartiles "
                  f"{q1:.4f} / {q3:.4f} s, runs "
                  f"{', '.join(f'{w:.4f}' for w in ws)}")
        print(f"reduce-wave S={S}: depth 1 won {won} of {args.pairs} pairs, "
              f"on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
