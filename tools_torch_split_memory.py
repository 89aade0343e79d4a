"""Peak device memory of a Reduce unsplit and under the budget split.

    python3 tools_torch_split_memory.py [--rows N] [--key-space K] [--runs R]

Runs ``Reduce(Const(4, keys, ones), add)`` over N int32 keys uniform
over K from RandomState(9) (the defaults, 2**22 over 2**18, are the
cell of ``tests/test_torch_kernels_gpu.py::
test_budget_split_bounds_peak_memory``: about one row a key in each
slice) on two executors at prefetch depth 0: one without a budget, one
with a quarter of a map wave's ``MeshExecutor.wave_bytes_model`` (K = 4
row slices a map wave). Each executor serves R runs; each run's tasks
are discarded after it. Prints, per run, the peak device memory above
what the card held when the run started, and for the split the
largest working set of its slices (a slice's program and its fold into
the running merge, above what the card held when it started), with
the card's name and power limit. Needs a GPU.
"""

from __future__ import annotations

import argparse
import gc
import subprocess
import sys

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 22)
    ap.add_argument("--key-space", type=int, default=1 << 18)
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tools_torch_split_memory: needs a GPU", file=sys.stderr)
        return 2
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.task import iter_tasks

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    n = args.rows
    keys = np.random.RandomState(9).randint(0, args.key_space, n).astype(
        np.int32)
    ones = np.ones(n, np.int32)
    est = bs.MeshExecutor.wave_bytes_model(n // 4, 8, hash_table=True)
    budget = -(-est // 4)
    mib = 1 << 20
    for label, kw in (("unsplit", {}),
                      ("split", dict(device_budget_bytes=budget))):
        ex = bs.MeshExecutor(prefetch_depth=0, **kw)
        slices, tops = [], []
        run_slice = ex._run_slice

        def measured(*a):
            # The run's peak so far is kept before the reset that
            # starts this slice's own.
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            tops.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            out = run_slice(*a)
            torch.cuda.synchronize()
            slices.append(torch.cuda.max_memory_allocated() - before)
            return out

        ex._run_slice = measured
        peaks = []
        for _ in range(args.runs):
            gc.collect()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            tops.clear()
            res = bs.Session(executor=ex).run(
                bs.Reduce(bs.Const(4, keys, ones), lambda a, b: a + b))
            for shard in range(res.num_shards):
                list(res.reader(shard, ()))
            torch.cuda.synchronize()
            peaks.append(max([torch.cuda.max_memory_allocated()] + tops)
                         - held)
            for t in iter_tasks(res.tasks):
                ex.discard(t)
            del res
        line = (f"{label}: peak above the run's start "
                f"{', '.join(f'{p / mib:.1f}' for p in peaks)} MiB a run, "
                f"split {dict(ex.split_runs)}")
        if slices:
            line += (f", largest slice {max(slices) / mib:.1f} MiB of "
                     f"{len(slices)} (budget {budget / mib:.1f} MiB)")
        print(f"{line}, {n} rows over {args.key_space} keys, on {card}")
        del ex
    return 0


if __name__ == "__main__":
    sys.exit(main())
