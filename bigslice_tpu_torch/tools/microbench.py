"""Micro-benchmarks (the JAX package's ``tools/microbench``): evaluator
scheduling overhead, wave streaming, frame kernel rates, codec rates
and the device reduce.

Usage: python -m bigslice_tpu_torch.tools.microbench [--quick]
    [-device cpu]

Prints one line per metric, under the JAX package's names; no JSON
contract. The device benches run on ``cuda`` by default (``-device
cpu`` in tests); a device time is read after a synchronize.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _instant_executor():
    """A stub executor for the evaluator benches: it completes every
    task at once, so only the scheduling cost is measured."""
    from bigslice_tpu_torch.exec.task import TaskState

    class InstantExecutor:
        def submit(self, task):
            if task.transition_if(TaskState.WAITING, TaskState.RUNNING):
                task.mark_ok()

    return InstantExecutor()


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, iters: int = 5, device="cpu") -> float:
    """The best of ``iters`` timed calls after one warm call, each
    closed by a device synchronize."""
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def bench_eval(n_tasks: int = 500):
    """Evaluator and stub executor scheduling overhead along a chain."""
    from bigslice_tpu_torch.exec.evaluate import evaluate
    from bigslice_tpu_torch.exec.task import (Partitioner, Task, TaskDep,
                                              TaskName)

    def run():
        prev = None
        tasks = []
        for i in range(n_tasks):
            deps = [TaskDep((prev,), 0)] if prev is not None else []
            t = Task(TaskName(1, f"t{i}", 0, 1), lambda f: iter(()), deps,
                     Partitioner(), None)
            tasks.append(t)
            prev = t
        evaluate(_instant_executor(), [tasks[-1]])

    dt = timeit(run, 3)
    print(f"eval_chain        {n_tasks} tasks      "
          f"{dt * 1e6 / n_tasks:8.1f} us/task")


def bench_eval_fanout(width: int = 100, layers: int = 100):
    """Graph-shaped evaluator overhead: width x layers tasks with full
    cross-layer fan-in (about width^2 * (layers - 1) edges)."""
    from bigslice_tpu_torch.exec.evaluate import evaluate
    from bigslice_tpu_torch.exec.task import (Partitioner, Task, TaskDep,
                                              TaskName)

    def run():
        below = [Task(TaskName(1, f"f0s{i}", i, width), lambda f: iter(()),
                      [], Partitioner(), None)
                 for i in range(width)]
        for L in range(1, layers):
            below = [Task(TaskName(1, f"f{L}s{i}", i, width),
                          lambda f: iter(()), [TaskDep(tuple(below), i)],
                          Partitioner(), None) for i in range(width)]
        evaluate(_instant_executor(), below)

    n = width * layers
    dt = timeit(run, 3)
    print(f"eval_fanout       {n} tasks    "
          f"{dt * 1e6 / n:8.1f} us/task  ({dt:.2f}s total)")


def bench_wave_stress(shards: int = 64, rows_per_shard: int = 4096,
                      device="cuda"):
    """Wave streaming under partition pressure: S shards on the one
    device slot run S waves a group, with the producer's
    wave-partitioned (subid) shuffle and the consumer's waved
    re-combine."""
    import bigslice_tpu_torch as bs

    n = shards * rows_per_shard
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 997, n).astype(np.int32)
    vals = np.ones(n, np.int32)
    ex = bs.MeshExecutor(device=device)
    sess = bs.Session(executor=ex)
    r = bs.Reduce(bs.Const(shards, keys, vals), lambda a, b: a + b)
    t0 = time.perf_counter()
    got = dict(sess.run(r).rows())
    dt = time.perf_counter() - t0
    sess.shutdown()
    assert sum(int(v) for v in got.values()) == n
    waves = -(-shards // ex.nmesh)
    print(f"wave_stress       {shards} shards/{ex.nmesh} devices "
          f"({waves} waves)  {n / dt / 1e3:8.1f} Krows/s "
          f"({dt:.2f}s end to end, first run)")


def bench_frame(n: int = 1 << 20, device="cuda"):
    import torch

    from bigslice_tpu_torch.frame.frame import Frame

    f = Frame([torch.arange(n, dtype=torch.int32),
               torch.from_numpy(
                   np.random.RandomState(0).rand(n).astype(np.float32))])
    f = f.to(device)
    dt = timeit(lambda: f.hash_keys(), device=device)
    print(f"frame_hash        {n} rows     {n / dt / 1e6:8.1f} Mrows/s")
    dt = timeit(lambda: f.partition_ids(16), device=device)
    print(f"frame_partition   {n} rows     {n / dt / 1e6:8.1f} Mrows/s")
    dt = timeit(lambda: f.sorted_by_key(), device=device)
    print(f"frame_sort        {n} rows     {n / dt / 1e6:8.1f} Mrows/s")


def bench_codec(n: int = 1 << 18):
    from bigslice_tpu_torch.frame import codec
    from bigslice_tpu_torch.frame.frame import Frame

    f = Frame([np.arange(n, dtype=np.int32),
               np.random.RandomState(0).rand(n).astype(np.float32)])
    blob = codec.encode_frame(f)
    dt = timeit(lambda: codec.encode_frame(f))
    print(f"codec_encode      {n} rows      {n / dt / 1e6:8.1f} Mrows/s "
          f"({len(blob) / 1e6:.1f} MB)")
    dt = timeit(lambda: codec.decode_frame(blob))
    print(f"codec_decode      {n} rows      {n / dt / 1e6:8.1f} Mrows/s")


def bench_device_reduce(n: int = 1 << 19, device="cuda"):
    import torch

    from bigslice_tpu_torch.parallel import segment

    rng = np.random.RandomState(0)
    keys = torch.from_numpy(
        rng.randint(0, 1 << 12, n).astype(np.int32)).to(device)
    vals = torch.ones(n, dtype=torch.int32, device=device)
    red = segment.DeviceReduceByKey(lambda a, b: a + b, 1, 1)
    dt = timeit(lambda: red([keys], [vals], n), device=device)
    print(f"device_reduce     {n} rows      {n / dt / 1e6:8.1f} Mrows/s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="microbench")
    ap.add_argument("--quick", action="store_true",
                    help="a quarter of the sizes, for a smoke run")
    ap.add_argument("-device", default="cuda", choices=("cuda", "cpu"),
                    help="the device benches' device (cpu in tests)")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    quick, device = args.quick, args.device
    scale = 4 if quick else 1
    bench_eval(200 if quick else 10_000)
    bench_eval_fanout(*((20, 20) if quick else (100, 100)))
    bench_frame((1 << 20) // scale, device=device)
    bench_codec((1 << 18) // scale)
    bench_device_reduce((1 << 19) // scale, device=device)
    bench_wave_stress(16 if quick else 64, 1024 if quick else 4096,
                      device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
