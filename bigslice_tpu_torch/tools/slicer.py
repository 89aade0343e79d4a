"""Stress and integration runner (the JAX package's ``tools/slicer``).

Named stress scenarios that drive the system at a chosen scale: reduce,
cogroup, iterative memory (a leak check over repeated Result reuse), a
shuffle soak, the aggregating join, wave streaming, and memory pressure
(``oom``). Each checks its own result and raises on a wrong one.

Usage:
    python -m bigslice_tpu_torch.tools.slicer [-local] [-device cpu]
        MODE [-rows N] [-shards S]
Modes: reduce | cogroup | memiter | shuffle | join | waves | oom

The device executor (``MeshExecutor``) runs by default, on ``cuda``;
``-local`` picks ``LocalExecutor``, ``-device cpu`` the CPU. No cluster
configuration is read: this package drives one process.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _data(rows: int, key_range: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, key_range, rows).astype(np.int32),
            rng.randint(0, 100, rows).astype(np.int32))


def _ident(k, v):
    return (k, v)


def _add(a, b):
    return a + b


def run_reduce(sess, rows, shards):
    import bigslice_tpu_torch as bs

    keys, vals = _data(rows, max(1, rows // 100))
    res = sess.run(bs.Reduce(bs.Const(shards, keys, vals), _add))
    total = sum(int(v) for _, v in res.rows())
    assert total == int(vals.sum()), (total, int(vals.sum()))
    return total


def run_cogroup(sess, rows, shards):
    import bigslice_tpu_torch as bs

    k1, v1 = _data(rows, max(1, rows // 50), seed=1)
    k2, v2 = _data(rows, max(1, rows // 50), seed=2)
    res = sess.run(bs.Cogroup(bs.Const(shards, k1, v1),
                              bs.Const(shards, k2, v2)))
    n = sum(len(a) + len(b) for _, a, b in res.rows())
    assert n == 2 * rows, (n, rows)
    return n


def run_memiter(sess, rows, shards, iters: int = 20):
    """Repeated Result-reusing runs; the resident set's growth over the
    iterations points at a task or store leak. Module-level functions
    (the documented iterative pattern): fresh lambdas each iteration
    would measure program-table churn, not leaks."""
    import resource

    import bigslice_tpu_torch as bs

    keys, vals = _data(rows, 997)
    base = sess.run(bs.Const(shards, keys, vals))
    rss = []
    for _ in range(iters):
        res = sess.run(bs.Reduce(bs.Map(base, _ident), _add))
        res.discard()
        rss.append(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
    return rss[0], rss[-1]


def run_shuffle(sess, rows, shards):
    import bigslice_tpu_torch as bs

    keys, _ = _data(rows, rows)
    res = sess.run(bs.Reshuffle(bs.Const(shards, keys)))
    n = sum(1 for _ in res.rows())
    assert n == rows, (n, rows)
    return n


def run_join(sess, rows, shards):
    """The aggregating join at scale, against its oracle."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.parallel.join import join_count_oracle

    k1, _ = _data(rows, max(1, rows // 20), seed=3)
    k2, _ = _data(rows, max(1, rows // 20), seed=4)
    ones = np.ones(rows, np.int32)
    res = sess.run(bs.JoinAggregate(
        bs.Const(shards, k1, ones), bs.Const(shards, k2, ones), _add, _add))
    got = {int(k): (int(a), int(b)) for k, a, b in res.rows()}
    assert got == join_count_oracle(k1.tolist(), k2.tolist())
    return len(got)


def run_waves(sess, rows, shards):
    """Wave streaming: the source runs with at least four times as many
    shards as device slots (whatever -shards says), so the group
    streams through the device in waves before resharding down."""
    import bigslice_tpu_torch as bs

    nmesh = getattr(sess.executor, "nmesh", 1)
    shards = max(shards, 4 * nmesh)
    keys, vals = _data(rows, max(1, rows // 100), seed=5)
    res = sess.run(bs.Reduce(
        bs.Reshard(bs.Prefixed(bs.Const(shards, keys, vals), 1), 8), _add))
    total = sum(int(v) for _, v in res.rows())
    assert total == int(vals.sum())
    return total


def run_oom(sess, rows, shards):
    """Memory pressure: instead of inviting the operating system's
    out-of-memory killer, drive both relief paths under a working set
    that exceeds their budgets, and check that the run completes
    exactly:

    1. device tier: a wave budget far below the wave's working set
       makes the budget split run the group as K row slices, whose
       outputs merge;
    2. host tier: a combinerless shuffle through a FileStore overflows
       ``SHUFFLE_SPILL_ROWS`` and spills its partition buffers
       (``sortio``), streamed back when stored.

    Both engagements are asserted, not assumed."""
    import tempfile

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch import sortio
    from bigslice_tpu_torch.exec import local as local_mod
    from bigslice_tpu_torch.exec import store as store_mod

    device = sess.executor.device
    keys, vals = _data(rows, max(1, rows // 100), seed=6)

    # 1. The wave budget's split on the device executor.
    ex = bs.MeshExecutor(device=device, device_budget_bytes=1 << 14)
    msess = bs.Session(executor=ex)
    res = msess.run(bs.Reduce(bs.Const(shards, keys, vals), _add))
    total = sum(int(v) for _, v in res.rows())
    assert total == int(vals.sum()), (total, int(vals.sum()))
    assert ex.split_runs, "the wave budget's split never engaged"
    K = max(ex.split_runs.values())

    # 2. The host shuffle's spill through a FileStore. The threshold
    # scales down to the scenario, so that it trips inside every task.
    saved = local_mod.SHUFFLE_SPILL_ROWS
    local_mod.SHUFFLE_SPILL_ROWS = max(64, rows // (2 * shards * shards))
    hsess = None
    try:
        with tempfile.TemporaryDirectory() as d:
            hsess = bs.Session(executor=bs.LocalExecutor(
                device=device, store=store_mod.FileStore(d)))
            before = sortio.SPILLED_ROWS
            res = hsess.run(bs.Reshuffle(bs.Const(shards, keys)))
            n = sum(1 for _ in res.rows())
            assert n == rows, (n, rows)
            spilled = sortio.SPILLED_ROWS - before
            assert spilled > 0, "the host shuffle never spilled"
    finally:
        local_mod.SHUFFLE_SPILL_ROWS = saved
        msess.shutdown()
        if hsess is not None:
            hsess.shutdown()
    return f"split K={K}, spilled {spilled} rows"


MODES = {
    "reduce": run_reduce,
    "oom": run_oom,
    "cogroup": run_cogroup,
    "memiter": run_memiter,
    "shuffle": run_shuffle,
    "join": run_join,
    "waves": run_waves,
}


def main(argv=None) -> int:
    import bigslice_tpu_torch as bs

    ap = argparse.ArgumentParser(prog="slicer")
    ap.add_argument("mode", choices=sorted(MODES))
    ap.add_argument("-rows", type=int, default=100_000)
    ap.add_argument("-shards", type=int, default=8)
    ap.add_argument("-local", action="store_true",
                    help="run on LocalExecutor (default: MeshExecutor)")
    ap.add_argument("-device", default="cuda", choices=("cuda", "cpu"),
                    help="the executor's device (cpu in tests)")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    ex = (bs.LocalExecutor(device=args.device) if args.local
          else bs.MeshExecutor(device=args.device))
    sess = bs.Session(executor=ex)
    t0 = time.perf_counter()
    try:
        out = MODES[args.mode](sess, args.rows, args.shards)
    finally:
        sess.shutdown()
    dt = time.perf_counter() - t0
    print(f"slicer {args.mode}: rows={args.rows} shards={args.shards} "
          f"-> {out} in {dt:.2f}s "
          f"({args.rows / max(dt, 1e-9):,.0f} rows/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
