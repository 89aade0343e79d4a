"""Count how often K2's table overflows at a load of about 0.63.

    python3 tools_torch_k2_overflow.py [--shape hot|split] [--trials N]
                                       [--tag NAME] [--device cpu]

``--shape hot`` (the default) builds the reduce-side tables of a
hot-key Reduce: 2**25 int32 keys uniform over 2**20 from
RandomState(42), of which every row but one in 32 (RandomState(2929))
is moved onto key 0, counted over S = 4 shards. Each shard's map side
leaves one row a distinct key; partition p's reduce input is those rows
of every shard that the plain K1 routes to p, front-packed into
``bucket_size`` of the largest partition's rows, as the executor packs
a reduce wave: four tables (``nparts = 1``, ``R = bucket_size(n)``)
about 0.63 full.

``--shape split`` builds the map-side table of one budget-split slice
(``tests/test_torch_kernels_gpu.py::test_budget_split_bounds_peak_memory``):
the first 2**18 of 2**22 keys uniform over 2**18 from RandomState(9),
counted into ``nparts = 4`` regions of ``combine_region_size`` slots
each, the regions also about 0.63 full.

Each trial draws a fresh order of the rows and runs the K2 wrapper
(``cuda_kernels.hash_aggregate``) on each table; a table whose overflow
count is not 0 sends its op to the sort path for good. With ``--device
cpu`` the wrapper runs its plain version (the JAX package's claim
cascade), whose overflow is its own. The first trial's tables are held
against numpy (every key once, with its total). The last line is one
JSON object: the tables run, those that overflowed, the rows lost, the
loads, the seconds, the card's name and power limit (``nvidia-smi``)
and the tag.

To compare two trees, copy the script into each and run it from there
in turns within one call: the kernel library is built from the tree the
script runs in.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

ROWS = 1 << 25
SPAN = 1 << 20
SHARDS = 4


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def hot_tables():
    """Each partition's reduce-side rows ``(keys, counts)`` as int32
    numpy arrays, in shard order, and the packed length ``n``."""
    from bigslice_tpu_torch.parallel.cuda_kernels import hash_partition_plain
    from bigslice_tpu_torch.parallel.jitutil import bucket_size

    keys = np.random.RandomState(42).randint(0, SPAN, ROWS).astype(np.int32)
    rng = np.random.RandomState(2929)
    keys = np.where(rng.randint(0, 32, ROWS) == 0, keys, 0).astype(np.int32)
    parts = [([], []) for _ in range(SHARDS)]
    for shard in np.split(keys, SHARDS):
        uk, cnt = np.unique(shard, return_counts=True)
        pid, _ = hash_partition_plain([torch.from_numpy(uk.astype(np.int32))],
                                      SHARDS, 0, with_counts=False)
        pid = pid.numpy()
        for p in range(SHARDS):
            parts[p][0].append(uk[pid == p].astype(np.int32))
            parts[p][1].append(cnt[pid == p].astype(np.int32))
    out = [(np.concatenate(k), np.concatenate(c)) for k, c in parts]
    n = bucket_size(max(len(k) for k, _ in out))
    return out, n


def split_table():
    """One budget-split slice's rows ``(keys, ones)``."""
    keys = np.random.RandomState(9).randint(0, 1 << 18, 1 << 22).astype(
        np.int32)[: 1 << 18]
    return keys, np.ones(len(keys), np.int32)


def _tables(shape: str, dev):
    """The shape's tables: dicts of the packed ``key``, ``val`` and
    ``part`` columns, the ``rows`` at their front, ``nparts``, ``R``
    and each region's ``loads``."""
    from bigslice_tpu_torch.parallel.cuda_kernels import hash_partition_plain
    from bigslice_tpu_torch.parallel.hashagg import combine_region_size

    if shape == "hot":
        parts, n = hot_tables()
        specs = [(k, c, np.zeros(len(k), np.int32), n, 1, n)
                 for k, c in parts]
    else:
        k, c = split_table()
        pid, _ = hash_partition_plain([torch.from_numpy(k)], 4, 0,
                                      with_counts=False)
        R = combine_region_size(len(k), 4)
        specs = [(k, c, pid.numpy().astype(np.int32), len(k), 4, R)]
    tables = []
    for k, c, pid, n, nparts, R in specs:
        rows = len(k)
        cols = {}
        for name, x in (("key", k), ("val", c), ("part", pid)):
            cols[name] = torch.zeros(n, dtype=torch.int32, device=dev)
            cols[name][:rows] = torch.from_numpy(x).to(dev)
        loads = [round(len(np.unique(k[pid == p])) / R, 4)
                 for p in range(nparts)]
        tables.append(dict(cols, np_key=k, np_val=c, rows=rows, n=n,
                           nparts=nparts, R=R, loads=loads))
    return tables


def _check(t, present, ok, ov, p):
    """A table that placed every row against numpy."""
    want_k, inv = np.unique(t["np_key"], return_inverse=True)
    want_v = np.bincount(inv, weights=t["np_val"]).astype(np.int64)
    got_k = ok[0][present].cpu().numpy()
    got_v = ov[0][present].cpu().numpy().astype(np.int64)
    o = np.argsort(got_k)
    if not (np.array_equal(got_k[o], want_k)
            and np.array_equal(got_v[o], want_v)):
        raise AssertionError(f"table {p}: rows differ from numpy")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", choices=("hot", "split"), default="hot")
    ap.add_argument("--trials", type=int, default=2000)
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("k2_overflow: no CUDA device is available", file=sys.stderr)
        return 2
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    if dev.type == "cuda" and not ck.kernels_available():
        raise RuntimeError("the kernels did not build or the probe failed")
    tables = _tables(args.shape, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    per_table = []
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for trial in range(args.trials):
        for p, t in enumerate(tables):
            rows, n = t["rows"], t["n"]
            order = torch.randperm(rows, device=dev, generator=gen)
            cols = {}
            for name in ("key", "val", "part"):
                cols[name] = t[name].clone()
                cols[name][:rows] = t[name][:rows][order]
            valid = torch.arange(n, device=dev) < rows
            present, ok, ov, overflow = ck.hash_aggregate(
                valid, [cols["key"]], [cols["val"]], ["add"], cols["part"],
                t["nparts"], t["R"])
            per_table.append(overflow)
            if trial == 0 and int(overflow) == 0:
                _check(t, present, ok, ov, p)
    sync()
    seconds = time.perf_counter() - t0
    counts = torch.stack(per_table).cpu().numpy()
    overflowed = int((counts > 0).sum())
    lost = int(counts.sum())
    card = _card() if dev.type == "cuda" else "cpu"
    loads = [t["loads"] for t in tables]
    shape = [dict(n=t["n"], rows=t["rows"], nparts=t["nparts"], R=t["R"])
             for t in tables]
    print(f"k2_overflow {args.shape}{(' ' + args.tag) if args.tag else ''}: "
          f"{len(counts)} tables (loads {loads}): {overflowed} overflowed, "
          f"{lost} rows lost, {seconds:.2f} s, on {card}")
    print(json.dumps(dict(tag=args.tag, shape=args.shape, tables=len(counts),
                          table_shapes=shape, loads=loads,
                          overflowed=overflowed, rows_lost=lost,
                          max_rows_lost=int(counts.max()),
                          seconds=round(seconds, 3), card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
