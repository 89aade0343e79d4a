"""One card's main paths on two trees of this repo, in alternating pairs.

    python3 tools_torch_tree_ab.py --other DIR [--pairs 10]

Starts one worker process in each tree (this checkout, and ``DIR``: for
example the parent commit unpacked with ``git archive``), each
importing its own tree's ``bigslice_tpu_torch`` and building its own
kernels. Each worker builds the inputs of ``chip_smoke.py``'s
reduce-wave (phase 3: ``Reduce(Const(4, keys, ones), add)`` over 2**25
int32 keys uniform over 2**20 from RandomState(42), through
``MeshExecutor(auto_dense=False)``) and lww-wave (phase 4: Map, Filter
and a last-writer-wins Reduce at the same size, through
``MeshExecutor()``). For each path: two warm-up runs a side, then
``--pairs`` pairs, the order alternating pair by pair (other, this;
this, other; ...). A run is session construction, ``Session.run`` and
reading every shard back to the host; every run's rows are checked
against numpy outside its wall. Prints each side's median and quartiles
a path, the pairs this tree won, and the card's name and power limit.
Needs a GPU; one process at a time runs on the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

PATHS = ("reduce-wave", "lww-wave")


def _reduce_wave(bs):
    """Phase 3's run and check."""
    S, n, span = 4, 1 << 25, 1 << 20
    keys = np.random.RandomState(42).randint(0, span, n).astype(np.int32)
    ones = np.ones(n, np.int32)
    bc = np.bincount(keys, minlength=span)
    present = np.nonzero(bc)[0]

    def run():
        res = bs.Session(executor=bs.MeshExecutor(auto_dense=False)).run(
            bs.Reduce(bs.Const(S, keys, ones), lambda a, b: a + b))
        for shard in range(S):
            list(res.reader(shard, ()))
        return res

    def check(res) -> bool:
        shards = bs.result_shard_rows(res)
        k = np.concatenate([s[0] for s in shards])
        v = np.concatenate([s[1] for s in shards])
        order = np.argsort(k)
        return bool(np.array_equal(k[order], present)
                    and np.array_equal(v[order], bc[present]))

    return run, check


def _lww_wave(bs):
    """Phase 4's run and check."""
    import torch

    S, n, mark = 4, 1 << 25, 1 << 22
    rng = np.random.RandomState(42)
    keys = rng.randint(0, 1 << 24, n).astype(np.int32)
    ts = rng.permutation(n).astype(np.int32)
    vals = rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32)
    sel = ts >= mark
    comb = ((keys[sel] & 0xFFFFF).astype(np.int64) << 25) | ts[sel]
    comb.sort()
    kk = comb >> 25
    last = np.r_[kk[1:] != kk[:-1], True]
    want_k = kk[last].astype(np.int32)
    want_t = (comb[last] & ((1 << 25) - 1)).astype(np.int32)
    del comb, kk

    def lww(a, b):
        return (torch.maximum(a[0], b[0]),
                torch.where(a[0] >= b[0], a[1], b[1]))

    def run():
        s = bs.Map(bs.Const(S, keys, ts, vals),
                   lambda k, t, v: (k & 0xFFFFF, t, v))
        s = bs.Filter(s, lambda k, t, v: t >= mark)
        res = bs.Session(executor=bs.MeshExecutor()).run(bs.Reduce(s, lww))
        for shard in range(S):
            list(res.reader(shard, ()))
        return res

    def check(res) -> bool:
        shards = bs.result_shard_rows(res)
        k = np.concatenate([s[0] for s in shards])
        t = np.concatenate([s[1] for s in shards])
        order = np.argsort(k)
        return bool(np.array_equal(k[order], want_k)
                    and np.array_equal(t[order], want_t))

    return run, check


def worker() -> None:
    """Serve runs over stdin/stdout: one path name a line, one JSON
    line back (``wall_s``, ``ok``); an empty line ends."""
    import torch

    import bigslice_tpu_torch as bs

    paths = {"reduce-wave": _reduce_wave(bs), "lww-wave": _lww_wave(bs)}
    print(json.dumps({"package": os.path.dirname(bs.__file__)}), flush=True)
    for line in sys.stdin:
        name = line.strip()
        if not name:
            break
        run, check = paths[name]
        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
        ok = check(res)
        del res
        print(json.dumps({"wall_s": wall, "ok": ok}), flush=True)


def _start(tree: str) -> subprocess.Popen:
    """A worker importing ``tree``'s package (``-c``: the working
    directory, not this file's, leads ``sys.path``)."""
    code = ("import importlib.util as u; "
            f"s = u.spec_from_file_location('tree_ab', {__file__!r}); "
            "m = u.module_from_spec(s); s.loader.exec_module(m); m.worker()")
    env = dict(os.environ, PYTHONPATH=tree)
    return subprocess.Popen([sys.executable, "-c", code], cwd=tree, env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True)


def _ask(proc: subprocess.Popen, name: str) -> float:
    proc.stdin.write(name + "\n")
    proc.stdin.flush()
    line = proc.stdout.readline()
    if not line:
        raise RuntimeError(f"worker exited ({proc.wait()}) on {name}")
    got = json.loads(line)
    if not got["ok"]:
        raise AssertionError(f"{name}: rows differ from numpy")
    return got["wall_s"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="the other tree (e.g. the parent commit)")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tools_torch_tree_ab: needs a GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    trees = {"this": os.path.dirname(os.path.abspath(__file__)),
             "other": os.path.abspath(args.other)}
    procs = {side: _start(tree) for side, tree in trees.items()}
    try:
        for side, proc in procs.items():
            hello = proc.stdout.readline()
            if not hello:
                raise RuntimeError(f"{side} worker did not start")
            print(f"{side}: {json.loads(hello)['package']}")
        for name in PATHS:
            for side in ("other", "this", "other", "this"):
                _ask(procs[side], name)
            walls = {"this": [], "other": []}
            for p in range(args.pairs):
                order = ("other", "this") if p % 2 == 0 else ("this", "other")
                for side in order:
                    walls[side].append(_ask(procs[side], name))
            for side, ws in walls.items():
                q1, _, q3 = statistics.quantiles(ws, n=4)
                print(f"{name}, {side} tree: median "
                      f"{statistics.median(ws):.4f} s, quartiles "
                      f"{q1:.4f} / {q3:.4f} s, runs "
                      f"{', '.join(f'{w:.4f}' for w in ws)}")
            won = sum(a < b for a, b in zip(walls["this"], walls["other"]))
            print(f"{name}: this tree won {won} of {args.pairs} pairs, on "
                  f"{card}")
    finally:
        for proc in procs.values():
            try:
                proc.stdin.write("\n")
                proc.stdin.flush()
            except OSError:
                pass
        for proc in procs.values():
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
