"""Scenarios run over N ranks by the SPMD tests, and the ranks' program.

Each scenario builds its pipeline from seeded numpy data with either
package's API (``bs``; ``mod`` is ``torch`` or ``jax.numpy``), at a
shard count derived from the mesh size ``n``. The tests run the JAX
package's ``MeshExecutor`` over an n-device CPU mesh in-process; the
ranks run this file as a program (``python torch_spmd_scenarios.py
OUT``, started by ``multihost_smoke.launch``): each registers every
scenario as a Func in the same order, joins the gloo group on the CPU,
runs them all through ``spmd_session`` and pickles its per-shard rows
and executor state to ``OUT/rank{r}.pkl``. The program imports neither
``jax`` nor ``bigslice_tpu``.
"""

import os
import pickle
import sys

import numpy as np

ROWS = 3000


def _data(seed: int, n: int = ROWS, span: int = 300):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, span, n).astype(np.int32)
    vals = rng.randint(-1000, 1000, n).astype(np.int32)
    return keys, vals


def _skewed():
    """Shard 0's keys all route to partition 0 of 2 (its K2 region
    overflows); shard 1's spread: one slot's table overflows, not the
    other's."""
    from bigslice_tpu_torch.parallel import shuffle as shuffle_mod
    import torch

    cand = np.arange(200000, dtype=np.int32)
    part, _, _ = shuffle_mod.partition_ids([torch.from_numpy(cand)], 2, 0)
    hot = cand[part.numpy() == 0][:4096]
    spread = np.arange(4096, dtype=np.int32) % 97
    keys = np.concatenate([hot, spread])
    return keys, np.ones(len(keys), np.int32)


def reduce_k2(bs, mod, n):
    k, v = _data(1)
    return bs.Reduce(bs.Const(4 * n, k, v), lambda a, b: a + b)


def reduce_sort(bs, mod, n):
    k, v = _data(2)
    return bs.Reduce(bs.Const(4 * n, k, v), lambda a, b: a ^ b)


def reduce_float(bs, mod, n):
    k, _ = _data(3)
    v = np.random.RandomState(3).rand(ROWS).astype(np.float32)
    return bs.Reduce(bs.Const(2 * n, k, v), lambda a, b: a + b)


def reduce_padded(bs, mod, n):
    k, v = _data(4)
    return bs.Reduce(bs.Const(max(1, n - 1), k, v), lambda a, b: a + b)


def reduce_dense(bs, mod, n):
    k, v = _data(5)
    return bs.Reduce(bs.Const(n, k, v), lambda a, b: a + b, dense_keys=300)


def reshuffle(bs, mod, n):
    k, v = _data(6)
    return bs.Reshuffle(bs.Const(2 * n, k, v))


def repartition(bs, mod, n):
    k, v = _data(7)
    return bs.Repartition(bs.Const(2 * n, k, v), lambda k, m: k % m)


def join(bs, mod, n):
    ka, va = _data(8)
    kb, vb = _data(9)
    return bs.JoinAggregate(bs.Const(2 * n, ka, va), bs.Const(2 * n, kb, vb),
                            lambda a, b: a + b, lambda a, b: a + b)


def groupby(bs, mod, n):
    k, v = _data(10, span=120)
    return bs.GroupByKey(bs.Const(2 * n, k, v), capacity=64)


def fold(bs, mod, n):
    k, v = _data(11)
    return bs.Fold(bs.Const(2 * n, k, v), lambda acc, x: acc * 31 + x,
                   init=7, out_value=np.int32)


def cogroup(bs, mod, n):
    ka, va = _data(12, n=600, span=80)
    kb, vb = _data(13, n=400, span=80)
    return bs.Cogroup(bs.Const(2 * n, ka, va), bs.Const(2 * n, kb, vb))


def host_to_mesh(bs, mod, n):
    k, v = _data(14)
    host = bs.Map(bs.Const(2 * n, k, v),
                  lambda a, b: (int(a) % 97, int(b)),
                  out=[np.int32, np.int32])
    return bs.Reduce(host, lambda a, b: a + b)


def mesh_to_host(bs, mod, n):
    k, v = _data(15)
    red = bs.Reduce(bs.Const(2 * n, k, v), lambda a, b: a + b)
    return bs.Map(red, lambda a, b: (f"id{int(a)}", int(b) * 2),
                  out=[str, np.int32])


def hash_overflow(bs, mod, n):
    k, v = _skewed()
    return bs.Reduce(bs.Const(2, k, v), lambda a, b: a + b)


def const_map(bs, mod, n):
    k, v = _data(18)
    return bs.Map(bs.Const(4 * n, k, v), lambda a, b: (a, b * 2))


def filter_map_chain(bs, mod, n):
    k, v = _data(19)
    return bs.Reduce(bs.Map(bs.Filter(bs.Const(4 * n, k, v),
                                      lambda a, b: a % 3 == 0),
                            lambda a, b: (a % 5, b)),
                     lambda a, b: a + b)


def head(bs, mod, n):
    k, v = _data(20)
    return bs.Head(bs.Const(2 * n, k, v), 5)


def map_args(bs, mod, n):
    k, v = _data(21)
    return bs.Map(bs.Const(2 * n, k, v), lambda a, b, c: (a, b + c),
                  args=(7,))


def flatmap(bs, mod, n):
    def dup(x):
        mask = mod.stack([x == x, x % 2 == 0])
        return mask, mod.stack([x, x + 1000])

    fm = bs.Flatmap(bs.Const(2 * n, np.arange(64, dtype=np.int32)), dup,
                    out=[np.int32], fanout=2)
    return bs.Reduce(bs.Map(fm, lambda x: (x % 4, x)), lambda a, b: a + b)


def reshard_down(bs, mod, n):
    src = bs.Const(2 * n, np.arange(64, dtype=np.int32))
    return bs.Reshard(bs.Prefixed(src, 1), 3)


def prefixed(bs, mod, n):
    k, v = _data(22)
    return bs.Reduce(bs.Prefixed(bs.Const(2 * n, k % 7, k % 11, v), 2),
                     lambda a, b: a + b)


def wave_chain(bs, mod, n):
    k, v = _data(23)
    return bs.Filter(bs.Map(bs.Const(4 * n, k, v), lambda a, b: (a, b + 1)),
                     lambda a, b: b > 0)


SCENARIOS = {f.__name__.replace("_", "-"): f for f in (
    reduce_k2, reduce_sort, reduce_float, reduce_padded, reduce_dense,
    reshuffle, repartition, join, groupby, fold, cogroup, host_to_mesh,
    mesh_to_host, hash_overflow, const_map, filter_map_chain, head,
    map_args, flatmap, reshard_down, prefixed, wave_chain)}


def reuse(bs, mod, n, run):
    """Result reuse across runs: a Reduce's result, then a device Map
    over it in a second run."""
    k, v = _data(16)
    res = run(bs.Reduce(bs.Const(2 * n, k, v), lambda a, b: a + b))
    return run(bs.Map(res, lambda a, b: (a, b * 3)))


def attend(bs, n):
    """A SelfAttend over 1 < S <= N shards (S = N)."""
    rng = np.random.RandomState(17)
    q, k, v = (rng.randn(64, 8).astype(np.float32) * 0.3 for _ in "qkv")
    return bs.SelfAttend(bs.Const(n, q, k, v), causal=True)


def main(out_dir: str, names=()) -> int:
    import torch

    torch.set_num_threads(1)
    import bigslice_tpu_torch as bst
    from bigslice_tpu_torch.exec.spmd import spmd_session
    from bigslice_tpu_torch.utils import distributed

    funcs = {name: bst.func(lambda n, f=f: f(bst, torch, n))
             for name, f in SCENARIOS.items()}
    distributed.initialize(device="cpu")
    rank = distributed.process_index()
    n = distributed.process_count()
    sess = spmd_session()
    ex = sess.executor
    out = {"rows": {}, "hash_off": {}, "errors": {}}
    for name, fn in funcs.items():
        if names and name not in names:
            continue
        print("scenario", name, file=sys.stderr, flush=True)
        try:
            before = set(ex.hash_off)
            out["rows"][name] = bst.result_shard_rows(sess.run(fn, n))
            out["hash_off"][name] = sorted(set(ex.hash_off) - before)
        except Exception as e:  # noqa: BLE001 — reported to the test
            out["errors"][name] = repr(e)
    out["rows"]["reuse"] = bst.result_shard_rows(
        reuse(bst, torch, n, sess.run))
    out["rows"]["attend"] = bst.result_shard_rows(sess.run(attend(bst, n)))
    out["attend_methods"] = dict(ex.attend_methods)
    out["cogroup_caps"] = sorted(ex.cogroup_caps.values())
    out["collectives"] = dict(ex.mesh.collectives)
    out["backend"] = ex.mesh.backend
    out["nmesh"] = ex.nmesh
    out["modules"] = sorted(m for m in ("jax", "bigslice_tpu")
                            if m in sys.modules)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    ex.mesh.barrier()
    sess.shutdown()
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2:]))
