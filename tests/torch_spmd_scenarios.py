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

Two more suites share the program: ``OUT --hostdist`` (the host tier
over ranks: each host task's owner, what each rank fetched, the rows of
a word count and a host Cogroup) and ``OUT --hier`` (run with
``BIGSLICE_MESH_SHAPE=2x2`` on 4 ranks: every ``HIER_SCENARIOS``
pipeline on the 2-D mesh and on a flat mesh over the same ranks, the
standalone two-stage shuffles, the spill plan and the elastic rules).
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


def reduce_vector(bs, mod, n):
    """[n, 4] int32 rows through the hash lowering and the exchange of
    table regions over the ranks: 300 sparse keys (so that discovery
    declares no dense bound)."""
    rng = np.random.RandomState(24)
    k = rng.randint(0, 1 << 24, 300).astype(np.int32)[
        rng.randint(0, 300, ROWS)]
    v = rng.randint(-1000, 1000, (ROWS, 4)).astype(np.int32)
    return bs.Reduce(bs.Const(4 * n, k, v), lambda a, b: a + b)


SCENARIOS = {f.__name__.replace("_", "-"): f for f in (
    reduce_k2, reduce_sort, reduce_float, reduce_padded, reduce_dense,
    reshuffle, repartition, join, groupby, fold, cogroup, host_to_mesh,
    mesh_to_host, hash_overflow, const_map, filter_map_chain, head,
    map_args, flatmap, reshard_down, prefixed, wave_chain, reduce_vector)}


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


def _mha(n):
    rng = np.random.RandomState(29)
    return [rng.randn(96, 16).astype(np.float32) * 0.3 for _ in "qkv"]


def attend_ring(bs, n):
    """Two heads of 8 over S = N shards through the ring (K/V rotated
    around the slots)."""
    return bs.SelfAttend(bs.Const(n, *_mha(n)), causal=True, heads=2,
                         method="ring")


def attend_ulysses(bs, n):
    """The same through Ulysses (heads re-sharded over the slots)."""
    return bs.SelfAttend(bs.Const(n, *_mha(n)), causal=True, heads=2,
                         method="ulysses")


ATTEND = {"attend": attend, "attend-ring": attend_ring,
          "attend-ulysses": attend_ulysses}


# -- the host tier over ranks (exec/hostdist.py) ---------------------------


def _lines(seed: int = 31, n: int = 400):
    rng = np.random.RandomState(seed)
    words = [f"w{int(z) % 97}" for z in rng.zipf(1.4, n * 6)]
    return [" ".join(words[i * 6:(i + 1) * 6]) for i in range(n)]


def wordcount(bs, n):
    """The host tier's word count: str keys through host functions."""
    lines = _lines()
    words = bs.Flatmap(bs.ScanReader(2 * n, lambda: iter(lines)),
                       lambda line: [(w,) for w in line.split()],
                       out=[str])
    pairs = bs.Map(words, lambda w: (w, 1), out=[str, np.int32])
    return bs.Reduce(pairs, lambda a, b: a + b)


def host_cogroup(bs, n):
    """A Cogroup over host-tier inputs (str keys): the host tier's."""
    ka, va = _data(32, n=300, span=40)
    kb, vb = _data(33, n=200, span=40)
    a = bs.Map(bs.Const(2 * n, ka, va), lambda k, v: (f"k{int(k)}", int(v)),
               out=[str, np.int32])
    b = bs.Map(bs.Const(2 * n, kb, vb), lambda k, v: (f"k{int(k)}", int(v)),
               out=[str, np.int32])
    return bs.Cogroup(a, b)


HOSTDIST = {"wordcount": wordcount, "host-cogroup": host_cogroup}


def hostdist_main(out_dir: str) -> int:
    import torch

    torch.set_num_threads(1)
    import bigslice_tpu_torch as bst
    from bigslice_tpu_torch.exec.spmd import spmd_session
    from bigslice_tpu_torch.utils import distributed

    funcs = {name: bst.func(lambda n, f=f: f(bst, n))
             for name, f in HOSTDIST.items()}
    distributed.initialize(device="cpu")
    rank, n = distributed.process_index(), distributed.process_count()
    sess = spmd_session()
    hd = sess.executor._hostdist
    out = {"rows": {}, "owned": {}, "remote": {}, "fetched": {}}
    for name, fn in funcs.items():
        o0, r0, f0 = (len(hd.owned_tasks), len(hd.remote_tasks),
                      len(hd.fetched))
        out["rows"][name] = bst.result_shard_rows(sess.run(fn, n))
        out["owned"][name] = hd.owned_tasks[o0:]
        out["remote"][name] = hd.remote_tasks[r0:]
        out["fetched"][name] = hd.fetched[f0:]
    out["modules"] = sorted(m for m in ("jax", "bigslice_tpu")
                            if m in sys.modules)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    sess.executor.mesh.barrier()
    sess.shutdown()
    distributed.shutdown()
    return 0


# -- the 2-D mesh (parallel/hier.py) ----------------------------------------


def _hkeyed(rows=6000, nkeys=251, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, nkeys, rows).astype(np.int32),
            rng.randint(0, 50, rows).astype(np.int32))


def h_reduce(bs, mod, n):
    return bs.Reduce(bs.Const(2 * n, *_hkeyed()), lambda a, b: a + b)


def h_reduce_waved(bs, mod, n):
    k, v = _hkeyed(rows=4000, nkeys=97, seed=9)
    return bs.Reduce(bs.Const(4 * n, k, v), lambda a, b: a + b)


def h_reduce_float(bs, mod, n):
    k, _ = _hkeyed(rows=3000, nkeys=113, seed=21)
    v = np.random.RandomState(21).rand(3000).astype(np.float32)
    return bs.Reduce(bs.Const(2 * n, k, v), lambda a, b: a + b)


def h_reduce_sort(bs, mod, n):
    k, v = _hkeyed(rows=3000, nkeys=173, seed=23)
    return bs.Reduce(bs.Const(2 * n, k, v), lambda a, b: a ^ b)


def h_shuffle(bs, mod, n):
    rng = np.random.RandomState(3)
    keys = rng.randint(0, 1000, 3000).astype(np.int32)
    return bs.Reshuffle(bs.Const(2 * n, keys, np.arange(3000,
                                                        dtype=np.int32)))


def h_repartition(bs, mod, n):
    k, v = _hkeyed(rows=2000, nkeys=500, seed=25)
    return bs.Repartition(bs.Const(2 * n, k, v), lambda k, m: k % m)


def h_join(bs, mod, n):
    rng = np.random.RandomState(7)
    ak = rng.randint(0, 97, 2000).astype(np.int32)
    bk = rng.randint(0, 97, 1500).astype(np.int32)
    return bs.JoinAggregate(bs.Const(2 * n, ak, np.ones(2000, np.int32)),
                            bs.Const(2 * n, bk, np.full(1500, 2, np.int32)),
                            lambda a, b: a + b, lambda a, b: a + b)


def h_groupby(bs, mod, n):
    rng = np.random.RandomState(11)
    keys = rng.randint(0, 40, 1200).astype(np.int32)
    vals = rng.randint(0, 9, 1200).astype(np.int32)
    return bs.GroupByKey(bs.Const(2 * n, keys, vals), capacity=64)


def h_cogroup(bs, mod, n):
    rng = np.random.RandomState(19)
    ka = rng.randint(0, 40, 1200).astype(np.int32)
    kb = rng.randint(0, 40, 900).astype(np.int32)
    return bs.Cogroup(bs.Const(2 * n, ka, rng.randint(0, 9, 1200).astype(
        np.int32)), bs.Const(2 * n, kb, rng.randint(0, 9, 900).astype(
            np.int32)))


HIER_SCENARIOS = {f.__name__[2:].replace("_", "-"): f for f in (
    h_reduce, h_reduce_waved, h_reduce_float, h_reduce_sort, h_shuffle,
    h_repartition, h_join, h_groupby, h_cogroup)}


def _unit_shuffles(grid):
    """The standalone two-stage shuffles on this rank's slot (the rows
    the reference's tests/test_hier.py feeds each device)."""
    import torch

    from bigslice_tpu_torch.parallel import hier

    r, n = grid.rank, grid.size
    out = {}
    rng = np.random.RandomState(7)
    kc = [rng.randint(0, 1000, 100).astype(np.int32) for _ in range(n)]
    vc = [np.arange(100, dtype=np.int32) + 1000 * s for s in range(n)]
    cap = 256

    def pad(x):
        return torch.from_numpy(np.concatenate(
            [x, np.zeros(cap - len(x), x.dtype)]))

    sh = hier.HierMeshShuffle(grid, ncols=2, nkeys=1, capacity=cap)
    cols, cnt, ov = sh([pad(kc[r]), pad(vc[r])], [100])
    m = int(cnt[0])
    out["shuffle"] = (sorted(zip(cols[0][:m].tolist(),
                                 cols[1][:m].tolist())), int(ov))
    hot = hier.HierMeshShuffle(grid, ncols=1, nkeys=1, capacity=16)
    out["overflow"] = int(hot([torch.full((16,), 3, dtype=torch.int32)],
                              [16])[2])
    keys = np.arange(32, dtype=np.int32) + r * 32
    custom = hier.HierMeshShuffle(
        grid, ncols=1, nkeys=1, capacity=128,
        partition_fn=lambda k: (k % 3).to(torch.int32))
    cols, cnt, ov = custom([pad(keys)[:128]], [32])
    out["custom"] = (int(cnt[0]), int(ov))
    rng = np.random.RandomState(12)
    kr = [rng.randint(0, 41, 150).astype(np.int32) for _ in range(n)]
    vr = [rng.randint(0, 10, 150).astype(np.int32) for _ in range(n)]
    cap = 512
    red = hier.HierMeshReduceByKey(grid, nkeys=1, nvals=1, capacity=cap,
                                   combine_fn=lambda a, b: a + b)
    kk, vv, cnt, ov = red([pad(kr[r])], [pad(vr[r])], [150])
    m = int(cnt[0])
    out["reduce"] = (sorted(zip(kk[0][:m].tolist(), vv[0][:m].tolist())),
                     int(ov))
    return out


def hier_main(out_dir: str) -> int:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    import bigslice_tpu_torch as bst
    from bigslice_tpu_torch.exec.meshexec import MeshExecutor
    from bigslice_tpu_torch.exec.session import Session
    from bigslice_tpu_torch.exec.spmd import spmd_session
    from bigslice_tpu_torch.parallel import meshutil
    from bigslice_tpu_torch.utils import distributed

    funcs = {name: bst.func(lambda n, f=f: f(bst, torch, n))
             for name, f in HIER_SCENARIOS.items()}
    distributed.initialize(device="cpu")
    rank, n = distributed.process_index(), distributed.process_count()
    grid = distributed.global_mesh()            # BIGSLICE_MESH_SHAPE=2x2
    flat = meshutil.Mesh(dist.group.WORLD, device="cpu")
    out = {"rows": {}, "flat": {}, "waved": {}, "mesh": repr(grid),
           "is_hier": grid.is_hier, "topology": meshutil.MeshTopology(
               grid).signature()}
    out["units"] = _unit_shuffles(grid)
    sess, fsess = spmd_session(), spmd_session(mesh=flat)
    for name, fn in funcs.items():
        out["rows"][name] = bst.result_shard_rows(sess.run(fn, n))
        out["flat"][name] = bst.result_shard_rows(fsess.run(fn, n))
    out["summary"] = sess.telemetry_summary()["device"]
    out["flat_summary"] = fsess.telemetry_summary()["device"]
    out["collectives"] = dict(grid.collectives)
    out["axis_bytes"] = dict(grid.axis_bytes)
    # The waved path across the prefetch x arena matrix.
    for prefetch in (0, 2):
        for arena in (True, False):
            s2 = Session(executor=MeshExecutor(
                mesh=grid, prefetch_depth=prefetch, staging_arena=arena))
            out["waved"][(prefetch, arena)] = bst.result_shard_rows(
                s2.run(funcs["reduce-waved"], n))
            s2.shutdown()
    # The spill plan over the two-stage exchange.
    os.environ["BIGSLICE_SHUFFLE"] = "spill"
    try:
        s3 = spmd_session()
        out["spill"] = bst.result_shard_rows(s3.run(funcs["reduce-waved"],
                                                    n))
        out["spill_plan"] = s3.telemetry_summary()["device"].get(
            "shuffle_plan", {})
        s3.shutdown()
    finally:
        del os.environ["BIGSLICE_SHUFFLE"]
    # Elastic over ranks: no coordinated provider, so the gang loss
    # re-raises (the JAX package's scope); the lost attempt is fatal.
    from bigslice_tpu_torch.utils import faultinject

    faultinject.install(faultinject.parse_plan("9:mesh.dispatch=1.0x1~"
                                               "hostloss"))
    try:
        s4 = spmd_session(elastic=1)
        try:
            s4.run(funcs["reduce"], n)
            out["elastic"] = None
        except Exception as e:  # noqa: BLE001 — reported to the test
            out["elastic"] = repr(e)
        out["elastic_provider"] = s4.mesh_provider()
    finally:
        faultinject.clear()
    out["fleet_device"] = sess.telemetry_summary(scope="fleet")["device"]
    out["flat_fleet_device"] = fsess.telemetry_summary(
        scope="fleet")["device"]
    # A degraded recovery: the grid's executor moved onto this rank's
    # one-slot mesh still computes (each rank all of it).
    flat.barrier()
    s5 = spmd_session()
    s5.executor.resize(meshutil.Mesh(None, device="cpu"))
    out["resized"] = (s5.executor.nmesh, s5.executor.mesh.is_hier,
                      bst.result_shard_rows(s5.run(funcs["reduce"], n)))
    out["modules"] = sorted(m for m in ("jax", "bigslice_tpu")
                            if m in sys.modules)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    flat.barrier()
    fsess.shutdown()
    sess.shutdown()
    distributed.shutdown()
    return 0


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
    for name, f in ATTEND.items():
        if not names or name in names:
            out["rows"][name] = bst.result_shard_rows(sess.run(f(bst, n)))
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
    if sys.argv[2:3] == ["--hostdist"]:
        sys.exit(hostdist_main(sys.argv[1]))
    if sys.argv[2:3] == ["--hier"]:
        sys.exit(hier_main(sys.argv[1]))
    sys.exit(main(sys.argv[1], sys.argv[2:]))
