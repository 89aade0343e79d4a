"""Ranks across real process boundaries: the launcher and its smoke.

``launch(n, cmd, deadline_s)`` starts ``n`` fresh processes of ``cmd``
(``subprocess``, never ``fork``) with torchrun's variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``). When a rank exits non-zero, or
the deadline passes, it kills the surviving ranks (their peers may sit
inside a collective forever), and the result carries each rank's exit
code and stderr; ``tools/run.py -launch`` and the tests use it.

The smoke (``python -m bigslice_tpu_torch.tools.multihost_smoke [N]
[--device cpu]``) runs N ranks, each of which

- joins the group and checks the Func registry's digest on every rank
  (``utils.distributed.initialize``);
- runs the data-parallel k-means step (``mesh_kmeans_step``, its sums
  and counts summed over the ranks) against a one-rank step over all
  the points;
- runs the keyed Reduce through ``MeshExecutor`` over the N slots
  (K2's map-side combine, K1's routing, the all_to_all exchange, the
  merge), a registered Func, one counted run and ``--warm`` timed ones,
  and checks every shard's rows against numpy and each row's shard
  against the routing hash;
- runs a host-tier word count (str keys, reference
  tools/multihost_smoke.py:259-361) through the host-task exchange
  (``exec/hostdist.py``): every rank owns some host tasks and waits on
  its peers for the rest, the counts equal the words' own, after the run
  only the result's namespaces stay published, and after every rank
  closed its session none does;

and writes a JSON report a rank under ``--out``; the parent prints one
summary line and exits 0 when every rank passed. ``--mode`` selects a
contract check instead: ``wedge`` (rank 1 stops beating; rank 0 must
raise ``PeerLostError`` before its next collective), ``fail`` (rank 1
raises while rank 0 waits in a collective: the launcher must end the
gang), ``infra`` (rank 1 alone meets an injected infra error at its
first group: it must fail by name, never retry the group alone, and
rank 0 must fail once it has gone), ``registry`` (rank 1 registers one
more Func: every rank must raise, naming rank 1) and ``nccl1`` (one
rank over NCCL runs the exchange seam's own path on int32, uint32 and
bool planes). Two more modes are the ranks of ``chip_smoke.py``'s phase
33: ``hier`` (run with ``BIGSLICE_MESH_SHAPE=DxI``: the keyed Reduce on
the 2-D mesh and on a flat mesh over the same ranks, each shard's rows
checked and compared, the bytes and host seconds of each stage, the
fleet export under ``--fleet-dir``) and ``plane`` (the host tier's word
count of ``--corpus`` through the host-task exchange, then SelfAttend
over the ranks on ``--att``'s q, k, v through the ring and Ulysses in
fp32 and bf16, each rank's stage timed).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, NamedTuple, Optional


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class LaunchResult(NamedTuple):
    rc: int                     # 0 when every rank exited 0
    rcs: List[Optional[int]]    # each rank's exit code (None: killed)
    stdout: List[str]           # each rank's stdout ("" when relayed)
    stderr: List[str]           # each rank's stderr
    seconds: float
    timed_out: bool


def _kill(p: subprocess.Popen) -> None:
    if p.poll() is not None:
        return
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        p.kill()


def launch(n: int, cmd: List[str], deadline_s: float, env=None,
           relay: bool = False, tail_lines: int = 30) -> LaunchResult:
    """Run ``cmd`` as ``n`` ranks and wait for them, at most
    ``deadline_s`` seconds. ``env`` adds to the environment. With
    ``relay`` the ranks' stdout passes through and their stderr is
    printed after them; else both are captured. On a failure each
    rank's stderr tail goes to this process's stderr, and ``rc`` is the
    first failing rank's code (128 + signal for a signal, 124 for the
    deadline)."""
    port = _free_port()
    tmp = tempfile.mkdtemp(prefix="bigslice-launch-")
    procs, outs, errs = [], [], []
    t0 = time.monotonic()
    try:
        for r in range(n):
            e = dict(os.environ)
            e.update(env or {})
            e.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                     LOCAL_WORLD_SIZE=str(n))
            err = open(os.path.join(tmp, f"rank{r}.err"), "w+b")
            out = None if relay else open(os.path.join(tmp, f"rank{r}.out"),
                                          "w+b")
            errs.append(err)
            outs.append(out)
            procs.append(subprocess.Popen(cmd, env=e, stdout=out, stderr=err,
                                          start_new_session=True))
        timed_out = False
        failed = None
        while True:
            rcs = [p.poll() for p in procs]
            bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if all(rc == 0 for rc in rcs):
                break
            if time.monotonic() - t0 > deadline_s:
                timed_out = True
                break
            time.sleep(0.05)
        for p in procs:
            _kill(p)
        for p in procs:
            p.wait()
        rcs = [p.returncode for p in procs]
        seconds = time.monotonic() - t0

        def read(f) -> str:
            if f is None:
                return ""
            f.seek(0)
            return f.read().decode(errors="replace")

        stdout = [read(f) for f in outs]
        stderr = [read(f) for f in errs]
    finally:
        for f in outs + errs:
            if f is not None:
                f.close()
        for name in os.listdir(tmp):
            os.unlink(os.path.join(tmp, name))
        os.rmdir(tmp)
    if timed_out:
        rc = 124
    elif failed is not None:
        code = rcs[failed]
        rc = code if code > 0 else 128 - code
    else:
        rc = 0
    if rc != 0:
        why = (f"deadline {deadline_s:.0f}s passed" if timed_out
               else f"rank {failed} exited {rcs[failed]}")
        print(f"launch: {why}; the other ranks were stopped",
              file=sys.stderr)
        for r, text in enumerate(stderr):
            tail = "\n".join(text.rstrip().splitlines()[-tail_lines:])
            print(f"--- rank {r} (exit {rcs[r]}) stderr tail ---\n{tail}",
                  file=sys.stderr)
    elif relay:
        for text in stderr:
            sys.stderr.write(text)
    return LaunchResult(rc, rcs, stdout, stderr, seconds, timed_out)


# -- the smoke's ranks --------------------------------------------------------


def _report(out_dir: str, rank: int, report: dict) -> None:
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(report, fh)


def _kmeans_check(mesh, rank: int, n: int, args) -> dict:
    import numpy as np
    import torch

    from bigslice_tpu_torch.models.kmeans import (kmeans_step,
                                                  mesh_kmeans_step)

    # An IVF training set's shape (chip_smoke.py's phase 27e): points
    # around k centres, so that no point sits on a tie between two.
    rng = np.random.default_rng(args.seed)
    centres = rng.normal(0.0, 10.0, (args.k, args.dim))
    labels = rng.integers(0, args.k, args.points)
    pts = (centres[labels] + rng.standard_normal(
        (args.points, args.dim))).astype(np.float32)
    cents = pts[: args.k].copy()
    lo, hi = rank * args.points // n, (rank + 1) * args.points // n
    step = mesh_kmeans_step(mesh, args.k, args.dim)
    local = torch.from_numpy(pts[lo:hi]).to(mesh.device)
    c = torch.from_numpy(cents).to(mesh.device)
    _sync(mesh.device)
    t0 = time.perf_counter()
    got = step(local, c)
    _sync(mesh.device)
    mesh_s = time.perf_counter() - t0
    want = kmeans_step(torch.from_numpy(pts).to(mesh.device), c)
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    return {"kmeans_max_abs_err": err, "kmeans_mesh_s": mesh_s,
            "kmeans_ok": bool(np.isfinite(err)
                              and err <= args.kmeans_tol * scale
                              and tuple(got.shape) == (args.k, args.dim))}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reduce_check(mesh, args) -> dict:
    import numpy as np
    import torch

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.meshexec import MeshExecutor
    from bigslice_tpu_torch.parallel import cuda_kernels
    from bigslice_tpu_torch.parallel import shuffle as shuffle_mod

    @bs.func
    def reduce_wave(shards: int, rows: int, keyspace: int, seed: int):
        rng = np.random.RandomState(seed)
        keys = rng.randint(0, keyspace, rows).astype(np.int32)
        return bs.Reduce(bs.Const(shards, keys, np.ones(rows, np.int32)),
                         lambda a, b: a + b)

    ex = MeshExecutor(mesh=mesh, auto_dense=False)
    sess = bs.Session(executor=ex)
    fargs = (args.shards, args.rows, args.keyspace, 42)
    before = dict(cuda_kernels.LAUNCHES)
    ex0 = mesh.exchanged_bytes
    _sync(mesh.device)
    t0 = time.perf_counter()
    res = sess.run(reduce_wave, *fargs)
    rows = bs.result_shard_rows(res)
    counted_s = time.perf_counter() - t0
    launches = {k: v - before.get(k, 0)
                for k, v in cuda_kernels.LAUNCHES.items()
                if v - before.get(k, 0)}
    exchanged = mesh.exchanged_bytes - ex0
    counted_coll = dict(mesh.collective_s)
    walls = []
    for _ in range(args.warm):
        _sync(mesh.device)
        t0 = time.perf_counter()
        bs.result_shard_rows(sess.run(reduce_wave, *fargs))
        walls.append(time.perf_counter() - t0)
    # Host seconds inside each kind of collective, a warm run's mean.
    warm_coll = {k: (v - counted_coll.get(k, 0.0)) / max(1, args.warm)
                 for k, v in mesh.collective_s.items()}
    # Every row against numpy, and in the shard the routing hash names
    # (K1's plain version on the host).
    keys = np.random.RandomState(42).randint(
        0, args.keyspace, args.rows).astype(np.int32)
    want = np.bincount(keys, minlength=args.keyspace)
    got_keys, got_vals, placed = [], [], True
    for s, (k, v) in enumerate(rows):
        part, _, _ = shuffle_mod.partition_ids(
            [torch.from_numpy(k)], args.shards, 0)
        placed &= bool((part.numpy() == s).all())
        got_keys.append(k)
        got_vals.append(v)
    k = np.concatenate(got_keys)
    v = np.concatenate(got_vals)
    nz = np.nonzero(want)[0]
    rows_ok = (len(k) == len(nz) and len(np.unique(k)) == len(k)
               and bool((want[k] == v).all()))
    sess.shutdown()
    return {"reduce_rows_ok": bool(rows_ok), "reduce_placed_ok": placed,
            "reduce_counted_s": counted_s, "reduce_warm_s": walls,
            "launches": launches, "exchanged_bytes": exchanged,
            "warm_collective_s": warm_coll,
            "hash_off": sorted(ex.hash_off), "shard_rows":
            [int(len(r[0])) for r in rows]}


def _hostdist_check(mesh) -> dict:
    """The host tier over the ranks: a word count whose host tasks run
    once, each on its owner (``shard % N``), the outputs exchanged
    through the group's store and fetched when read."""
    import numpy as np

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.spmd import spmd_session

    vocab = ["gpu", "mesh", "nvlink", "hbm", "sm"]

    def gen_lines(shard):
        yield ([" ".join(vocab[(shard + j + i) % len(vocab)]
                         for j in range(3)) for i in range(6)],)

    @bs.func
    def host_wordcount(shards: int):
        lines = bs.ReaderFunc(shards, gen_lines, out=[str])
        words = bs.Flatmap(lines, lambda line: [(w,) for w in line.split()],
                           out=[str])
        ones = bs.Map(words, lambda w: (w, 1), out=[str, np.int32])
        return bs.Reduce(ones, lambda a, b: a + b)

    sess = spmd_session(mesh=mesh)
    hd = sess.executor._hostdist
    t0 = time.perf_counter()
    got = dict(sess.run(host_wordcount, 4).rows())
    seconds = time.perf_counter() - t0
    want: dict = {}
    for shard in range(4):
        for (batch,) in gen_lines(shard):
            for line in batch:
                for w in line.split():
                    want[w] = want.get(w, 0) + 1
    split = mesh.all_gather([hd.owned_count, hd.remote_count])
    # The run's release kept only its roots (the Reduce's tasks) in the
    # store.
    published = sorted(hd._published)
    roots_only = bool(published) and all("reduce" in k for k in published)
    mesh.barrier()  # a peer may still fetch this rank's roots
    sess.shutdown()
    mesh.barrier()
    return {"hostdist_rows_ok": got == want,
            "hostdist_split": split,
            "hostdist_split_ok": all(o > 0 and r > 0 for o, r in split),
            "hostdist_roots_only": roots_only,
            "hostdist_closed_clean": not hd._published and not hd._keys,
            "hostdist_fetched": len(hd.fetched),
            "hostdist_s": seconds}


def _shard_digest(cols) -> str:
    import hashlib

    h = hashlib.sha256()
    for c in cols:
        h.update(c.tobytes())
    return h.hexdigest()[:16]


def _hier_mode(args, rank: int, n: int, report: dict) -> int:
    """Phase 33a/d's ranks: the keyed Reduce over ``--rows`` keys uniform
    over ``--keyspace`` (RandomState(42)) at ``--shards`` shards on the
    2-D mesh, then on a flat mesh over the same ranks, then on the 2-D
    mesh again (warm): every shard's
    rows against numpy and the shard the plain K1 names, the two
    layouts' shards equal (by digest), K1 and K2 launched, the bytes and
    host seconds of each stage; the 2-D session exports its fleet
    snapshot, and rank 0 merges the fleet."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.meshexec import MeshExecutor
    from bigslice_tpu_torch.parallel import cuda_kernels, meshutil
    from bigslice_tpu_torch.parallel import shuffle as shuffle_mod
    from bigslice_tpu_torch.utils import distributed

    @bs.func
    def reduce_wave(shards: int, rows: int, keyspace: int, seed: int):
        rng = np.random.RandomState(seed)
        keys = rng.randint(0, keyspace, rows).astype(np.int32)
        return bs.Reduce(bs.Const(shards, keys, np.ones(rows, np.int32)),
                         lambda a, b: a + b)

    distributed.initialize(device=args.device, backend=args.backend)
    grid = distributed.global_mesh()
    flat = meshutil.Mesh(dist.group.WORLD, device=grid.device)
    report.update(backend=grid.backend, transport=grid.transport,
                  is_hier=grid.is_hier, shape=list(grid.shape))
    keys = np.random.RandomState(42).randint(
        0, args.keyspace, args.rows).astype(np.int32)
    want = np.bincount(keys, minlength=args.keyspace)
    nz = np.nonzero(want)[0]
    fargs = (args.shards, args.rows, args.keyspace, 42)
    ok = True
    # The grid's first run pays the process's first-use costs (its
    # subgroups' connections among them); its second is the warm one.
    for name, mesh in (("hier", grid), ("flat", flat), ("hier-warm", grid)):
        ex = MeshExecutor(mesh=mesh, auto_dense=False)
        sess = bs.Session(executor=ex, fleet_dir=(
            args.fleet_dir if name == "hier" else None))
        before = dict(cuda_kernels.LAUNCHES)
        b0, s0 = dict(mesh.axis_bytes), dict(mesh.collective_s)
        x0 = mesh.exchanged_bytes
        _sync(mesh.device)
        t0 = time.perf_counter()
        rows = bs.result_shard_rows(sess.run(reduce_wave, *fargs))
        wall = time.perf_counter() - t0
        placed = True
        for sh, (k, _) in enumerate(rows):
            part, _, _ = shuffle_mod.partition_ids(
                [torch.from_numpy(k)], args.shards, 0)
            placed &= bool((part.numpy() == sh).all())
        k = np.concatenate([r[0] for r in rows])
        v = np.concatenate([r[1] for r in rows])
        rows_ok = (len(k) == len(nz) and len(np.unique(k)) == len(k)
                   and bool((want[k] == v).all()))
        report[name] = {
            "rows_ok": rows_ok, "placed_ok": placed, "wall_s": wall,
            "launches": {kk: vv - before.get(kk, 0) for kk, vv in
                         cuda_kernels.LAUNCHES.items()},
            "axis_bytes": {kk: vv - b0.get(kk, 0)
                           for kk, vv in mesh.axis_bytes.items()},
            "exchanged_bytes": mesh.exchanged_bytes - x0,
            "collective_s": {kk: vv - s0.get(kk, 0.0)
                             for kk, vv in mesh.collective_s.items()},
            "digests": [_shard_digest(r) for r in rows],
            "hash_off": sorted(ex.hash_off)}
        ok &= rows_ok and placed
        if name == "hier":
            sess.fleet.export()
            mesh.barrier()  # every rank's snapshot is written
            if rank == 0:
                with open(os.path.join(args.out, "fleet_merged.json"),
                          "w") as fh:
                    json.dump(sess.fleet.fleet_summary(wait_for_all=True),
                              fh, default=str)
            mesh.barrier()
        sess.shutdown()
    report["same_shards"] = (report["hier"]["digests"]
                             == report["flat"]["digests"]
                             == report["hier-warm"]["digests"])
    report["ok"] = bool(ok and report["same_shards"] and grid.is_hier
                        and "jax" not in sys.modules
                        and "bigslice_tpu" not in sys.modules)
    _report(args.out, rank, report)
    flat.barrier()
    distributed.shutdown()
    return 0 if report["ok"] else 1


def _stage_ms(device, fn) -> float:
    """Milliseconds of ``fn()``: between CUDA events on the card, by the
    host's clock on the CPU."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _plane_mode(args, rank: int, n: int, report: dict) -> int:
    """Phase 33b/c's ranks. (b) the host tier's word count of
    ``--corpus`` (``models.wordcount.wordcount(4, path)``): the counts
    against collections.Counter, each host task owned by exactly one
    rank, and the remote partitions this rank fetched exactly those it
    read (its consumers' inputs and the result scan's shards). (c)
    SelfAttend over the ranks (S = N, causal, 2 heads) on ``--att``'s
    q, k, v through the ring (``block_q`` 128) and Ulysses in fp32 and
    bf16: rank 0 writes each output for the parent to hold against the
    oracle, and each rank times its attend stage over its own block
    (CUDA events, median of 3)."""
    import collections

    import numpy as np
    import torch

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.meshexec import StagedInput
    from bigslice_tpu_torch.exec.spmd import spmd_session
    from bigslice_tpu_torch.frame.frame import to_numpy
    from bigslice_tpu_torch.models.wordcount import wordcount
    from bigslice_tpu_torch.parallel import meshutil
    from bigslice_tpu_torch.utils import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    att_cols = dict(np.load(args.att))
    q, k, v = (att_cols[c] for c in "qkv")
    seq = len(q)

    @bs.func
    def host_wordcount(shards: int, path: str):
        return wordcount(shards, path)

    attends = {}
    for method, dt in (("ring", "float32"), ("ulysses", "float32"),
                       ("ring", "bfloat16"), ("ulysses", "bfloat16")):
        attends[f"{method}-{dt}"] = bs.func(
            lambda shards, method=method, dt=dt: bs.SelfAttend(
                bs.Const(shards, q, k, v), causal=True, heads=2,
                method=method, dtype=getattr(torch, dt),
                block_q=128 if method == "ring" else 0))
    distributed.initialize(device=args.device, backend=args.backend)
    mesh = distributed.global_mesh()
    sess = spmd_session(mesh=mesh)
    hd = sess.executor._hostdist
    # (b) the word count.
    t0 = time.perf_counter()
    res = sess.run(host_wordcount, 4, args.corpus)
    got = dict(res.rows())
    report["wordcount_s"] = time.perf_counter() - t0
    with open(args.corpus) as fh:
        want = collections.Counter(fh.read().split())
    owned = mesh.all_gather_object(list(hd.owned_tasks))
    everyone = [t for o in owned for t in o]
    remote = set(hd.remote_tasks)
    # What this rank read of remote tasks: partition p of each remote
    # producer for each consumer shard p it owns, and every remote
    # result shard (its scan).
    mine = [t for t in hd.owned_tasks if "reduce" in t]
    expect = {(t, int(c.rsplit(":", 1)[1])) for c in mine
              for t in remote if "reduce" not in t}
    expect |= {(t, 0) for t in remote if "reduce" in t}
    report.update(
        wordcount_ok=got == dict(want),
        host_tasks=len(everyone), owned=len(hd.owned_tasks),
        remote=len(remote), fetched=len(hd.fetched),
        once_ok=(len(everyone) == len(set(everyone))
                 and set(everyone) == set(hd.owned_tasks) | remote),
        fetched_ok=set(hd.fetched) == expect)
    # (c) attention over the ranks.
    lo, hi = rank * seq // n, (rank + 1) * seq // n
    report["attend"] = {}
    for name, fn in attends.items():
        ex = sess.executor
        t0 = time.perf_counter()
        res = sess.run(fn, n)
        out = np.concatenate([to_numpy(f.cols[0])
                              for shard in range(n)
                              for f in res.reader(shard, ())])
        wall = time.perf_counter() - t0
        if rank == 0:
            np.save(os.path.join(args.out, f"attend-{name}.npy"), out)
        att = fn.invocation(n).invoke()
        staged = StagedInput(
            [torch.from_numpy(c[lo:hi]).to(mesh.device) for c in (q, k, v)],
            torch.tensor([hi - lo], dtype=torch.int32, device=mesh.device),
            hi - lo, False, None)
        times = []
        with meshutil.active(mesh):
            for i in range(4):
                mesh.barrier()
                times.append(_stage_ms(
                    mesh.device, lambda: ex._attend("phase33", att, staged)))
        times = times[1:]  # the first is a warm-up
        report["attend"][name] = {
            "wall_s": wall, "stage_ms": float(np.median(times)),
            "method": ex.attend_methods.get("phase33")}
    report["collectives"] = dict(mesh.collectives)
    report["ok"] = bool(report["wordcount_ok"] and report["once_ok"]
                        and report["fetched_ok"]
                        and "jax" not in sys.modules
                        and "bigslice_tpu" not in sys.modules)
    _report(args.out, rank, report)
    mesh.barrier()
    sess.shutdown()
    distributed.shutdown()
    return 0 if report["ok"] else 1


def _worker(args) -> int:
    import torch

    torch.set_num_threads(max(1, args.threads))
    from bigslice_tpu_torch.utils import distributed

    rank = int(os.environ.get("RANK", "0"))
    n = int(os.environ.get("WORLD_SIZE", "1"))
    report = {"rank": rank, "world": n, "mode": args.mode}
    t_start = time.perf_counter()
    if args.mode == "registry":
        import bigslice_tpu_torch as bs

        if rank == 1:
            @bs.func
            def only_on_rank_one():
                return bs.Const(1, [1])
        try:
            distributed.initialize(device=args.device,
                                   backend=args.backend)
        except RuntimeError as e:
            report["raised"] = str(e)
            _report(args.out, rank, report)
            return 0
        report["raised"] = None
        _report(args.out, rank, report)
        return 1
    if args.mode == "nccl1":
        return _nccl_one_rank(args, report)
    if args.mode == "hier":
        return _hier_mode(args, rank, n, report)
    if args.mode == "plane":
        return _plane_mode(args, rank, n, report)
    distributed.initialize(device=args.device, backend=args.backend)
    mesh = distributed.global_mesh()
    from bigslice_tpu_torch.ops import func as func_mod

    report.update(backend=mesh.backend, transport=mesh.transport,
                  device=str(mesh.device),
                  digest=func_mod.registry_digest(),
                  jax_loaded="jax" in sys.modules,
                  bigslice_tpu_loaded="bigslice_tpu" in sys.modules)
    if args.mode == "fail":
        if rank == 1:
            raise RuntimeError("rank 1 fails on purpose")
        mesh.barrier()  # rank 0 waits here for a peer that never comes
        return 0
    if args.mode == "wedge":
        return _wedge(args, mesh, rank, report)
    if args.mode == "infra":
        return _infra(args, mesh, rank, report)
    report.update(_kmeans_check(mesh, rank, n, args))
    report.update(_reduce_check(mesh, args))
    host_ok = True
    if n > 1:
        report.update(_hostdist_check(mesh))
        host_ok = (report["hostdist_rows_ok"]
                   and report["hostdist_split_ok"]
                   and report["hostdist_roots_only"]
                   and report["hostdist_closed_clean"])
    report["collectives"] = dict(mesh.collectives)
    report["seconds"] = time.perf_counter() - t_start
    report["ok"] = bool(report["kmeans_ok"] and report["reduce_rows_ok"]
                        and report["reduce_placed_ok"] and host_ok
                        and not report["jax_loaded"]
                        and not report["bigslice_tpu_loaded"])
    _report(args.out, rank, report)
    mesh.barrier()
    distributed.shutdown()
    return 0 if report["ok"] else 1


def _wedge(args, mesh, rank: int, report: dict) -> int:
    """Rank 1 stops beating and sleeps (alive, wedged); rank 0 runs a
    Reduce, which must fail with the keepalive's ``PeerLostError``
    (as the task's ``HostLostError``) before entering a collective."""
    import numpy as np

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.spmd import spmd_session
    from bigslice_tpu_torch.utils import distributed

    sess = spmd_session(mesh=mesh)
    ka = distributed.get_keepalive()
    keys = np.arange(64, dtype=np.int32) % 8
    # Built before the barrier: tracing its combiner imports torch's
    # tracing modules, which takes seconds once a process.
    red = bs.Reduce(bs.Const(2, keys, np.ones(64, np.int32)),
                    lambda a, b: a + b)
    mesh.barrier()
    if rank == 1:
        ka.stop()
        # Wedged until rank 0 has its verdict (bounded).
        done = os.path.join(args.out, "rank0.json")
        t0 = time.monotonic()
        while (not os.path.exists(done)
               and time.monotonic() - t0 < ka.timeout * 4 + 2):
            time.sleep(0.05)
        # Its peer has left the group: end without the group's teardown.
        sys.stderr.flush()
        os._exit(0)
    t0 = time.monotonic()
    while not ka.lost_peers() and time.monotonic() - t0 < ka.timeout * 4:
        time.sleep(0.05)
    report["detect_s"] = time.monotonic() - t0
    try:
        sess.run(red)
        report["raised"] = None
    except Exception as e:  # noqa: BLE001 — the verdict under test
        report["raised"] = repr(e)
    report["timeout_s"] = ka.timeout
    ok = (report["raised"] is not None and "PeerLostError" in
          report["raised"] and report["detect_s"] <= ka.timeout * 3)
    report["ok"] = bool(ok)
    _report(args.out, rank, report)
    # Rank 1 never enters another collective: end without the group's
    # teardown.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0 if ok else 1)


def _infra(args, mesh, rank: int, report: dict) -> int:
    """Rank 1 alone meets an injected infra error (the CUDA
    out-of-memory class) at its first group dispatch. Over ranks that is
    fatal (``HostLostError``, the ranks out of step): no probation, no
    rerun on rank 1's host tier. Rank 0, inside the group's collectives,
    fails with ``HostLostError`` once rank 1 has gone."""
    import numpy as np

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.spmd import spmd_session
    from bigslice_tpu_torch.utils import faultinject

    sess = spmd_session(mesh=mesh)
    if rank == 1:
        faultinject.install(
            faultinject.parse_plan("1:mesh.dispatch=1x1~infra"))
    mesh.barrier()
    keys = np.arange(4096, dtype=np.int32) % 97
    t0 = time.monotonic()
    try:
        sess.run(bs.Reduce(bs.Const(4, keys, np.ones(4096, np.int32)),
                           lambda a, b: a + b))
        report["raised"] = None
    except Exception as e:  # noqa: BLE001 — the verdict under test
        report["raised"] = repr(e)
    report["seconds"] = time.monotonic() - t0
    report["probation"] = sess.executor.probation
    report["ok"] = bool(report["raised"] is not None
                        and "HostLostError" in report["raised"])
    _report(args.out, rank, report)
    # The group is broken: end without its teardown (rank 1's exit is
    # what rank 0's collective sees).
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0 if report["ok"] else 1)


def _nccl_one_rank(args, report: dict) -> int:
    """One rank over NCCL on the card: the seam's exchange path itself
    (no one-slot short cut) on int32, uint32 (an int32 view) and bool
    (a uint8 view) planes, and a psum."""
    import torch
    import torch.distributed as dist

    from bigslice_tpu_torch.parallel import meshutil
    from bigslice_tpu_torch.utils import distributed

    distributed.initialize(device="cuda", backend="nccl")
    mesh = meshutil.Mesh(dist.group.WORLD, device=distributed.local_device())
    dev = mesh.device
    checks = {}
    for name, x in (
            ("int32", torch.arange(8, dtype=torch.int32, device=dev)),
            ("uint32", torch.arange(2**32 - 8, 2**32, dtype=torch.int64,
                                    device=dev).to(torch.uint32)),
            ("bool", torch.arange(8, device=dev) % 3 == 0)):
        got = mesh._exchange(x.reshape(1, 8))
        checks[name] = bool(got.dtype == x.dtype
                            and torch.equal(got.reshape(8), x))
    out = torch.ones(4, dtype=torch.int64, device=dev)
    dist.all_reduce(out, group=mesh.group)
    checks["psum"] = bool(out.tolist() == [1, 1, 1, 1])
    report.update(backend=mesh.backend, checks=checks,
                  ok=all(checks.values()))
    _report(args.out, 0, report)
    distributed.shutdown()
    return 0 if report["ok"] else 1


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=2)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--mode", default="smoke",
                    choices=("smoke", "wedge", "fail", "infra", "registry",
                             "nccl1", "hier", "plane"))
    ap.add_argument("--device", default=None, help="cpu (default: cuda)")
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (default: by the device); ranks "
                         "that share one GPU need gloo")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rows", type=int, default=1 << 16)
    ap.add_argument("--keyspace", type=int, default=1 << 12)
    ap.add_argument("--shards", type=int, default=0,
                    help="default 4 a rank")
    ap.add_argument("--warm", type=int, default=1)
    ap.add_argument("--points", type=int, default=1 << 12)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--kmeans-tol", type=float, default=1e-5,
                    help="relative to the largest centroid coordinate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--deadline", type=float, default=300.0)
    ap.add_argument("--fleet-dir", default=None,
                    help="hier: the fleet export's directory")
    ap.add_argument("--corpus", default=None,
                    help="plane: the word count's text file")
    ap.add_argument("--att", default=None,
                    help="plane: an .npz of the q, k, v columns")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.worker:
        return _worker(args)
    n = 1 if args.mode == "nccl1" else args.n
    out = args.out or tempfile.mkdtemp(prefix="bigslice-smoke-")
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", "bigslice_tpu_torch.tools.multihost_smoke",
           "--worker", "--out", out]
    for flag in ("mode", "device", "backend", "rows", "keyspace", "warm",
                 "points",
                 "dim", "k", "kmeans_tol", "seed", "threads"):
        v = getattr(args, flag)
        if v is not None:
            cmd += ["--" + flag.replace("_", "-"), str(v)]
    cmd += ["--shards", str(args.shards or 4 * n)]
    env = None
    if args.mode == "wedge":
        env = {"BIGSLICE_KEEPALIVE_INTERVAL": "0.2",
               "BIGSLICE_KEEPALIVE_TIMEOUT": "1"}
    res = launch(n, cmd, args.deadline, env=env)
    reports = []
    for r in range(n):
        path = os.path.join(out, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as fh:
                reports.append(json.load(fh))
    summary = {"rc": res.rc, "seconds": res.seconds,
               "timed_out": res.timed_out, "reports": reports}
    print(json.dumps(summary))
    return res.rc


if __name__ == "__main__":
    sys.exit(main())
