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
bool planes).
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
    report["collectives"] = dict(mesh.collectives)
    report["seconds"] = time.perf_counter() - t_start
    report["ok"] = bool(report["kmeans_ok"] and report["reduce_rows_ok"]
                        and report["reduce_placed_ok"]
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
                             "nccl1"))
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
