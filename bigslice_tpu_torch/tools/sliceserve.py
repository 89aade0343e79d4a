"""sliceserve: the long-lived serving process (the CLI of
``serve/server.py``).

Starts one Session owning the card, registers named pipelines, and
serves HTTP/JSON invocations until SIGTERM or SIGINT, with admission
control, per-tenant quotas, the cross-Session program cache and an
optional cross-request result cache. The debug surface
(``/debug/metrics``, ``/debug/status``, ``/debug/profile``) rides on
the same port.

Pipelines come from ``--module``: any importable module exposing
``register_pipelines(server)`` (called with the ``ServeServer``;
register with ``server.register(name, fn, cache=...)``). With no
module, two built-in demo pipelines are registered:

- ``reduce``: a keyed Reduce over a synthetic corpus, ``args =
  [n_rows, n_keys]`` (defaults 1<<18, 1<<12);
- ``wordcount``: the cmd/urls domain count over a synthetic URL
  corpus, ``args = [n_rows]`` (default 1<<15).

Shutdown is graceful: SIGTERM or SIGINT stops admission (503s), drains
the invocations in flight, prints a final snapshot line on stderr, then
closes the session.

Usage:
    python -m bigslice_tpu_torch.tools.sliceserve --port 8710 \\
        [--slots 2] [--queue 16] [--tenant-quota 8] \\
        [--result-cache DIR] [--module my.pipelines] [--device cpu]

The executor runs on ``cuda`` unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading


def _shards() -> int:
    """One shard a card (the JAX package's ``len(jax.devices())``)."""
    import torch

    return max(1, torch.cuda.device_count())


def _demo_pipelines(server) -> None:
    """The built-in demo pipelines: slice-returning functions with a
    stable identity, so that repeated invocations, and fresh sessions,
    find their programs in the program cache."""
    import numpy as np

    import bigslice_tpu_torch as bs

    def _add(a, b):
        return a + b

    def reduce_pipeline(n_rows=1 << 18, n_keys=1 << 12):
        rng = np.random.RandomState(42)
        keys = rng.randint(0, int(n_keys), int(n_rows)).astype(np.int32)
        vals = np.ones(int(n_rows), dtype=np.int32)
        return bs.Reduce(bs.Const(_shards(), keys, vals), _add)

    def wordcount_pipeline(n_rows=1 << 15):
        from bigslice_tpu_torch.models.urls import domain_count

        rng = np.random.RandomState(7)
        doms = (rng.zipf(1.5, int(n_rows)) % 500).astype(np.int64)
        lines = [f"http://site{d}.example.com/p/{i & 255}"
                 for i, d in enumerate(doms.tolist())]
        return domain_count(_shards(), lines)

    server.register("reduce", reduce_pipeline,
                    description="keyed Reduce over a synthetic corpus "
                                "(args: n_rows, n_keys)")
    server.register("wordcount", wordcount_pipeline,
                    description="domain count over a synthetic URL corpus "
                                "(args: n_rows)")


def build_server(port: int = 0, slots: int = 2, queue: int = 16,
                 tenant_quota=None, result_cache=None, module=None,
                 status: bool = False, device=None):
    """Session and ServeServer, pipelines registered. Returns the
    server (its ``session`` owns the device executor, on ``cuda``
    unless ``device`` says otherwise)."""
    from bigslice_tpu_torch.exec.meshexec import MeshExecutor
    from bigslice_tpu_torch.exec.session import Session
    from bigslice_tpu_torch.serve.server import ServeServer

    session = Session(executor=MeshExecutor(device=device), status=status)
    server = ServeServer(
        session, port=port, slots=slots, queue_depth=queue,
        tenant_quota=tenant_quota, result_cache_dir=result_cache,
    )
    if module:
        import importlib

        mod = importlib.import_module(module)
        register = getattr(mod, "register_pipelines", None)
        if register is None:
            session.shutdown()
            raise SystemExit(
                f"sliceserve: module {module!r} has no "
                f"register_pipelines(server)"
            )
        register(server)
    else:
        _demo_pipelines(server)
    return server


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="sliceserve",
        description="persistent multi-tenant pipeline server",
    )
    ap.add_argument("--port", type=int, default=8710,
                    help="listen port (0 = ephemeral; printed on stdout "
                         "as JSON)")
    ap.add_argument("--slots", type=int, default=2,
                    help="concurrent invocations on the shared card")
    ap.add_argument("--queue", type=int, default=16,
                    help="admission queue depth beyond the slots "
                         "(beyond -> 503)")
    ap.add_argument("--tenant-quota", type=int, default=None,
                    help="max in-flight+queued invocations per tenant "
                         "(beyond -> 429)")
    ap.add_argument("--result-cache", default=None,
                    help="directory for the cross-request result cache "
                         "(enables cache=True pipelines)")
    ap.add_argument("--module", default=None,
                    help="import MODULE and call its "
                         "register_pipelines(server)")
    ap.add_argument("--status", action="store_true",
                    help="live status lines on stderr")
    ap.add_argument("--device", default=None,
                    help="the executor's device (default cuda)")
    args = ap.parse_args(argv)

    server = build_server(
        port=args.port, slots=args.slots, queue=args.queue,
        tenant_quota=args.tenant_quota, result_cache=args.result_cache,
        module=args.module, status=args.status, device=args.device,
    )
    print(json.dumps({
        "serving": True,
        "port": server.port,
        "pipelines": sorted(server.pipelines()),
        "slots": server.slots,
        "queue_depth": server.queue_depth,
        "tenant_quota": server.tenant_quota,
    }), flush=True)

    stop = threading.Event()

    def _on_signal(signum, frame):
        print(f"sliceserve: signal {signum}, draining", file=sys.stderr,
              flush=True)
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    try:
        stop.wait()
    finally:
        # Graceful drain: the session closes its serving surface first
        # (in-flight invocations finish, the final snapshot prints),
        # then the executor.
        server.session.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
