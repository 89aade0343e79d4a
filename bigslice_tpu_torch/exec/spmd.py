"""SPMD sessions: the same driver program on every process.

The reference ships invocations to workers over RPC; the JAX package
runs the SAME driver on every host (reference exec/spmd.py). So does
this package, one ``torch.distributed`` rank a GPU: compilation is
deterministic (the Func-registry guarantee, checked at
``utils.distributed.initialize``), so every rank builds the same task
graph; the device executor launches its groups in the session's plan
order on one dispatcher thread (``MeshExecutor.ordered_dispatch``, on
over more than one rank), enters
every collective in the same order, and gathers the outputs a host
reads to every rank in launch order, so result scans need no
collective. A host-tier task runs once, on its owner rank, and the
others fetch its outputs as they read them (``exec/hostdist.py``).

Contract: one driver thread a process, the same program on every rank.

Usage (every rank runs this, same code)::

    from bigslice_tpu_torch.exec import spmd
    from bigslice_tpu_torch.utils import distributed
    distributed.initialize()            # torchrun's env://, or -launch N
    sess = spmd.spmd_session()
    result = sess.run(build_pipeline)
    if spmd.is_coordinator():
        print(result.rows())
"""

from __future__ import annotations

from typing import Optional

from bigslice_tpu_torch.utils.distributed import (global_mesh,  # noqa: F401
                                                  is_coordinator)


def spmd_session(mesh=None, parallelism: Optional[int] = None,
                 coordinator_debug_port: Optional[int] = None, **kwargs):
    """A Session over the mesh of every rank (``global_mesh()``, one slot
    a rank; the one-slot mesh of this process when no group is formed)
    with the SPMD dispatch contract. ``parallelism`` bounds the host
    tier's task threads. ``coordinator_debug_port`` starts the debug
    server on rank 0 only: every rank runs this same line, and one port
    can be bound once a host."""
    from bigslice_tpu_torch.exec.meshexec import MeshExecutor
    from bigslice_tpu_torch.exec.session import Session

    if mesh is None:
        mesh = global_mesh()
    if coordinator_debug_port is not None and is_coordinator():
        kwargs.setdefault("debug_port", coordinator_debug_port)
    ex = MeshExecutor(mesh=mesh, fallback_procs=parallelism)
    return Session(executor=ex, **kwargs)
