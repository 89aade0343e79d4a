"""Serving plane: one resident process serving pipelines to many
tenants.

The JAX package's ``serve/``, ported. The long-lived server process
owns the card; two pieces make that real:

- ``serve/programcache.py``: the cross-Session program cache. The
  device executor accounts every wave program under a content-
  fingerprinted identity; this module is the process-wide tier above
  its session-local table, so a fresh Session in the same server
  process finds every program of a pipeline the process served before
  (a hit), and builds none after a miss. The port compiles no wave
  program, so what the cache holds is the identity and its accounting,
  not an executable.
- ``serve/server.py``: the invocation server: named pipelines,
  HTTP/JSON invocations scheduled onto shared wave slots with an
  admission queue, per-tenant quotas, deadlines and metrics, the cost
  gate, an optional ``ops/cache.py``-backed result cache, and a
  graceful drain on SIGTERM.

``tools/sliceserve.py`` is the command-line entry.
"""

from bigslice_tpu_torch.serve.programcache import (  # noqa: F401
    ProgramCache,
    fn_fingerprint,
    global_program_cache,
    program_cache_stats,
)
from bigslice_tpu_torch.serve.server import (  # noqa: F401
    Pipeline,
    ServeServer,
    ServingStats,
)

__all__ = [
    "ProgramCache",
    "fn_fingerprint",
    "global_program_cache",
    "program_cache_stats",
    "Pipeline",
    "ServeServer",
    "ServingStats",
]
