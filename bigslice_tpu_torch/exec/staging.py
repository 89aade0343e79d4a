"""Wave staging: a reusable host arena and two-pass assembly.

Staging a wave used to cost a ``Frame.concat`` per shard, a
``torch.zeros`` of the padded device buffer and one pageable
host-to-device copy per shard and column. Here each column is assembled
ONCE on the host, straight into its padded global layout, and copied to
the card in one copy:

1. **Scan** — exact per-shard row counts from the frames' lengths (or a
   header-only ``codec.scan_frames`` pass over raw stream bytes), which
   fix the bucketed capacity before any payload moves.
2. **Assemble** — take one ``(capacity, ...)`` host buffer per column
   from the arena for this rank's own slot, ``copy_`` each of its
   frames' columns into its row slice (torch's copy releases the GIL,
   which the wave prefetcher's thread needs), and zero only the padding
   tail. The capacity is ``bucket_size`` of the largest shard of the
   wave, counted over every slot's frames (each rank runs the same
   driver and host tier, so it holds them all): every rank arrives at
   the same capacity without a collective, as the exchange needs.

The arena's policy follows the device:

- ``recycle`` (``cuda``): buffers are **pinned** host memory, which the
  card copies from asynchronously and at full rate. Pinning costs far
  more than reusing, so the arena keeps released buffers, keyed by
  (dtype, shape) and bounded by ``BIGSLICE_STAGING_ARENA_BYTES`` (default
  1 << 28), and hands them out again. A buffer goes back to the free
  list only after the CUDA event recorded behind its host-to-device copy
  has completed: until then the copy may still be reading it.
- ``zerocopy`` (``cpu``): the executor's tensors ARE the host buffers,
  so the assembled buffers go to the wave program as they are and are
  never recycled.

Under more than one process on a host (``LOCAL_WORLD_SIZE`` ranks) the
byte bound is the host's, split evenly over them (the JAX package's
multi-process arena policy, reference exec/staging.py:170-173, turns
recycling off; here each rank's pinned buffers are its own, so they
recycle, but N ranks must not pin N times the host's bound).

``hits``/``misses``/``recycled`` count reuse; ``outstanding`` counts the
recycle-mode buffers handed out and not yet returned (``release``
behind a copy's event, ``abandon`` when no copy was issued), so that a
cancelled or failed wave that kept one shows. ``StagingFallback`` marks
inputs outside the contract (object columns, dtype drift between
frames); the caller then takes the per-shard upload path.

``map_shards`` is the small shared pool that fans out per-shard store
reads (``BIGSLICE_STAGE_THREADS``, default 4).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from bigslice_tpu_torch.frame.frame import Frame
from bigslice_tpu_torch.parallel.jitutil import bucket_size
from bigslice_tpu_torch.slicetype import torch_dtype
from bigslice_tpu_torch.utils import faultinject


class StagingFallback(Exception):
    """``assemble`` cannot take these inputs (object columns, dtype or
    shape drift between frames): the caller uploads shard by shard."""


def arena_default_enabled() -> bool:
    env = os.environ.get("BIGSLICE_STAGING_ARENA")
    if env:
        return env not in ("0", "false", "off")
    return True


def stage_threads_default() -> int:
    env = os.environ.get("BIGSLICE_STAGE_THREADS")
    return max(0, int(env)) if env else 4


# -- per-shard read fan-out ----------------------------------------------

_POOL: Optional[ThreadPoolExecutor] = None
_POOL_WORKERS = 0
_POOL_LOCK = threading.Lock()


def map_shards(fn, items: Sequence, threads: Optional[int] = None) -> list:
    """``[fn(x) for x in items]`` with per-item fan-out on a small shared
    thread pool (order kept, the first exception re-raised). Serial when
    the pool cannot help (fewer than 2 items or threads). For store
    reads, whose latencies are independent — not for user reader
    functions, whose thread safety is theirs."""
    items = list(items)
    if threads is None:
        threads = stage_threads_default()
    if threads < 2 or len(items) < 2:
        return [fn(x) for x in items]
    global _POOL, _POOL_WORKERS
    with _POOL_LOCK:
        if _POOL is None or _POOL_WORKERS != threads:
            # A resized pool abandons the old one rather than shutting it
            # down: a concurrent caller may still be mapping on it.
            _POOL = ThreadPoolExecutor(max_workers=threads,
                                       thread_name_prefix="bs-stage")
            _POOL_WORKERS = threads
        pool = _POOL
    return list(pool.map(fn, items))


# -- the arena --------------------------------------------------------------

def staging_mode(device: torch.device) -> str:
    """The arena policy for ``device``: ``recycle`` (pinned buffers,
    reused once their copy has completed) on ``cuda``, ``zerocopy`` (the
    buffers are the program's inputs) on ``cpu``."""
    return "recycle" if torch.device(device).type == "cuda" else "zerocopy"


class StagingArena:
    """A bounded pool of host staging buffers keyed by (dtype, shape);
    ``mode`` is ``staging_mode(device)``."""

    def __init__(self, enabled: Optional[bool] = None,
                 max_bytes: Optional[int] = None, mode: str = "zerocopy"):
        if enabled is None:
            enabled = arena_default_enabled()
        self.enabled = bool(enabled)
        if max_bytes is None:
            env = os.environ.get("BIGSLICE_STAGING_ARENA_BYTES")
            max_bytes = int(env) if env else 1 << 28
            max_bytes //= max(1, int(os.environ.get("LOCAL_WORLD_SIZE",
                                                    "1")))
        self.max_bytes = int(max_bytes)
        self.mode = mode
        self._lock = threading.Lock()
        self._free: Dict[Tuple[torch.dtype, Tuple[int, ...]],
                         List[torch.Tensor]] = {}
        # (event, buffers) released behind a copy still in flight.
        self._pending: List[Tuple[object, List[torch.Tensor]]] = []
        self._held_bytes = 0
        self.hits = 0
        self.misses = 0
        self.recycled = 0
        self.outstanding = 0

    def _reap(self) -> None:
        """Move buffers whose copy has completed to the free list (under
        the lock). Buffers past the byte bound are dropped."""
        still = []
        for event, bufs in self._pending:
            if not event.query():
                still.append((event, bufs))
                continue
            self._recycle(bufs)
        self._pending = still

    def _recycle(self, bufs) -> None:
        """Put buffers on the free list (under the lock), dropping what
        exceeds the byte bound."""
        for b in bufs:
            nb = b.numel() * b.element_size()
            if self._held_bytes + nb > self.max_bytes:
                continue
            self._free.setdefault((b.dtype, tuple(b.shape)), []).append(b)
            self._held_bytes += nb
            self.recycled += 1

    def acquire(self, dtype: torch.dtype, shape: Tuple[int, ...]
                ) -> torch.Tensor:
        shape = tuple(int(d) for d in shape)
        if self.mode == "recycle":
            with self._lock:
                self._reap()
                self.outstanding += 1
                free = self._free.get((dtype, shape))
                if free:
                    buf = free.pop()
                    self._held_bytes -= buf.numel() * buf.element_size()
                    self.hits += 1
                    return buf
                self.misses += 1
        else:
            with self._lock:
                self.misses += 1
        return self._alloc(dtype, shape)

    def _alloc(self, dtype: torch.dtype, shape: Tuple[int, ...]
               ) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.mode == "recycle")

    def release(self, bufs: Sequence[torch.Tensor], event=None) -> None:
        """Return buffers for reuse once ``event`` (recorded behind
        their copies) has completed — recycle mode only; in zerocopy
        mode the program owns them."""
        if self.mode != "recycle" or not bufs:
            return
        if event is None:
            raise ValueError("StagingArena.release: a recycled buffer "
                             "needs the event behind its copy")
        with self._lock:
            self.outstanding -= len(bufs)
            self._pending.append((event, list(bufs)))

    def abandon(self, bufs: Sequence[torch.Tensor]) -> None:
        """Return buffers no copy ever read (the wave failed, or fell
        back, before its upload): free at once in recycle mode."""
        if self.mode != "recycle" or not bufs:
            return
        with self._lock:
            self.outstanding -= len(bufs)
            self._recycle(bufs)

    def stats(self) -> dict:
        """Counts, and ``pinned``: whether every buffer the arena holds
        (free, or behind a copy in flight) is pinned (None when it holds
        none)."""
        with self._lock:
            held = [b for bufs in self._free.values() for b in bufs]
            held += [b for _, bufs in self._pending for b in bufs]
            return {"enabled": self.enabled, "mode": self.mode,
                    "held_bytes": self._held_bytes, "hits": self.hits,
                    "misses": self.misses, "recycled": self.recycled,
                    "in_flight": len(self._pending),
                    "outstanding": self.outstanding,
                    "pinned": (all(b.is_pinned() for b in held)
                               if held else None)}


def _col_spec(c) -> Tuple[Optional[torch.dtype], Tuple[int, ...]]:
    """(torch dtype or None for a host column, trailing dims)."""
    if isinstance(c, torch.Tensor):
        return c.dtype, tuple(int(d) for d in c.shape[1:])
    return None, ()


def assemble(per_shard_frames: Sequence[Sequence[Frame]], schema,
             nmesh: int, arena: StagingArena, slot: int = 0):
    """Two-pass assembly of a wave's per-shard frame lists (one a slot,
    up to ``nmesh``) into slot ``slot``'s padded per-column host
    buffers.

    Pass 1 takes exact per-shard row counts from the frames' lengths:
    the capacity is ``bucket_size`` of the largest. Pass 2 takes one
    buffer per column from the arena and copies the slot's frames into
    it, then zeroes the padding tail.

    Returns ``(host_cols, count, capacity, bufs)``; ``count`` is the
    slot's rows, ``bufs`` the arena buffers to release once their upload
    is issued. Raises ``StagingFallback`` for object columns or
    dtype/shape drift, having returned the buffers it took."""
    if faultinject.ENABLED:
        # Chaos seam (reference exec/staging.py:284), at entry before any
        # arena state moves: the executor's staging retry reruns it.
        faultinject.maybe_raise("staging.assemble")
    lists = [list(fl) for fl in per_shard_frames]
    if len(lists) > nmesh:
        raise ValueError(f"{len(lists)} shard lists for a {nmesh}-slot "
                         f"mesh")
    while len(lists) < nmesh:
        lists.append([])
    counts = [sum(len(f) for f in fl) for fl in lists]
    capacity = bucket_size(max(counts + [1]))
    # Column types from the data when any frame exists, else declared.
    first = next((f for fl in lists for f in fl), None)
    if first is not None:
        specs = [_col_spec(c) for c in first.cols]
    else:
        if schema is None:
            raise StagingFallback("no frames and no schema")
        specs = [(torch_dtype(ct.dtype) if ct.is_device else None,
                  tuple(ct.shape)) for ct in schema]
    if any(dt is None for dt, _ in specs):
        raise StagingFallback("object column")
    host_cols: List[torch.Tensor] = []
    try:
        for j, (dt, dims) in enumerate(specs):
            buf = arena.acquire(dt, (capacity,) + dims)
            host_cols.append(buf)
            off = 0
            for f in lists[slot]:
                c = f.cols[j]
                if _col_spec(c) != (dt, dims):
                    raise StagingFallback("column dtype/shape drift")
                n = int(c.shape[0])
                buf[off : off + n].copy_(c)
                off += n
            buf[off:capacity].zero_()
    except BaseException:
        arena.abandon(host_cols)
        raise
    return host_cols, counts[slot], capacity, list(host_cols)
