"""The device mesh of this package, and the one seam for every collective.

The JAX package's mesh is a grid of devices that one program spans
(``shard_map``). On an H100 node the PyTorch counterpart is one process
per GPU over ``torch.distributed``: **one rank is one mesh slot**. Rank
r owns slot r; a group of S shards runs shard s on slot ``s % N`` in
wave ``s // N``, and partition p lives on slot ``p % N`` with subid
``p // N`` (reference exec/meshexec.py:280-290). Each rank holds its own
slot's rows only.

``Mesh`` holds the slots, the process group, the rank's device and the
backend the group was built with. Every collective of the device plane
goes through its methods, and the module-level ``all_to_all`` reaches
the mesh the executor activated for the wave program it runs
(``active``). With one slot every collective is the identity and none
is issued, so one-card paths are today's.

- ``all_to_all`` moves the contiguous ``[N, rows, ...]`` planes with
  ``all_to_all_single``; a dtype the backends lack travels as an
  integer view of the same width (uint32 as int32, bool as uint8).
- ``psum``, ``pmin``, ``pmax`` reduce a device tensor; ``pmax_host``
  reduces host ints over the control group (gloo, also beside NCCL).
- ``all_gather`` gathers host ints, ``all_gather_object`` picklable host
  values, in rank order (a wave's signals; group outputs gathered to
  every process).
- ``axis_index`` is the rank's slot.

A gloo group takes CUDA tensors in ``all_to_all_single`` and
``all_reduce`` (checked on the H100 with torch 2.11): the seam hands it
the card's tensors, and gloo copies them through the host itself. NCCL
refuses two ranks on one GPU, so
ranks that share a card use gloo. ``collectives`` counts the calls that
issued a collective, by name, ``collective_s`` the host seconds spent in
them (a call returns when the backend has finished it), and
``exchanged_bytes`` the bytes this rank sent through ``all_to_all``.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from typing import List, Optional, Sequence

import torch

__all__ = ["Mesh", "MeshShapeNotPorted", "active", "all_to_all",
           "check_mesh_shape", "current"]

# Integer dtypes of the same width as a dtype the backends lack: the
# exchange only copies bytes, so any view of equal width is exact.
_WIRE = {torch.uint32: torch.int32, torch.uint16: torch.int16,
         torch.uint64: torch.int64, torch.bool: torch.uint8}

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "bigslice_mesh", default=None)


class MeshShapeNotPorted(NotImplementedError):
    """A 2-D (DCN × ICI) mesh shape: the hierarchical exchange
    (``parallel/hier.py``) is not ported."""


class Mesh:
    """N slots, one a rank of ``group`` (None: the one-slot mesh of this
    process). ``device`` is this rank's device; ``backend`` the group's
    (``nccl`` or ``gloo``), recorded as built."""

    def __init__(self, group=None, device=None):
        import torch.distributed as dist

        self.group = group
        if group is None:
            self.size, self.rank, self.backend = 1, 0, None
        else:
            self.size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.backend = str(dist.get_backend(group))
        self.device = torch.device("cpu" if device is None else device)
        # Host-side control collectives (signals read on the host, object
        # gathers) ride gloo: NCCL takes device tensors only.
        self._cpu_group = None
        if group is not None:
            self._cpu_group = (group if self.backend == "gloo"
                               else dist.new_group(backend="gloo"))
        self._lock = threading.Lock()
        self.collectives: dict = {}
        self.collective_s: dict = {}
        self.exchanged_bytes = 0

    def __repr__(self) -> str:
        return (f"Mesh(size={self.size}, rank={self.rank}, "
                f"backend={self.backend}, device={self.device})")

    @property
    def transport(self) -> str:
        """Where the tensors the seam hands the backend live: ``cuda``
        or ``cpu`` (a gloo group copies CUDA tensors through the host
        itself); ``local`` with one slot, where nothing is exchanged."""
        if self.size == 1:
            return "local"
        return self.device.type

    def _count(self, name: str, t0: float, nbytes: int = 0) -> None:
        dt = time.perf_counter() - t0
        with self._lock:
            self.collectives[name] = self.collectives.get(name, 0) + 1
            self.collective_s[name] = self.collective_s.get(name, 0.0) + dt
            self.exchanged_bytes += nbytes

    def axis_index(self) -> int:
        """This rank's slot (``lax.axis_index`` of the JAX package)."""
        return self.rank

    # -- the device plane ---------------------------------------------------

    def all_to_all(self, planes: torch.Tensor) -> torch.Tensor:
        """``planes[d]`` goes to slot d; returns ``[s]`` from slot s.
        The identity with one slot."""
        if self.size == 1:
            return planes
        return self._exchange(planes)

    def _exchange(self, planes: torch.Tensor) -> torch.Tensor:
        """The exchange itself, with no one-slot short cut (a one-rank
        group runs its backend's path too)."""
        import torch.distributed as dist

        if planes.shape[0] != self.size:
            raise ValueError(f"all_to_all: {planes.shape[0]} planes for a "
                             f"{self.size}-slot mesh")
        t0 = time.perf_counter()
        wire = _WIRE.get(planes.dtype)
        src = planes.contiguous()
        if wire is not None:
            src = src.view(wire)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        nbytes = src.numel() * src.element_size()
        self._count("all_to_all", t0, nbytes - nbytes // self.size)
        return out.view(planes.dtype) if wire is not None else out

    def _reduce(self, x: torch.Tensor, op, name: str) -> torch.Tensor:
        import torch.distributed as dist

        if self.size == 1:
            return x
        t0 = time.perf_counter()
        out = x.clone()
        dist.all_reduce(out, op=op, group=self.group)
        self._count(name, t0)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        return self._reduce(x, dist.ReduceOp.SUM, "psum")

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        return self._reduce(x, dist.ReduceOp.MIN, "pmin")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        return self._reduce(x, dist.ReduceOp.MAX, "pmax")

    # -- the host plane -----------------------------------------------------

    def _host_reduce(self, values: Sequence[int], op, name: str
                     ) -> List[int]:
        import torch.distributed as dist

        if self.size == 1:
            return list(values)
        t0 = time.perf_counter()
        t = torch.tensor(list(values), dtype=torch.int64)
        dist.all_reduce(t, op=op, group=self._cpu_group)
        self._count(name, t0)
        return t.tolist()

    def pmax_host(self, values: Sequence[int]) -> List[int]:
        import torch.distributed as dist

        return self._host_reduce(values, dist.ReduceOp.MAX, "pmax")

    def all_gather(self, values: Sequence[int]) -> List[List[int]]:
        """Every rank's host ints, in rank order: one collective for a
        vector that some entries sum and others max over (a wave's
        signals and its output rows)."""
        import torch.distributed as dist

        if self.size == 1:
            return [list(values)]
        t0 = time.perf_counter()
        t = torch.tensor(list(values), dtype=torch.int64)
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self._cpu_group)
        self._count("all_gather", t0)
        return [o.tolist() for o in out]

    def all_gather_object(self, obj) -> list:
        """Every rank's ``obj``, in rank order (``[obj]`` with one
        slot)."""
        import torch.distributed as dist

        if self.size == 1:
            return [obj]
        t0 = time.perf_counter()
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self._cpu_group)
        self._count("all_gather_object", t0)
        return out

    def barrier(self) -> None:
        import torch.distributed as dist

        if self.size > 1:
            t0 = time.perf_counter()
            dist.barrier(group=self._cpu_group)
            self._count("barrier", t0)


@contextlib.contextmanager
def active(mesh: Optional[Mesh]):
    """Make ``mesh`` the one the module-level seams reach on this thread
    (the executor wraps each wave program in it)."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current() -> Optional[Mesh]:
    """The mesh activated on this thread, or None."""
    return _CURRENT.get()


def all_to_all(planes: torch.Tensor, nmesh: int) -> torch.Tensor:
    """The exchange seam of the program bodies: the identity at
    ``nmesh == 1``; else the active mesh's exchange, which must have
    ``nmesh`` slots (a body built for N slots has no other meaning)."""
    if nmesh == 1:
        return planes
    mesh = current()
    if mesh is None or mesh.size != nmesh:
        raise RuntimeError(
            f"all_to_all: a body built for {nmesh} slots ran under "
            f"{'no mesh' if mesh is None else mesh}")
    return mesh.all_to_all(planes)


def axis_index() -> int:
    """The active mesh's slot of this rank (0 without one)."""
    mesh = current()
    return 0 if mesh is None else mesh.rank


def check_mesh_shape() -> None:
    """Refuse a 2-D ``BIGSLICE_MESH_SHAPE`` (``DxI`` with both extents
    above 1) by name until the hierarchical exchange is ported, and a
    malformed value (a typo must not run the job on another topology);
    unset, ``1xN`` and ``Nx1`` are the 1-D mesh of every rank."""
    spec = os.environ.get("BIGSLICE_MESH_SHAPE", "").strip()
    if not spec:
        return
    parts = spec.lower().replace("×", "x").split("x")
    try:
        d, i = (int(p) for p in parts)
    except (TypeError, ValueError):
        raise ValueError(
            f"BIGSLICE_MESH_SHAPE={spec!r}: expected DxI (e.g. 2x4)"
        ) from None
    if d < 1 or i < 1:
        raise ValueError(
            f"BIGSLICE_MESH_SHAPE={spec!r}: extents must be >= 1")
    if d > 1 and i > 1:
        raise MeshShapeNotPorted(
            f"BIGSLICE_MESH_SHAPE={spec!r}: the 2-D DCN x ICI mesh "
            f"(parallel/hier.py) is not ported; use a 1-D mesh")
