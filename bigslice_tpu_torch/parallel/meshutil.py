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

A 2-D mesh (``shape=(D, I)``, ``BIGSLICE_MESH_SHAPE=DxI``) is the JAX
package's DCN × ICI grid over the same ranks: rank ``r = g * I + i``
holds slot ``(g, i)``, row-major, as ``mesh.devices.reshape(D, I)``
does, so the flat placement of shards and partitions is unchanged. Its
row groups (the I ranks of one ``g``, the ICI axis) and column groups
(the D ranks of one ``i``, the DCN axis) are built at construction,
every rank building every group in the same order (rows, then
columns). ``axis_all_to_all(planes, axis)`` exchanges over this rank's
row or column group and counts as ``all_to_all_ici`` or
``all_to_all_dcn``, its bytes in ``axis_bytes``; the two-stage
exchange of ``parallel/hier.py`` runs on it. ``ppermute(x, shift)``
sends ``x`` to slot ``rank + shift`` and returns what slot
``rank - shift`` sent (the ring attention's K/V rotation, the JAX
package's ``lax.ppermute``): an ``all_to_all_single`` whose split sizes
are zero except for the neighbour, on every backend alike (gloo's
point-to-point ops are not used, so a CUDA tensor takes the path the
exchange takes).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["HIER_AXIS_NAMES", "Mesh", "MeshTopology", "active",
           "all_to_all", "axis_all_to_all", "current",
           "mesh_shape_from_env", "ppermute"]

#: The axis names of a 2-D mesh, the JAX package's.
HIER_AXIS_NAMES = ("dcn", "ici")

# Integer dtypes of the same width as a dtype the backends lack: the
# exchange only copies bytes, so any view of equal width is exact.
_WIRE = {torch.uint32: torch.int32, torch.uint16: torch.int16,
         torch.uint64: torch.int64, torch.bool: torch.uint8}

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "bigslice_mesh", default=None)


class Mesh:
    """N slots, one a rank of ``group`` (None: the one-slot mesh of this
    process). ``device`` is this rank's device; ``backend`` the group's
    (``nccl`` or ``gloo``), recorded as built."""

    def __init__(self, group=None, device=None,
                 shape: Optional[Tuple[int, int]] = None):
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
        self.axis_bytes: dict = {}
        if shape is None:
            shape = (1, self.size)
        d, i = (int(x) for x in shape)
        if d * i != self.size:
            raise ValueError(f"mesh shape {d}x{i} does not cover "
                             f"{self.size} rank(s)")
        if d == 1 or i == 1:
            d, i = 1, self.size  # no second tier: the 1-D mesh
        self.shape = (d, i)
        self.ndcn, self.nici = d, i
        self._axis_groups = {}
        if d > 1:
            self._axis_groups = self._build_axis_groups(d, i)

    def _build_axis_groups(self, d: int, i: int) -> dict:
        """This rank's row (ICI) and column (DCN) groups. ``new_group``
        is collective over the world: every rank creates every row group,
        then every column group, in one order, or the group hangs."""
        import torch.distributed as dist

        g_me, i_me = divmod(self.rank, i)
        mine = {}
        for g in range(d):
            grp = dist.new_group([g * i + x for x in range(i)],
                                 backend=self.backend)
            if g == g_me:
                mine["ici"] = grp
        for x in range(i):
            grp = dist.new_group([g * i + x for g in range(d)],
                                 backend=self.backend)
            if x == i_me:
                mine["dcn"] = grp
        return mine

    def __repr__(self) -> str:
        shape = (f", shape={self.ndcn}x{self.nici}" if self.is_hier
                 else "")
        return (f"Mesh(size={self.size}, rank={self.rank}, "
                f"backend={self.backend}, device={self.device}{shape})")

    @property
    def is_hier(self) -> bool:
        """A 2-D grid with both extents above 1: its shuffles take the
        two-stage exchange (``parallel/hier.py``)."""
        return self.ndcn > 1 and self.nici > 1

    def axis_size(self, axis: str) -> int:
        return {"ici": self.nici, "dcn": self.ndcn}[axis]


    @property
    def transport(self) -> str:
        """Where the tensors the seam hands the backend live: ``cuda``
        or ``cpu`` (a gloo group copies CUDA tensors through the host
        itself); ``local`` with one slot, where nothing is exchanged."""
        if self.size == 1:
            return "local"
        return self.device.type

    def _count(self, name: str, t0: float, nbytes: int = 0,
               axis: Optional[str] = None) -> None:
        dt = time.perf_counter() - t0
        with self._lock:
            self.collectives[name] = self.collectives.get(name, 0) + 1
            self.collective_s[name] = self.collective_s.get(name, 0.0) + dt
            self.exchanged_bytes += nbytes
            if axis is not None:
                self.axis_bytes[axis] = self.axis_bytes.get(axis, 0) + nbytes

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

    def _exchange(self, planes: torch.Tensor, group=None, size=None,
                  name: str = "all_to_all",
                  axis: Optional[str] = None) -> torch.Tensor:
        """The exchange itself, with no one-slot short cut (a one-rank
        group runs its backend's path too): over the world, or over an
        axis group of ``size`` ranks."""
        import torch.distributed as dist

        if group is None:
            group, size = self.group, self.size
        if planes.shape[0] != size:
            raise ValueError(f"{name}: {planes.shape[0]} planes for a "
                             f"{size}-slot group")
        t0 = time.perf_counter()
        wire = _WIRE.get(planes.dtype)
        src = planes.contiguous()
        if wire is not None:
            src = src.view(wire)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        nbytes = src.numel() * src.element_size()
        self._count(name, t0, nbytes - nbytes // size, axis)
        return out.view(planes.dtype) if wire is not None else out

    def axis_all_to_all(self, planes: torch.Tensor, axis: str
                        ) -> torch.Tensor:
        """The exchange along one axis of a 2-D mesh: ``planes[j]`` goes
        to the rank at coordinate j of this rank's ``axis`` group (its
        row for ``ici``, its column for ``dcn``); the identity on an
        axis of extent 1."""
        n = self.axis_size(axis)
        if n == 1:
            return planes
        return self._exchange(planes, self._axis_groups[axis], n,
                              f"all_to_all_{axis}", axis)

    def ppermute(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """``x`` goes to slot ``(rank + shift) % N``; returns what slot
        ``(rank - shift) % N`` sent, of ``x``'s shape and dtype. The
        identity with one slot."""
        if self.size == 1:
            return x
        return self._ppermute(x, shift)

    def _ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """The rotation itself, with no one-slot short cut: one
        ``all_to_all_single`` whose only non-empty splits are the
        neighbours'."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        n = self.size
        wire = _WIRE.get(x.dtype)
        src = x.contiguous()
        if wire is not None:
            src = src.view(wire)
        flat = src.reshape(-1)
        numel = flat.numel()
        dst, frm = (self.rank + shift) % n, (self.rank - shift) % n
        send = [numel if r == dst else 0 for r in range(n)]
        recv = [numel if r == frm else 0 for r in range(n)]
        out = torch.empty_like(flat)
        dist.all_to_all_single(out, flat, output_split_sizes=recv,
                               input_split_sizes=send, group=self.group)
        self._count("ppermute", t0,
                    0 if dst == self.rank else numel * flat.element_size())
        out = out.reshape(src.shape)
        return out.view(x.dtype) if wire is not None else out

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


def axis_all_to_all(planes: torch.Tensor, n: int, axis: str
                    ) -> torch.Tensor:
    """The exchange seam of the two-stage bodies (``parallel/hier.py``):
    the identity when the axis has one rank; else the active mesh's
    exchange along ``axis``, which must have ``n`` ranks."""
    if n == 1:
        return planes
    mesh = current()
    if mesh is None or mesh.axis_size(axis) != n:
        raise RuntimeError(
            f"axis_all_to_all: a body built for {n} ranks on {axis!r} ran "
            f"under {'no mesh' if mesh is None else mesh}")
    return mesh.axis_all_to_all(planes, axis)


def ppermute(x: torch.Tensor, nmesh: int, shift: int = 1) -> torch.Tensor:
    """The rotation seam of the ring: the identity at ``nmesh == 1``;
    else the active mesh's ``ppermute``, which must have ``nmesh``
    slots."""
    if nmesh == 1:
        return x
    mesh = current()
    if mesh is None or mesh.size != nmesh:
        raise RuntimeError(
            f"ppermute: a body built for {nmesh} slots ran under "
            f"{'no mesh' if mesh is None else mesh}")
    return mesh.ppermute(x, shift)


def all_gather_counts(count: torch.Tensor, nmesh: int) -> torch.Tensor:
    """Every slot's one-element ``count``, in slot order, as an int32
    tensor on ``count``'s device (the JAX package's
    ``lax.all_gather(count, axis)``), over the control group."""
    if nmesh == 1:
        return count.reshape(1).to(torch.int32)
    mesh = current()
    if mesh is None or mesh.size != nmesh:
        raise RuntimeError(
            f"all_gather: a body built for {nmesh} slots ran under "
            f"{'no mesh' if mesh is None else mesh}")
    got = mesh.all_gather([int(count.reshape(()))])
    return torch.tensor([g[0] for g in got], dtype=torch.int32,
                        device=count.device)


def axis_index() -> int:
    """The active mesh's slot of this rank (0 without one)."""
    mesh = current()
    return 0 if mesh is None else mesh.rank


def mesh_shape_from_env() -> Optional[Tuple[int, int]]:
    """Parse ``BIGSLICE_MESH_SHAPE`` (``DxI``, e.g. ``2x4``): None when
    unset or empty; a malformed value raises (a typo must not run the
    job on another topology). The JAX package's parser."""
    spec = os.environ.get("BIGSLICE_MESH_SHAPE", "").strip()
    if not spec:
        return None
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
    return d, i


class MeshTopology:
    """Shape facts of a mesh (reference parallel/meshutil.py:43-75):
    ``axis_names`` (``("shards",)``, or ``HIER_AXIS_NAMES`` for a 2-D
    mesh), ``shape``, ``nmesh``, ``is_hier`` (both extents above 1),
    ``ndcn``/``nici`` (1 and N on a 1-D mesh) and ``signature()``, the
    repr-stable (axis names, shape) pair of the compiler's partition
    config: a 1-D and a 2-D mesh over the same ranks never collide. A
    ``1xN`` or ``Nx1`` shape is the 1-D mesh: it has no second tier."""

    def __init__(self, mesh: "Mesh"):
        self.mesh = mesh
        self.nmesh = int(mesh.size)
        self.is_hier = bool(getattr(mesh, "is_hier", False))
        if self.is_hier:
            self.axis_names: Tuple[str, ...] = HIER_AXIS_NAMES
            self.shape: Tuple[int, ...] = (mesh.ndcn, mesh.nici)
            self.ndcn, self.nici = mesh.ndcn, mesh.nici
        else:
            self.axis_names = ("shards",)
            self.shape = (self.nmesh,)
            self.ndcn, self.nici = 1, self.nmesh
        self.axis = (self.axis_names[0] if len(self.axis_names) == 1
                     else self.axis_names)

    def signature(self) -> tuple:
        return (self.axis_names, self.shape)
