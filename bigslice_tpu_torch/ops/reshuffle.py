"""Reshuffle, Repartition and Reshard — explicit data movement.

On the device executor both lower to the sort shuffle without a
combiner (parallel/shuffle.py ``make_shuffle_fn``): rows route by the
hash of their key prefix, or by a custom per-row partitioner run
vmapped inside the shuffle. On the local executor each producer frame
routes through ``Partitioner.partition_ids`` (exec/task.py): the
routing hash, a ``RowPartitioner`` over the key columns on their
device, or a frame-level host partitioner. Reshard is a Reshuffle to
another shard count (the identity at the same count).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from bigslice_tpu_torch import typecheck
from bigslice_tpu_torch.frame import ops as frame_ops
from bigslice_tpu_torch.ops.base import Dep, Slice, make_name
from bigslice_tpu_torch.ops.mapops import meta_outputs


class RowPartitioner:
    """A per-row device partitioner: ``fn(*key_values, nparts) -> int32
    partition id``, lowered into the shuffle (``device_fn``) so that
    Repartition runs on the device."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, frame, nparts: int) -> torch.Tensor:
        """The partitioner over a frame: int32 ids on its device."""
        return self.device_fn(nparts)(*frame.key_cols()).to(torch.int32)

    def device_fn(self, nparts: int) -> Callable:
        """The vectorized form the shuffle consumes: ``fn(*key_cols) ->
        ids`` with ``nparts`` bound (an int32 scalar, unbatched)."""

        def part(*key_cols):
            n = torch.tensor(nparts, dtype=torch.int32,
                             device=key_cols[0].device)
            return torch.func.vmap(
                self.fn, in_dims=(0,) * len(key_cols) + (None,)
            )(*key_cols, n)

        return part


class Reshuffle(Slice):
    """Shuffle records among shards by key prefix."""

    def __init__(self, slice_: Slice, partitioner: Optional[Callable] = None):
        if partitioner is None:
            for ct in slice_.schema.key:
                typecheck.check(
                    frame_ops.can_hash(ct),
                    "reshuffle: key column type %s is not partitionable", ct,
                )
        super().__init__(slice_.schema, slice_.num_shards,
                         make_name("reshuffle"), pragmas=slice_.pragmas)
        self.dep_slice = slice_
        self.partitioner = partitioner

    def deps(self):
        return (Dep(self.dep_slice, shuffle=True,
                    partitioner=self.partitioner),)

    def reader(self, shard, deps):
        return deps[0]()


class Reshard(Slice):
    """``slice_`` hash-shuffled into ``num_shards`` shards; ``slice_``
    itself when it has that many already."""

    def __new__(cls, slice_: Slice, num_shards: int):
        if slice_.num_shards == num_shards:
            return slice_
        return object.__new__(cls)

    def __init__(self, slice_: Slice, num_shards: int):
        if self is slice_:  # the identity, returned by __new__
            return
        typecheck.check(num_shards >= 1, "reshard: num_shards must be >= 1")
        super().__init__(slice_.schema, num_shards, make_name("reshard"),
                         pragmas=slice_.pragmas)
        self.dep_slice = slice_

    def deps(self):
        return (Dep(self.dep_slice, shuffle=True),)

    def reader(self, shard, deps):
        return deps[0]()


def Repartition(slice_: Slice, partition: Callable,
                mode: str = "auto") -> Slice:
    """Reshuffle with a custom partitioner. A per-row device fn
    ``fn(*key_values, nparts) -> int`` (decided by a meta trace, or
    ``mode="device"``) runs on the device; anything else is a
    frame-level host partitioner ``fn(frame, nparts) -> int32[n]``
    (vectorized numpy over the frame's host copy), which the local
    executor runs (the device executor's host tier included)."""
    if mode in ("auto", "device"):
        traceable = _partitioner_traceable(partition, slice_)
        if mode == "device" and not traceable:
            raise typecheck.errorf(
                "repartition: partitioner is not a device function over %s",
                slice_.schema.key,
            )
        if traceable:
            return Reshuffle(slice_, partitioner=RowPartitioner(partition))
    return Reshuffle(slice_, partitioner=partition)


def _partitioner_traceable(fn: Callable, slice_: Slice) -> bool:
    key = slice_.schema.key
    if not all(ct.is_device and ct.shape == () for ct in key):
        return False
    nparts = torch.empty((), dtype=torch.int32, device="meta")
    out = meta_outputs(fn, key, extra=(nparts,))
    return (out is not None and len(out) == 1 and out[0].shape == ()
            and not out[0].dtype.is_floating_point
            and out[0].dtype != torch.bool)
