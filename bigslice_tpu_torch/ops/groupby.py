"""GroupByKey — device grouping with a fixed capacity.

Groups encode as a fixed-capacity vector column plus a true-count
column, produced on the device by ``parallel/groupby.py``: the first
``capacity`` values per key (in arrival order after the shuffle, kept
by the stable sort) are kept, and ``count`` stays exact so an overflow
is visible.

Output schema: (key..., value dtype[capacity] vector column, count
int32), prefix = the input's. A device Map downstream receives each
row's group as a [capacity] tensor (``torch.func.vmap``). The local
executor's reader runs the same core over the shard's rows
(``parallel/groupby.cached_group_by_key``).
"""

from __future__ import annotations

import numpy as np

from bigslice_tpu_torch import sliceio, typecheck
from bigslice_tpu_torch.frame.frame import Frame
from bigslice_tpu_torch.ops.base import Dep, Slice, make_name
from bigslice_tpu_torch.slicetype import ColType, Schema


class GroupByKey(Slice):
    """``GroupByKey(slice, capacity, on_overflow=)`` over a
    (key..., value) slice with exactly one device value column.

    ``on_overflow``: "truncate" (default) keeps the first ``capacity``
    values per key, the exact count column making the overflow VISIBLE
    (consumers check ``count > capacity``); "error" fails the run with
    a ``ValueError`` when any group exceeds the capacity.
    """

    def __init__(self, slice_: Slice, capacity: int,
                 on_overflow: str = "truncate"):
        typecheck.check(capacity >= 1, "groupbykey: capacity must be >= 1")
        typecheck.check(
            on_overflow in ("truncate", "error"),
            "groupbykey: on_overflow must be 'truncate' or 'error' "
            "(got %r)", on_overflow,
        )
        typecheck.check(
            slice_.prefix >= 1,
            "groupbykey: input slice must have a key prefix",
        )
        typecheck.check(
            len(slice_.schema) == slice_.prefix + 1,
            "groupbykey: input must have exactly one value column "
            "(got %d)", len(slice_.schema) - slice_.prefix,
        )
        typecheck.check(
            all(ct.is_device for ct in slice_.schema),
            "groupbykey: all columns must be device-tier "
            "(dictionary-encode host keys first)",
        )
        typecheck.check(
            all(ct.shape == () for ct in slice_.schema),
            "groupbykey: input columns must be scalar (vector columns "
            "cannot ride the sort kernel)",
        )
        val = slice_.schema.cols[slice_.prefix]
        schema = Schema(
            list(slice_.schema.key)
            + [ColType(val.dtype, shape=(capacity,)), ColType(np.int32)],
            prefix=slice_.prefix,
        )
        super().__init__(schema, slice_.num_shards, make_name("groupby"),
                         pragmas=slice_.pragmas)
        self.dep_slice = slice_
        self.capacity = capacity
        self.on_overflow = on_overflow

    def deps(self):
        return (Dep(self.dep_slice, shuffle=True),)

    def reader(self, shard, deps):
        def read():
            from bigslice_tpu_torch.parallel.groupby import \
                cached_group_by_key

            frame = sliceio.read_all(deps[0](), self.dep_slice.schema)
            if not len(frame):
                return
            kern = cached_group_by_key(self.prefix, self.capacity)
            keys, groups, counts = kern(
                list(frame.key_cols()), frame.value_cols()[0], len(frame))
            if self.on_overflow == "error":
                over = counts > self.capacity
                nover = int(over.sum())
                if nover:
                    raise ValueError(
                        f"groupbykey: {nover} group(s) exceed the "
                        f"declared capacity {self.capacity} (largest "
                        f"group: {int(counts.max())} rows); raise "
                        f"capacity or use Cogroup for discovered "
                        f"capacities")
            yield Frame(list(keys) + [groups, counts], self.schema)

        return read()
