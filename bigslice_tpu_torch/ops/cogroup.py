"""Cogroup — the general N-ary grouping and outer join by key.

``Cogroup(a, b, ...)`` shuffles every input by its key prefix (the key
types must agree); each output row is one distinct key over all inputs
followed, per input, by the *list* of that input's value rows under the
key: one object column of lists per input value column, an empty list
where the input lacks the key. One input is group-by-key; several are a
full outer join with grouped values.

The device executor lowers it (``parallel/cogroup.py``): one tagged,
stable sort over the union of the inputs' shuffled rows, a rank-scatter
into per-input [keys, G] matrices with exact counts, a capacity G that
the executor discovers, and a host decode into the lists. The JAX
package's host sorted-merge reader belongs to the host tier, which this
package does not have: inputs with host columns, or a Cogroup fused
with other stages, are refused by name when they run.
"""

from __future__ import annotations

from typing import List

import numpy as np

from bigslice_tpu_torch import typecheck
from bigslice_tpu_torch.frame import ops as frame_ops
from bigslice_tpu_torch.ops.base import Dep, Slice, make_name
from bigslice_tpu_torch.slicetype import ColType, Schema


class Cogroup(Slice):
    """Group one or more keyed slices by their shared key prefix.

    Output schema: the key columns, then for each input and each of its
    value columns a host column of lists (tag ``"list"``); prefix = the
    key count. ``num_shards`` is the largest of the inputs'."""

    def __init__(self, *slices: Slice):
        typecheck.check(len(slices) >= 1,
                        "cogroup: expected at least one slice")
        key_types = None
        for s in slices:
            typecheck.check(
                s.prefix >= 1, "cogroup: input %s must have a key prefix",
                s.name,
            )
            kt = s.schema.key
            if key_types is None:
                key_types = kt
            else:
                typecheck.check(
                    tuple(c.dtype for c in kt)
                    == tuple(c.dtype for c in key_types),
                    "cogroup: key column types mismatch: %s vs %s",
                    kt, key_types,
                )
        for ct in key_types:
            typecheck.check(
                frame_ops.can_hash(ct) and frame_ops.can_compare(ct),
                "cogroup: key column type %s is not groupable", ct,
            )
        cols: List[ColType] = list(key_types)
        for s in slices:
            cols.extend(ColType(np.dtype(object), tag="list")
                        for _ in s.schema.values)
        super().__init__(Schema(cols, prefix=len(key_types)),
                         max(s.num_shards for s in slices),
                         make_name("cogroup"))
        self.pragmas = tuple(p for s in slices for p in s.pragmas)
        self.slices = tuple(slices)

    @property
    def nvals(self) -> tuple:
        """Each input's value-column count."""
        return tuple(len(s.schema) - s.prefix for s in self.slices)

    def deps(self):
        return tuple(Dep(s, shuffle=True) for s in self.slices)
