"""JoinAggregate — the aggregating inner join, on the device.

``JoinAggregate(a, b, a_fn, b_fn)``:

1. each side is shuffled by key prefix with *its own* map-side combiner
   (``a_fn`` / ``b_fn``): the compiler attaches ``frame_combiners[i]``
   to dep i's producer tasks (exec/compile.py ``_frame_combiner``), and
   both sides route by the same hash, so equal keys of both sides meet
   in the same consumer shard;
2. the join task finishes each side's reduction and matches the keys
   present in both (the executor's join stage: one claim cascade over
   both sides' rows when both fns classify as add/max/min over
   non-float keys, ``parallel/hashagg.make_hash_join_align``; else two
   segmented reduces and the tagged-sort alignment,
   ``parallel/join.make_align``);
3. output rows are (key..., a_agg..., b_agg...) for the keys present in
   BOTH sides.

The host tier (combine fns that are not tensor functions of the values)
and the dense join (``dense_keys=``) are not ported: the executor
refuses either by name (``LoweringNotPorted``).
"""

from __future__ import annotations

from typing import Callable

from bigslice_tpu_torch import typecheck
from bigslice_tpu_torch.frame import ops as frame_ops
from bigslice_tpu_torch.ops.base import Dep, Slice, make_name
from bigslice_tpu_torch.ops.reduce import FrameCombiner
from bigslice_tpu_torch.slicetype import Schema


class JoinAggregate(Slice):
    """Inner-join two keyed slices after per-side keyed reduction.

    Output schema: key columns (shared by both sides, typechecked) +
    side A's value columns + side B's value columns; one row per key
    present in both sides. ``a_fn``/``b_fn`` are associative pairwise
    combine functions over each side's value columns (Reduce's form for
    single-value sides). ``dense_keys`` declares both sides' keys dense
    codes in [0, dense_keys); its lowering is not ported, and a join
    that declares it is refused when it runs.
    """

    def __init__(self, a: Slice, b: Slice, a_fn: Callable,
                 b_fn: Callable, dense_keys=None):
        for s, side in ((a, "left"), (b, "right")):
            typecheck.check(
                s.prefix >= 1,
                "join: %s input must have a key prefix", side,
            )
            typecheck.check(
                len(s.schema) > s.prefix,
                "join: %s input must have value columns", side,
            )
        typecheck.check(
            tuple(c.dtype for c in a.schema.key)
            == tuple(c.dtype for c in b.schema.key)
            and a.prefix == b.prefix,
            "join: key column types mismatch: %s vs %s",
            a.schema.key, b.schema.key,
        )
        # The device tier's hashable keys (scalar device columns) are
        # exactly its comparable ones.
        for ct in a.schema.key:
            typecheck.check(
                frame_ops.device_key(ct),
                "join: key column type %s is not joinable", ct,
            )
        schema = Schema(
            list(a.schema.key) + list(a.schema.values)
            + list(b.schema.values),
            prefix=a.prefix,
        )
        super().__init__(schema, max(a.num_shards, b.num_shards),
                         make_name("join"))
        self.a, self.b = a, b
        self.dense_keys = dense_keys
        # Per-dep map-side combiners, parallel to deps(): each side
        # pre-reduces with its own fn before its shuffle. Each one's
        # ``device`` is that side's tier verdict.
        self.frame_combiners = (FrameCombiner(a_fn, a.schema),
                                FrameCombiner(b_fn, b.schema))

    def deps(self):
        return (Dep(self.a, shuffle=True, expand=True),
                Dep(self.b, shuffle=True, expand=True))
