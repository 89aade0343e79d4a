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

On the local executor the reader runs the same contract a frame at a
time: each side's combiner (``FrameCombiner.combine``) and the inner
join of the two reduced frames (``_inner_join``), which runs the host
tier's combine fns and host keys too (the device executor sends such
a join there), and ignores ``dense_keys=``.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np

from bigslice_tpu_torch import typecheck
from bigslice_tpu_torch.frame import ops as frame_ops
from bigslice_tpu_torch.frame.frame import Frame, to_numpy
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
    codes in [0, dense_keys): each side's combiner takes the
    declaration, and where both fns classify as add/max/min the device
    executor's join runs the dense lowering; otherwise it is ignored.
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
        for ct in a.schema.key:
            typecheck.check(
                frame_ops.can_hash(ct) and frame_ops.can_compare(ct),
                "join: key column type %s is not joinable", ct,
            )
        schema = Schema(
            list(a.schema.key) + list(a.schema.values)
            + list(b.schema.values),
            prefix=a.prefix,
        )
        super().__init__(schema, max(a.num_shards, b.num_shards),
                         make_name("join"),
                         pragmas=tuple(a.pragmas) + tuple(b.pragmas))
        self.a, self.b = a, b
        # Per-dep map-side combiners, parallel to deps(): each side
        # pre-reduces with its own fn before its shuffle. Each one's
        # ``device`` is that side's tier verdict. Join combiners never
        # discover a dense bound (``auto_dense`` stays off).
        self.frame_combiners = (
            FrameCombiner(a_fn, a.schema, dense_keys=dense_keys),
            FrameCombiner(b_fn, b.schema, dense_keys=dense_keys))

    def deps(self):
        return (Dep(self.a, shuffle=True, expand=True),
                Dep(self.b, shuffle=True, expand=True))

    def reader(self, shard, deps):
        def read():
            fa = self.frame_combiners[0].combine_frames(list(deps[0]()))
            fb = self.frame_combiners[1].combine_frames(list(deps[1]()))
            out = _inner_join(fa, fb, self.prefix, self.schema)
            if len(out):
                yield out

        return read()


def _inner_join(fa: Frame, fb: Frame, nkeys: int, schema: Schema) -> Frame:
    """Inner-join two reduced frames (unique keys a side) on their key
    prefixes: ``np.intersect1d`` over a single numeric key, a tuple-keyed
    dict otherwise, on the keys' host copy (one copy a column); the
    rows are gathered where they live."""
    if not len(fa) or not len(fb):
        return Frame.empty(schema)
    ka = [to_numpy(c) for c in fa.cols[:nkeys]]
    kb = [to_numpy(c) for c in fb.cols[:nkeys]]
    if nkeys == 1 and ka[0].dtype != object and kb[0].dtype != object:
        _, ia, ib = np.intersect1d(
            ka[0], kb[0], assume_unique=True, return_indices=True
        )
    else:
        index = {tuple(c[i] for c in kb): i for i in range(len(fb))}
        ia_list: List[int] = []
        ib_list: List[int] = []
        for i in range(len(fa)):
            j = index.get(tuple(c[i] for c in ka))
            if j is not None:
                ia_list.append(i)
                ib_list.append(j)
        ia = np.asarray(ia_list, dtype=np.int64)
        ib = np.asarray(ib_list, dtype=np.int64)
    ta, tb = fa.take(ia), fb.take(ib)
    return Frame(list(ta.cols) + list(tb.cols[nkeys:]), schema)
