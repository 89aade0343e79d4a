"""Reduce — keyed pairwise combination with map-side combining.

The input is shuffled by key prefix; an associative combine fn merges
values per key, both *map-side* (in the producer task, before the
shuffle — the executor applies the consumer's combiner there) and
*reduce-side* (in this slice's own task). The shuffle dep sets
``expand=True`` so partition streams merge rather than concatenate.

Device lowering: keys declared dense (``dense_keys=K``, or a bound the
device executor discovers from the data) with a combine fn that
classifies per value column as add/max/min run as a [K] table of
accumulators (parallel/dense.py); other classified fns over non-float
scalar keys run as open-addressed hash aggregation
(parallel/hashagg.py); every other device-traceable combine fn, float
keys, and ops whose hash table overflowed run on the sort + segmented
scan lowering (parallel/segment.py). Host keys (strings) and a combine
fn that is not a tensor function of the values belong to the host tier:
the local executor combines them on the host
(``segment.host_reduce_by_key``), the device executor's included. On
the local executor a device combiner runs the sort and segmented scan
over each frame (``segment.cached_reduce_kernel``), whatever it
declares.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from bigslice_tpu_torch import typecheck
from bigslice_tpu_torch.frame import ops as frame_ops
from bigslice_tpu_torch.frame.frame import Frame
from bigslice_tpu_torch.ops.base import Combiner, Dep, Slice, make_name
from bigslice_tpu_torch.parallel import segment
from bigslice_tpu_torch.slicetype import Schema, torch_dtype

class LoweringNotPorted(NotImplementedError):
    """A slice needs something this package or its environment does
    not have (a URL path without ``fsspec``: ``fileio.URLNotPorted``)."""


_TRACE_CACHE: dict = {}
_TRACE_CACHE_MAX = 256


def _vals_traceable(fn: Callable, schema: Schema) -> bool:
    """Can ``fn`` combine this schema's value columns on the device?
    Memoized on (fn, value signature)."""
    if not all(ct.is_device for ct in schema):
        return False
    if any(ct.shape != () for ct in schema.key):
        return False
    try:
        key = (fn, tuple((ct.dtype, ct.shape) for ct in schema.values))
        hit = _TRACE_CACHE.get(key)
    except TypeError:  # unhashable fn: classify uncached
        key = hit = None
    if hit is not None:
        return hit
    out = _vals_traceable_uncached(fn, schema)
    if key is not None:
        _TRACE_CACHE[key] = out
        while len(_TRACE_CACHE) > _TRACE_CACHE_MAX:
            _TRACE_CACHE.pop(next(iter(_TRACE_CACHE)))
    return out


def _vals_traceable_uncached(fn: Callable, schema: Schema) -> bool:
    """Trace ``fn`` over meta tensors (shapes and dtypes only, no data):
    device-capable when every output column keeps its input's shape and
    dtype."""
    try:
        nvals = len(schema.values)
        cfn = segment.canonical_combine(fn, nvals)

        def specs():
            return tuple(
                torch.empty(ct.shape, dtype=torch_dtype(ct.dtype),
                            device="meta")
                for ct in schema.values
            )

        out = tuple(cfn(specs(), specs()))
        return len(out) == nvals and all(
            isinstance(o, torch.Tensor)
            and tuple(o.shape) == ct.shape
            and o.dtype == torch_dtype(ct.dtype)
            for o, ct in zip(out, schema.values)
        )
    except Exception:
        return False


class FrameCombiner:
    """A Reduce's combiner over its input schema. ``device`` is the tier
    verdict; ``hash_ops`` the per-column add/max/min classification the
    device executor's hash-aggregate lowering runs it with;
    ``dense_keys``/``dense_ops`` the dense-table declaration; ``combine``
    the local executor's combine of one frame."""

    def __init__(self, fn: Callable, schema: Schema,
                 dense_keys: Optional[int] = None):
        self.fn = fn
        self.schema = schema
        self.nkeys = schema.prefix
        self.nvals = len(schema) - schema.prefix
        typecheck.check(self.nvals >= 1,
                        "reduce: slice must have at least one value column")
        self.device = _vals_traceable(fn, schema)
        self._kernel = (segment.cached_reduce_kernel(fn, self.nkeys,
                                                     self.nvals)
                        if self.device else None)
        # Dense-key declaration (parallel/dense.py): keys are int32
        # codes in [0, dense_keys); dense_ops is the per-column
        # add/max/min classification. A fn that does not classify, a
        # key of another shape or type, or the host tier quietly keeps
        # the other lowerings.
        self.dense_keys = None
        self.dense_ops = None
        # The device executor may discover a dense bound from the data
        # (a min/max probe of a group's first wave) when none is
        # declared. Off by default: Reduce opts in; a JoinAggregate
        # must not (its two sides' shuffles have to route identically,
        # which independent per-side discovery cannot guarantee).
        self.auto_dense = False
        # Set by the executor that discovered the bound, and the op site
        # whose probe did (kept off too if a later wave disproves it).
        self._auto_declared = False
        self._auto_site = None
        if dense_keys is not None:
            self.try_declare_dense(dense_keys)

    def dense_eligible(self) -> bool:
        """The structural half of the dense contract: one scalar int32
        key on the device tier (``try_declare_dense`` checks the fn)."""
        ct = self.schema.cols[0]
        return (self.device and self.nkeys == 1
                and np.dtype(ct.dtype) == np.dtype(np.int32)
                and ct.shape == ())

    def try_declare_dense(self, dense_keys: int) -> bool:
        """Declare keys dense in [0, dense_keys); True if the dense
        lowering engaged. A bound out of (0, ``MAX_DENSE_KEYS``] quietly
        keeps the other lowerings: callers derive it from the data's
        size and must not start failing when the data outgrows the
        table. Vector value columns scatter whole rows."""
        if not self.dense_eligible():
            return False
        from bigslice_tpu_torch.parallel import dense

        ops = None
        if 0 < dense_keys <= dense.MAX_DENSE_KEYS:
            ops = dense.classified_ops_cached(
                self.fn, self.nvals,
                tuple(np.dtype(ct.dtype) for ct in self.schema.values),
                tuple(tuple(ct.shape) for ct in self.schema.values))
        if ops is None:
            return False
        self.dense_keys = int(dense_keys)
        self.dense_ops = ops
        return True

    def retract_dense(self) -> None:
        """Undo a discovered declaration (a later wave proved the probed
        bound wrong): programs built after this take the range-agnostic
        lowerings."""
        self.dense_keys = None
        self.dense_ops = None

    def combine(self, frame: Frame) -> Frame:
        """Combine equal keys within one frame: on the frame's device
        (sort and segmented scan) for a device combiner, else on the
        host copy."""
        if not len(frame):
            return frame
        if self._kernel is not None:
            keys, vals = self._kernel(frame.key_cols(), frame.value_cols(),
                                      len(frame))
        else:
            cols = frame.numpy_cols()
            keys, vals = segment.host_reduce_by_key(
                cols[: self.nkeys], cols[self.nkeys:], self.fn, self.nvals)
        return Frame(list(keys) + list(vals), self.schema)

    def combine_frames(self, frames) -> Frame:
        frames = [f for f in frames if f is not None and len(f)]
        if not frames:
            return Frame.empty(self.schema)
        return self.combine(Frame.concat(frames))

    def hash_ops(self) -> Optional[Tuple[str, ...]]:
        """The per-column add/max/min ops the hash-aggregate lowering
        runs this combiner with, or None where the JAX package sends it
        to the sort lowering: float or non-scalar keys, or a combine fn
        that does not classify per column (a vector value column
        classifies over one row's [G] vectors, as in the JAX package's
        ``_hash_combine_ops``, and its rows combine whole in the table).
        (The executor also sends an op whose table overflowed there.)"""
        from bigslice_tpu_torch.parallel import dense, keyutil

        if not self.device or not keyutil.hash_keys_eligible(
                self.schema.key):
            return None
        try:
            return dense.classified_ops_cached(
                self.fn, self.nvals,
                tuple(ct.dtype for ct in self.schema.values),
                tuple(tuple(ct.shape) for ct in self.schema.values),
            )
        except TypeError:  # unhashable fn: lru_cache key fails
            return None


class Reduce(Slice):
    def __init__(self, slice_: Slice, fn: Callable,
                 dense_keys: Optional[int] = None):
        """``dense_keys``: optional declaration that the (single int32)
        key column holds dense codes in ``[0, dense_keys)``. When the
        combine fn classifies as per-column add/max/min, the device
        executor lowers the combine to a [dense_keys] table
        (parallel/dense.py); otherwise the declaration is ignored. Keys
        outside the declared range fail the run."""
        typecheck.check(
            slice_.prefix >= 1, "reduce: input slice must have a key prefix"
        )
        typecheck.check(
            len(slice_.schema) > slice_.prefix,
            "reduce: input slice must have value columns",
        )
        for ct in slice_.schema.key:
            typecheck.check(
                frame_ops.can_hash(ct),
                "reduce: key column type %s is not partitionable", ct,
            )
        super().__init__(slice_.schema, slice_.num_shards,
                         make_name("reduce"), pragmas=slice_.pragmas)
        self.dep_slice = slice_
        self.fn = fn
        self._combiner = Combiner(fn, name="reduce")
        # One FrameCombiner serves both the producer shuffle's map-side
        # combine and this slice's reduce-side combine, so a dense bound
        # discovered at the producer wires the consumer too.
        self.frame_combiner = FrameCombiner(fn, slice_.schema,
                                            dense_keys=dense_keys)
        self.frame_combiner.auto_dense = True

    def deps(self):
        return (Dep(self.dep_slice, shuffle=True, partitioner=None,
                    expand=True),)

    def combiner(self):
        return self._combiner

    def reader(self, shard, deps):
        def read():
            out = self.frame_combiner.combine_frames(list(deps[0]()))
            if len(out):
                yield out

        return read()
