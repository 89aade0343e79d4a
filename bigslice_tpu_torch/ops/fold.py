"""Fold — keyed sequential aggregation with a typed accumulator.

The input is shuffled by key prefix; each shard folds ``acc = fn(acc,
*values)`` over each key's rows in arrival order and emits ``(key,
acc)``. Unlike Reduce, the fold fn need not be associative, so there
is no map-side combine.

Two tiers, decided at construction:

- **device**: a fold fn that is a tensor function of one row (a trace
  over meta tensors), scalar device columns and a literal ``init``: the
  sort and the rank-stepped fold (``segment.make_sequential_fold_masked``)
  over the frame's device columns, on the local executor, or as the
  ``fold`` stage of the device executor's wave program;
- **host**: any other fn, a callable ``init`` (a fresh mutable zero
  per key) or host keys: the dict loop, on the local executor (the
  device executor's included).

A device Fold over one int32 key whose fn classifies as add/max/min
(not a float add, which the sequential order decides bit for bit) may
declare its keys dense (``dense_keys=``, or a bound the device executor
discovers): the device executor then folds into a [K] table
(``dense.make_dense_fold``).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from bigslice_tpu_torch import sliceio, typecheck
from bigslice_tpu_torch.frame import ops as frame_ops
from bigslice_tpu_torch.frame.frame import Frame
from bigslice_tpu_torch.ops.base import Dep, Slice, make_name
from bigslice_tpu_torch.ops.mapops import meta_outputs
from bigslice_tpu_torch.parallel import segment
from bigslice_tpu_torch.slicetype import Schema, torch_dtype


class Fold(Slice):
    """``Fold(slice, fn, init, out_value)``.

    ``fn(acc, *vals) -> acc``; ``init`` is the zero accumulator (a value
    or a zero-argument callable); ``out_value`` declares the accumulator
    column's type (default: the first value column's). ``dense_keys=``
    declares dense int32 keys below it, which the device executor folds
    into a scatter table when the fn classifies (``dense_op``); the
    local executor ignores the declaration."""

    def __init__(self, slice_: Slice, fn: Callable, init: Any = 0,
                 out_value=None, dense_keys=None):
        typecheck.check(
            slice_.prefix >= 1, "fold: input slice must have a key prefix"
        )
        typecheck.check(
            len(slice_.schema) > slice_.prefix,
            "fold: input slice must have value columns",
        )
        for ct in slice_.schema.key:
            typecheck.check(
                frame_ops.can_hash(ct),
                "fold: key column type %s is not partitionable", ct,
            )
        acc_type = (out_value if out_value is not None
                    else slice_.schema.cols[slice_.prefix])
        schema = Schema(list(slice_.schema.key) + [acc_type],
                        prefix=slice_.prefix)
        super().__init__(schema, slice_.num_shards, make_name("fold"),
                         pragmas=slice_.pragmas)
        self.dep_slice = slice_
        self.fn = fn
        self.init = init
        self.acc_dtype = schema.cols[slice_.prefix].dtype
        self.device = self._device_eligible()
        self.dense_keys = None
        self.dense_op = None
        # The device executor may discover the bound from a key-range
        # probe (``FrameCombiner.auto_dense``'s contract).
        self.auto_dense = True
        self._auto_declared = False
        self._auto_site = None
        if dense_keys is not None:
            self.try_declare_dense(dense_keys)

    def dense_eligible(self) -> bool:
        """One scalar int32 key, one scalar value, a literal init, on
        the device tier."""
        cols = self.dep_slice.schema.cols
        return (self.device and self.dep_slice.prefix == 1
                and len(cols) == 2
                and np.dtype(cols[0].dtype) == np.dtype(np.int32)
                and cols[0].shape == () and cols[1].shape == ()
                and not callable(self.init))

    def try_declare_dense(self, dense_keys: int) -> bool:
        """Declare keys dense in [0, dense_keys); True if the dense
        fold engaged (the fn classified, the bound in range)."""
        if not self.dense_eligible():
            return False
        from bigslice_tpu_torch.parallel import dense

        op = None
        if 0 < dense_keys <= dense.MAX_DENSE_KEYS:
            op = dense.classified_fold_op_cached(
                self.fn, np.dtype(self.acc_dtype),
                np.dtype(self.dep_slice.schema.cols[1].dtype))
        if op is None:
            return False
        self.dense_keys = int(dense_keys)
        self.dense_op = op
        return True

    def retract_dense(self) -> None:
        self.dense_keys = None
        self.dense_op = None

    def _device_eligible(self) -> bool:
        """A literal init, scalar device columns and a fold fn that maps
        one row's meta tensors to one scalar tensor."""
        if callable(self.init):
            return False  # a mutable zero per key: host semantics
        in_schema = self.dep_slice.schema
        acc_ct = self.schema.cols[self.prefix]
        if not all(ct.is_device and ct.shape == ()
                   for ct in list(in_schema) + [acc_ct]):
            return False
        out = meta_outputs(self.fn, [acc_ct] + list(in_schema.values))
        return out is not None and len(out) == 1 and out[0].shape == ()

    def deps(self):
        return (Dep(self.dep_slice, shuffle=True),)

    def reader(self, shard, deps):
        if self.device:
            return self._read_device(deps)
        return self._read_host(deps)

    def _read_device(self, deps):
        """The whole shard folded on its frames' device (the local
        executor places them there: a device Fold is a device
        consumer)."""

        def read():
            frame = sliceio.read_all(deps[0](), self.dep_slice.schema)
            if not len(frame):
                return
            nk = self.prefix
            kern = segment.cached_sorted_fold(
                self.fn, nk, len(self.dep_slice.schema) - nk, self.init,
                torch_dtype(self.acc_dtype))
            keys, accs = kern(list(frame.key_cols()),
                              list(frame.value_cols()), len(frame))
            yield Frame(list(keys) + list(accs), self.schema)

        return read()

    def _read_host(self, deps):
        def read():
            acc = {}
            order = []
            for f in deps[0]():
                nk = f.prefix
                for r in f.rows():
                    k, vals = r[:nk], r[nk:]
                    if k not in acc:
                        acc[k] = (self.init() if callable(self.init)
                                  else self.init)
                        order.append(k)
                    acc[k] = self.fn(acc[k], *vals)
            rows = [k + (acc[k],) for k in order]
            for i in range(0, len(rows), sliceio.DEFAULT_CHUNK_ROWS):
                yield Frame.from_rows(
                    rows[i : i + sliceio.DEFAULT_CHUNK_ROWS], self.schema)

        return read()
