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
  per key) or host keys: the dict loop, on the local executor.
"""

from __future__ import annotations

from typing import Any, Callable

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
    declares dense int32 keys below it, which the JAX package lowers to
    a scatter table: the local executor ignores the declaration, and the
    device executor refuses such a Fold by name."""

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
        self.dense_keys = dense_keys
        # The JAX package's staging-time dense probe; nothing here reads
        # it until the dense lowering is ported.
        self.auto_dense = True

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
