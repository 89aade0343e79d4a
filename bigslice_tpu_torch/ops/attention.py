"""SelfAttend — global sequence attention as a Slice combinator.

Input: a slice whose columns are exactly three device vector columns
q, k, v of shape (d,): one global sequence in row order (sharded
contiguously across the input's shards, the Const layout). Output: one
(d,) float32 vector column o, where

    o = softmax(q @ k^T / sqrt(d) [+ causal mask]) @ v

over the GLOBAL sequence. Row order is preserved.

Tiers (the JAX package's):

- DEVICE: the mesh executor's "attend" chain stage runs ring attention
  (``parallel/ringattention.py``) or Ulysses (``parallel/ulysses.py``)
  over the producer's device-resident output, zero-copy. Capacity
  padding is masked by the count; causal positions are logical global
  row indexes. It spans the whole sequence in one program, so it runs
  only when the group's shards fit the device slots (S <= nmesh, so
  S = 1 on one card).
- HOST: the dep is a BROADCAST read (every shard reads every producer
  task's partition 0, the full sequence in shard order), and shard 0
  computes the dense float64 oracle while the other shards emit
  nothing. Correct and deliberately unscalable: global attention has no
  shard-local host decomposition.
"""

from __future__ import annotations

import numpy as np
import torch

from bigslice_tpu_torch import sliceio, typecheck
from bigslice_tpu_torch.frame.frame import Frame, to_numpy
from bigslice_tpu_torch.ops.base import Dep, Slice, make_name
from bigslice_tpu_torch.slicetype import ColType, Schema, numpy_dtype


class SelfAttend(Slice):
    """``SelfAttend(slice, causal=False, dtype=np.float32, block_q=0,
    heads=1, method="auto")`` over a (q[D], k[D], v[D]) vector-column
    slice.

    ``heads > 1`` reads each ``D = heads * head_dim`` vector as stacked
    heads: attention runs independently per head. The device stage
    picks the RING (``block_q`` tiles its scores) or ULYSSES (the full
    padded-sequence score tensor); "auto" picks Ulysses when heads
    divide the device slots, ``heads > 1`` and no ``block_q`` bound is
    set. ``method`` pins one ("ulysses" takes the ring when heads do not
    divide the slots). ``dtype`` is the products' operand type
    (float32 or bfloat16); statistics and the output are float32. Both
    tiers are exact for any method: the choice is one of shape, not of
    semantics."""

    def __init__(self, slice_: Slice, causal: bool = False,
                 dtype=np.float32, block_q: int = 0, heads: int = 1,
                 method: str = "auto"):
        typecheck.check(
            len(slice_.schema) == 3,
            "selfattend: input must have exactly the (q, k, v) "
            "columns (got %d columns)", len(slice_.schema),
        )
        shapes = [ct.shape for ct in slice_.schema]
        typecheck.check(
            all(ct.is_device for ct in slice_.schema)
            and all(len(sh) == 1 for sh in shapes)
            and len(set(shapes)) == 1,
            "selfattend: q, k, v must be device vector columns of one "
            "shared (d,) shape (got %s)", shapes,
        )
        self.d = int(shapes[0][0])
        typecheck.check(
            heads >= 1 and self.d % heads == 0,
            "selfattend: heads (%s) must divide the vector width (%s)",
            heads, self.d,
        )
        typecheck.check(
            method in ("auto", "ring", "ulysses"),
            "selfattend: method must be 'auto', 'ring', or 'ulysses' "
            "(got %r)", method,
        )
        self.method = method
        self.heads = int(heads)
        self.causal = bool(causal)
        self.dtype = (numpy_dtype(dtype) if isinstance(dtype, torch.dtype)
                      else np.dtype(dtype))
        self.block_q = int(block_q)
        schema = Schema([ColType(np.float32, shape=(self.d,))], prefix=1)
        super().__init__(schema, slice_.num_shards, make_name("attend"),
                         pragmas=slice_.pragmas)
        self.dep_slice = slice_

    def deps(self):
        # Broadcast: every shard's task reads EVERY producer task's
        # partition 0, since the host tier needs the whole sequence.
        return (Dep(self.dep_slice, broadcast=True),)

    def reader(self, shard, deps):
        if shard != 0:
            return sliceio.empty_reader()

        def read():
            from bigslice_tpu_torch.parallel.ulysses import \
                dense_mha_reference

            frame = sliceio.read_all(deps[0](), self.dep_slice.schema)
            if not len(frame):
                return
            q, k, v = (to_numpy(c).astype(np.float32) for c in frame.cols)
            # One oracle covers both: heads == 1 is MHA with one head.
            hd = self.d // self.heads
            o = dense_mha_reference(
                *(x.reshape(-1, self.heads, hd) for x in (q, k, v)),
                causal=self.causal,
            ).reshape(-1, self.d).astype(np.float32)
            yield Frame([o], self.schema)

        return read()
