"""Frame — a columnar, struct-of-arrays table.

An ordered tuple of equal-length columns whose leading ``prefix``
columns are the key. A device-tier column is a ``torch.Tensor`` on the
frame's device; a host-tier column is a numpy object array. Columns
follow the 32-bit-first rule: int64 and float64 inputs are cast down on
entry, as in the JAX package (docs/design.md §2).

``Frame.from_numpy`` carries the JAX package's columns (as numpy
arrays) across, and ``result_shard_rows`` turns a ``Result`` of either
package back into sorted numpy rows, so the two packages can be fed and
compared on the same data.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigslice_tpu_torch.frame import ops as frame_ops
from bigslice_tpu_torch.slicetype import ColType, Schema, coltype, \
    numpy_dtype

_DOWNCAST = {
    torch.int64: torch.int32,
    torch.uint64: torch.uint32,
    torch.float64: torch.float32,
}


def obj_col(vals) -> np.ndarray:
    """A host (object) column from a list of Python values, list and
    tuple cells included (``np.asarray`` would make equal-length lists
    a 2-D array)."""
    col = np.empty(len(vals), dtype=object)
    for i, v in enumerate(vals):
        col[i] = v
    return col


def to_numpy(col) -> np.ndarray:
    """A column of either package (torch tensor, numpy or JAX array) as
    a host numpy array."""
    if isinstance(col, torch.Tensor):
        return col.detach().cpu().numpy()
    return np.asarray(col)


def _coerce(c, device):
    if isinstance(c, torch.Tensor):
        t = c
    elif isinstance(c, np.ndarray) and c.dtype == np.dtype(object):
        return c  # a host column, its cells as they are
    else:
        a = c if isinstance(c, np.ndarray) else np.asarray(c)
        if a.dtype == np.dtype(object) or a.dtype.kind in ("U", "S"):
            return obj_col(list(c))
        if a.dtype == np.int64:
            a = a.astype(np.int32)
        elif a.dtype == np.uint64:
            a = a.astype(np.uint32)
        elif a.dtype == np.float64:
            a = a.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(a))
    t = t.to(_DOWNCAST.get(t.dtype, t.dtype))
    return t if device is None else t.to(device)


def _infer_coltype(col) -> ColType:
    if isinstance(col, np.ndarray):  # host object column
        tag = ""
        for v in col:
            if v is not None:
                tag = {str: "str", bytes: "bytes"}.get(type(v), "")
                break
        return ColType(np.dtype(object), tag)
    ct = coltype(numpy_dtype(col.dtype))
    if col.dim() > 1:
        ct = ColType(ct.dtype, ct.tag, tuple(col.shape[1:]))
    return ct


class Frame:
    """An immutable columnar batch of rows."""

    __slots__ = ("cols", "schema")

    def __init__(self, cols: Sequence[Any], schema: Optional[Schema] = None,
                 prefix: int = 1, device=None):
        cols = [_coerce(c, device) for c in cols]
        if schema is None:
            schema = Schema([_infer_coltype(c) for c in cols], prefix)
        if len(cols) != len(schema):
            raise ValueError(
                f"frame has {len(cols)} columns but schema has {len(schema)}"
            )
        n = None
        for c in cols:
            cn = int(c.shape[0])
            if n is None:
                n = cn
            elif cn != n:
                raise ValueError(f"ragged columns: {cn} != {n}")
        self.cols: Tuple[Any, ...] = tuple(cols)
        self.schema = schema

    # -- constructors -----------------------------------------------------

    @staticmethod
    def from_numpy(cols: Sequence[np.ndarray], prefix: int = 1,
                   device=None, schema: Optional[Schema] = None
                   ) -> "Frame":
        """The port's Frame over numpy columns (e.g. the JAX package's
        columns read back with ``np.asarray``), placed on ``device``."""
        return Frame([np.asarray(c) for c in cols], schema=schema,
                     prefix=prefix, device=device)

    @staticmethod
    def empty(schema: Schema, device=None) -> "Frame":
        from bigslice_tpu_torch.slicetype import torch_dtype

        cols = [
            torch.empty((0,) + ct.shape, dtype=torch_dtype(ct.dtype),
                        device=device)
            if ct.is_device else np.empty((0,), dtype=object)
            for ct in schema
        ]
        return Frame(cols, schema)

    # -- basics -----------------------------------------------------------

    def __len__(self) -> int:
        return int(self.cols[0].shape[0]) if self.cols else 0

    @property
    def prefix(self) -> int:
        return self.schema.prefix

    @property
    def num_cols(self) -> int:
        return len(self.cols)

    def key_cols(self) -> Tuple[Any, ...]:
        return self.cols[: self.prefix]

    def value_cols(self) -> Tuple[Any, ...]:
        return self.cols[self.prefix :]

    def slice(self, i: int, j: int) -> "Frame":
        """O(1) row-range view."""
        return Frame([c[i:j] for c in self.cols], self.schema)

    @staticmethod
    def concat(frames: Sequence["Frame"]) -> "Frame":
        frames = [f for f in frames if f is not None]
        if not frames:
            raise ValueError("concat of zero frames")
        if len(frames) == 1:
            return frames[0]
        out = []
        for i in range(len(frames[0].schema)):
            cols = [f.cols[i] for f in frames]
            if isinstance(cols[0], torch.Tensor):
                out.append(torch.cat(cols))
            else:
                out.append(np.concatenate(cols))
        return Frame(out, frames[0].schema)

    # -- key ops ----------------------------------------------------------

    def hash_keys(self, seed: int = 0) -> torch.Tensor:
        """uint32 hash of each row's key prefix (int64-carried lanes);
        multi-column keys combine in order."""
        if self.prefix == 0:
            raise ValueError("hash_keys on frame with prefix=0")
        h = None
        for c, ct in zip(self.key_cols(), self.schema.key):
            if not frame_ops.device_key(ct):
                raise TypeError(f"column type {ct} is not hashable")
            ch = frame_ops.hash_device_column(c, seed)
            h = ch if h is None else frame_ops.combine_hashes(h, ch)
        return h

    def partition_ids(self, nparts: int, seed: int = 0) -> torch.Tensor:
        """Shuffle partition of each row: hash(key) % nparts, through
        the routing contract's one implementation
        (``shuffle.partition_ids``: the ``hash_partition`` kernel on the
        card)."""
        from bigslice_tpu_torch.parallel.shuffle import partition_ids

        if self.prefix == 0:
            raise ValueError("partition_ids on frame with prefix=0")
        for ct in self.schema.key:
            if not frame_ops.device_key(ct):
                raise TypeError(f"column type {ct} is not hashable")
        part, _, _ = partition_ids(self.key_cols(), nparts, seed)
        return part

    def sorted_by_key(self) -> "Frame":
        """Stable sort by the key prefix on the frame's device
        (``parallel/sortkernel.py``). Frames with host or vector columns
        need the host sort, which is not ported."""
        from bigslice_tpu_torch.parallel import sortkernel

        if not sortkernel.device_sortable(self):
            raise NotImplementedError(
                "sorted_by_key: host or vector columns need the host sort, "
                "which is not ported")
        return sortkernel.device_sorted_by_key(self)

    # -- row access -------------------------------------------------------

    def numpy_cols(self) -> List[np.ndarray]:
        return [to_numpy(c) for c in self.cols]

    def rows(self) -> List[Tuple]:
        cols = [c.tolist() for c in self.numpy_cols()]
        return list(zip(*cols)) if cols else []

    def __repr__(self) -> str:
        return f"Frame(n={len(self)}, schema={self.schema})"

    def __hash__(self):
        raise TypeError("Frame is not hashable")


def sorted_rows(cols: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Columns reordered lexicographically by their numeric columns
    (first column most significant; a vector column's cells by their
    elements in order); floats compare by their numeric order with NaN
    last, as ``np.lexsort`` orders them. Host (object) columns, whose
    cells may be lists with no order, ride along with their rows: a
    Cogroup's rows sort by their keys, one row per key."""
    cols = [np.asarray(c) for c in cols]
    if not cols or not len(cols[0]):
        return cols
    keys = []
    for c in cols:
        if c.dtype == np.dtype(object):
            continue
        keys.extend(c.reshape(len(c), -1).T if c.ndim > 1 else [c])
    if not keys:
        return cols
    order = np.lexsort(tuple(reversed(keys)))
    return [c[order] for c in cols]


def result_shard_rows(result) -> List[List[np.ndarray]]:
    """Per output shard, the shard's rows as numpy columns sorted
    lexicographically — for a ``Result`` of either package (anything
    with ``num_shards`` and ``reader(shard, ())`` yielding frames)."""
    out = []
    for shard in range(result.num_shards):
        frames = list(result.reader(shard, ()))
        ncols = len(result.schema)
        if frames:
            cols = [
                np.concatenate([to_numpy(f.cols[j]) for f in frames])
                for j in range(ncols)
            ]
        else:
            cols = [np.empty((0,) + ct.shape, ct.dtype)
                    for ct in result.schema]
        out.append(sorted_rows(cols))
    return out
