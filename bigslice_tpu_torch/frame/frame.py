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

Placement is one rule (``Frame.to``): a frame's device columns move to
a device together, its host columns stay where they are. The host
tier reads rows through one device-to-host copy a column
(``numpy_cols``), never a read a cell.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigslice_tpu_torch.frame import ops as frame_ops
from bigslice_tpu_torch.slicetype import BFLOAT16, ColType, Schema, \
    coltype, numpy_dtype

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
        col = col.detach().cpu()
        if col.dtype == torch.bfloat16:  # numpy has no bfloat16: its bits
            return col.view(torch.int16).numpy().view(BFLOAT16)
        return col.numpy()
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
        bf16 = a.dtype == BFLOAT16  # numpy has no bfloat16: its bits
        t = torch.from_numpy(np.ascontiguousarray(
            a.view(np.int16) if bf16 else a))
        if bf16:
            t = t.view(torch.bfloat16)
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
    def from_rows(rows: Sequence[Tuple], schema: Schema) -> "Frame":
        """A frame of Python rows: device columns become CPU tensors of
        the schema's dtypes, host columns object arrays."""
        cols = []
        for i, ct in enumerate(schema):
            vals = [r[i] for r in rows]
            if ct.is_device:
                cols.append(torch.from_numpy(
                    np.asarray(vals, dtype=ct.dtype).reshape(
                        (len(vals),) + ct.shape)))
            else:
                cols.append(obj_col(vals))
        return Frame(cols, schema)

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

    def take(self, idx) -> "Frame":
        """Rows gathered by an index array (a tensor or numpy array):
        device columns on their device, host columns on the host."""
        from bigslice_tpu_torch.parallel.segment import take

        host_idx = dev_idx = None
        out = []
        for c in self.cols:
            if isinstance(c, torch.Tensor):
                if dev_idx is None or dev_idx.device != c.device:
                    dev_idx = torch.as_tensor(idx).to(c.device,
                                                      torch.int64)
                out.append(take(c, dev_idx))
            else:
                if host_idx is None:
                    host_idx = to_numpy(idx)
                out.append(c[host_idx])
        return Frame(out, self.schema)

    def with_prefix(self, prefix: int) -> "Frame":
        return Frame(self.cols, self.schema.with_prefix(prefix))

    def with_cols(self, cols: Sequence[Any], schema: Schema) -> "Frame":
        return Frame(cols, schema)

    def to(self, device) -> "Frame":
        """The frame with its device columns on ``device`` (itself when
        they are there already): the one placement rule."""
        device = torch.device(device)
        if all(not isinstance(c, torch.Tensor) or c.device == device
               for c in self.cols):
            return self
        return Frame([c.to(device) if isinstance(c, torch.Tensor) else c
                      for c in self.cols], self.schema)

    def to_host(self) -> "Frame":
        return self.to("cpu")

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
        multi-column keys combine in order. Device columns hash on
        their device, host columns on the host through their ops'
        ``hash_fn`` (the stable CRC); a mixed key combines both on the
        device of its device key columns, a host key on the host."""
        if self.prefix == 0:
            raise ValueError("hash_keys on frame with prefix=0")
        device = next((c.device for c in self.key_cols()
                       if isinstance(c, torch.Tensor)), torch.device("cpu"))
        h = None
        for c, ct in zip(self.key_cols(), self.schema.key):
            o = frame_ops.ops_for(ct)
            if not o.can_hash:
                raise TypeError(f"column type {ct} is not hashable")
            if ct.is_device:
                ch = frame_ops.hash_device_column(c, seed)
            else:
                fn = o.hash_fn or frame_ops.hash_host_column
                ch = torch.from_numpy(
                    np.asarray(fn(c, seed)).astype(np.int64)).to(device)
            h = ch if h is None else frame_ops.combine_hashes(h, ch)
        return h

    def partition_ids(self, nparts: int, seed: int = 0) -> torch.Tensor:
        """Shuffle partition of each row: hash(key) % nparts, int32.
        Device keys route through the routing contract's one
        implementation (``shuffle.partition_ids``: the
        ``hash_partition`` kernel on the card); host and mixed keys
        through ``hash_keys``."""
        from bigslice_tpu_torch.parallel.shuffle import partition_ids

        if self.prefix == 0:
            raise ValueError("partition_ids on frame with prefix=0")
        if all(frame_ops.device_key(ct) for ct in self.schema.key):
            part, _, _ = partition_ids(self.key_cols(), nparts, seed)
            return part
        return (self.hash_keys(seed) % nparts).to(torch.int32)

    def sort_indices(self) -> np.ndarray:
        """Stable argsort of rows by the key prefix (lexicographic), on
        the host: ``np.lexsort`` for numeric keys, Python's ordering of
        key tuples for object keys."""
        if self.prefix == 0:
            raise ValueError("sort_indices on frame with prefix=0")
        keys = [to_numpy(c) for c in self.key_cols()]
        if any(k.dtype == np.dtype(object) for k in keys):
            return np.asarray(
                sorted(range(len(self)),
                       key=lambda i: tuple(k[i] for k in keys)),
                dtype=np.int64,
            )
        return np.lexsort(tuple(reversed(keys)))

    def sorted_by_key(self) -> "Frame":
        """Stable sort by the key prefix: on the frame's device for
        scalar device columns (``parallel/sortkernel.py``), else the
        host lexsort (host keys, vector columns)."""
        from bigslice_tpu_torch.parallel import sortkernel

        if sortkernel.device_sortable(self):
            return sortkernel.device_sorted_by_key(self)
        return self.take(self.sort_indices())

    # -- row access -------------------------------------------------------

    def numpy_cols(self) -> List[np.ndarray]:
        return [to_numpy(c) for c in self.cols]

    def row(self, i: int) -> Tuple:
        out = []
        for c in self.cols:
            v = c[i]
            if isinstance(v, torch.Tensor):
                out.append(v.cpu().numpy() if v.dim() else v.item())
            else:
                out.append(v)
        return tuple(out)

    def rows(self) -> List[Tuple]:
        """The rows as tuples of Python values (vector cells as numpy
        arrays, host cells as they are): one device-to-host copy a
        column."""
        cols = [list(c) if c.dtype == np.dtype(object) or c.ndim > 1
                else c.tolist() for c in self.numpy_cols()]
        return list(zip(*cols)) if cols else []

    def to_pylists(self) -> List[list]:
        """Each column as a Python list (vector cells as nested lists,
        host cells as they are)."""
        return [c.tolist() if c.dtype != np.dtype(object) else list(c)
                for c in self.numpy_cols()]

    def __repr__(self) -> str:
        return f"Frame(n={len(self)}, schema={self.schema})"

    def __eq__(self, other) -> bool:
        """Equal schemas and equal cells, wherever the columns lie
        (NaN is unequal to itself, as in ``np.array_equal``)."""
        if not isinstance(other, Frame):
            return NotImplemented
        if self.schema != other.schema or len(self) != len(other):
            return False
        for a, b in zip(self.numpy_cols(), other.numpy_cols()):
            if a.dtype == np.dtype(object) or b.dtype == np.dtype(object):
                if list(a) != list(b):
                    return False
            elif not np.array_equal(a, b):
                return False
        return True

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
