"""Arrow and Parquet interchange at the host boundary.

A ``Frame`` is a struct-of-arrays table, so the mapping is direct:

    device scalar column  <-> pa.Array of the same primitive type
    device vector column  <-> pa.FixedSizeListArray (the trailing dim)
    host "str" column     <-> pa.StringArray
    host list cells       <-> pa.ListArray (ragged: a Cogroup's output),
                              list<int32> when every cell is empty
    other host objects    -> refused by name (nothing is pickled)

64-bit numerics are cast down on entry with numpy ``astype`` (int64 to
int32 wraps, as ``Const`` does). The key prefix travels in the schema
metadata (``bigslice_prefix``). Parquet reads and writes go through
fsspec, so local paths and any URL scheme (``memory://``, ``gs://``,
``s3://``) work. ``pyarrow`` and ``fsspec`` are imported at first use;
without ``pyarrow`` a call raises by name. The sharded source is
``ops/parquet.py``; ``Result.to_arrow``, ``to_pandas`` and
``write_parquet`` are in ``exec/session.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from bigslice_tpu_torch import typecheck
from bigslice_tpu_torch.frame.frame import Frame, obj_col
from bigslice_tpu_torch.slicetype import ColType, Schema


class ArrowMissing(RuntimeError):
    """``pyarrow`` is not installed: Arrow and Parquet need it."""


def _require_pyarrow():
    try:
        import pyarrow as pa
    except ImportError as e:
        raise ArrowMissing(
            "pyarrow is required for Arrow and Parquet interchange") from e
    return pa


def _downcast(a: np.ndarray) -> np.ndarray:
    """64-bit numerics cast down to the 32-bit device tier, as frames
    cast them on entry; a read-only view of Arrow's buffer is copied
    (a tensor over it could be written)."""
    if a.dtype == np.int64:
        return a.astype(np.int32)
    if a.dtype == np.float64:
        return a.astype(np.float32)
    if a.dtype == np.uint64:
        return a.astype(np.uint32)
    return a if a.flags.writeable else a.copy()


def to_arrow(frame: Frame, names: Optional[Sequence[str]] = None):
    """``Frame -> pyarrow.Table``: one device-to-host copy a column.
    Column names default to c0..cN; the key prefix is recorded in the
    schema metadata (``from_arrow`` reads it back)."""
    pa = _require_pyarrow()

    cols = frame.numpy_cols()
    names = list(names) if names is not None else [
        f"c{i}" for i in range(len(cols))]
    typecheck.check(len(names) == len(cols),
                    "to_arrow: %d names for %d columns", len(names),
                    len(cols))
    arrays, fields = [], []
    for name, col, ct in zip(names, cols, frame.schema):
        if ct.is_device and not ct.shape:
            arr = pa.array(col)
        elif ct.is_device:
            arr = pa.FixedSizeListArray.from_arrays(
                pa.array(col.reshape(-1)), int(np.prod(ct.shape)))
        elif ct.tag == "list":
            arr = pa.array([x if isinstance(x, list)
                            else np.asarray(x).tolist() for x in col])
            vt = getattr(arr.type, "value_type", None)
            if pa.types.is_null(arr.type) or (
                    vt is not None and pa.types.is_null(vt)):
                # An empty shard or all-empty groups: a null-typed
                # column breaks a dataset's schema unification and loses
                # the list tag on the way back.
                arr = arr.cast(pa.list_(pa.int32()))
        else:
            typecheck.check(
                all(isinstance(x, str) for x in col),
                "to_arrow: host column %r holds non-string objects (%s); "
                "only str and list host payloads interchange", name, ct)
            arr = pa.array(list(col), type=pa.string())
        arrays.append(arr)
        fields.append(pa.field(name, arr.type))
    schema = pa.schema(
        fields, metadata={b"bigslice_prefix": str(frame.prefix).encode()})
    return pa.Table.from_arrays(arrays, schema=schema)


def from_arrow(table, prefix: Optional[int] = None) -> Frame:
    """``pyarrow.Table -> Frame`` (device columns as CPU tensors).
    ``prefix`` defaults to the ``bigslice_prefix`` metadata that
    ``to_arrow`` writes, else 1."""
    pa = _require_pyarrow()

    if prefix is None:
        meta = table.schema.metadata or {}
        prefix = int(meta.get(b"bigslice_prefix", b"1"))
    cols: List = []
    types: List[ColType] = []
    for column, field in zip(table.columns, table.schema):
        arr = column.combine_chunks()
        t = field.type
        if pa.types.is_fixed_size_list(t):
            flat = _downcast(arr.values.to_numpy(zero_copy_only=False))
            cols.append(flat.reshape(-1, t.list_size))
            types.append(ColType(flat.dtype, shape=(t.list_size,)))
        elif pa.types.is_list(t) or pa.types.is_large_list(t):
            cols.append(obj_col(arr.to_pylist()))
            types.append(ColType(np.dtype(object), tag="list"))
        elif pa.types.is_string(t) or pa.types.is_large_string(t):
            cols.append(obj_col(arr.to_pylist()))
            types.append(ColType(np.dtype(object), tag="str"))
        else:
            col = _downcast(arr.to_numpy(zero_copy_only=False))
            cols.append(col)
            types.append(ColType(col.dtype))
    return Frame(cols, Schema(types, prefix=prefix))


def write_parquet(frame: Frame, url: str,
                  names: Optional[Sequence[str]] = None) -> None:
    """Write one frame as a Parquet file at ``url`` (a local path or
    any fsspec URL)."""
    _require_pyarrow()
    import fsspec
    import pyarrow.parquet as pq

    table = to_arrow(frame, names=names)
    with fsspec.open(url, "wb") as f:
        pq.write_table(table, f)


def read_parquet(url: str, columns: Optional[Sequence[str]] = None,
                 prefix: Optional[int] = None,
                 row_groups: Optional[Sequence[int]] = None) -> Frame:
    """Read a Parquet file at ``url`` into a Frame; ``row_groups``
    selects a subset (the sharded source's unit, ``ops/parquet.py``)."""
    _require_pyarrow()
    import fsspec
    import pyarrow.parquet as pq

    cols = list(columns) if columns else None
    with fsspec.open(url, "rb") as f:
        pf = pq.ParquetFile(f)
        if row_groups is None:
            table = pf.read(columns=cols)
        else:
            table = pf.read_row_groups(list(row_groups), columns=cols)
    return from_arrow(table, prefix=prefix)


def parquet_row_group_count(url: str) -> int:
    _require_pyarrow()
    import fsspec
    import pyarrow.parquet as pq

    with fsspec.open(url, "rb") as f:
        return pq.ParquetFile(f).metadata.num_row_groups
