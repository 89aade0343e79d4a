"""Column type tuples — the framework's type system.

A slice's type is an ordered tuple of column types plus a *prefix* count
marking how many leading columns form the key for shuffling and
combining. Column types are numpy dtypes, exactly as in the JAX package,
so schemas and task graphs of the two packages compare equal; the
device tier holds each column as a ``torch.Tensor`` of the matching
torch dtype (``torch_dtype``/``numpy_dtype`` map between the two).

A column is either

- a **device** column: a fixed-width 32-bit-first dtype (int8/16/32,
  uint8/16/32, float16/bfloat16/float32, bool), or
- a **host** column: arbitrary Python objects in a numpy object array.

64-bit numerics are not device dtypes: frames downcast them on entry
(docs/design.md §2).

numpy has no bfloat16. Its schema type is ``ml_dtypes.bfloat16`` where
that package is installed (the JAX package's type, so the two packages'
schemas compare equal), else a two-byte structured stand-in; either way
a host copy holds the column's bits (``BFLOAT16``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence, Tuple

import numpy as np
import torch


def _bfloat16_dtype() -> np.dtype:
    try:
        import ml_dtypes
    except ImportError:
        return np.dtype([("bfloat16", "<u2")])
    return np.dtype(ml_dtypes.bfloat16)


#: The numpy (schema) dtype of a ``torch.bfloat16`` device column.
BFLOAT16 = _bfloat16_dtype()

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    BFLOAT16: torch.bfloat16,
}
_TORCH_TO_NP = {t: n for n, t in _NP_TO_TORCH.items()}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype holding a device column of numpy ``dtype``."""
    return _NP_TO_TORCH[np.dtype(dtype)]


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype (schema type) of a torch column dtype."""
    return _TORCH_TO_NP[dtype]


@dataclasses.dataclass(frozen=True)
class ColType:
    """The type of one column: a numpy ``dtype`` (``object`` for host
    columns), an optional host payload ``tag`` ("str"), and the per-row
    trailing ``shape`` (() for scalar columns)."""

    dtype: np.dtype
    tag: str = ""
    shape: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "dtype", np.dtype(self.dtype))
        object.__setattr__(self, "shape", tuple(self.shape))

    @property
    def is_device(self) -> bool:
        return self.dtype != np.dtype(object)

    @property
    def is_host(self) -> bool:
        return self.dtype == np.dtype(object)

    def __repr__(self) -> str:
        if self.is_host:
            return f"host[{self.tag or 'object'}]"
        if self.shape:
            return f"{self.dtype}{list(self.shape)}"
        return str(self.dtype)


def coltype(spec: Any) -> ColType:
    """Coerce a user spec (dtype-like, torch dtype, type, or ColType)
    to a ColType."""
    if isinstance(spec, ColType):
        return spec
    if isinstance(spec, torch.dtype):
        if spec not in _TORCH_TO_NP:
            raise TypeError(
                f"dtype {spec} is not supported on the device tier; use "
                f"a 32-bit dtype"
            )
        return ColType(_TORCH_TO_NP[spec])
    if spec is str:
        return ColType(np.dtype(object), "str")
    if spec is bytes:
        return ColType(np.dtype(object), "bytes")
    if spec is int:
        return ColType(np.dtype(np.int32))
    if spec is float:
        return ColType(np.dtype(np.float32))
    if spec is bool:
        return ColType(np.dtype(np.bool_))
    if spec is object:
        return ColType(np.dtype(object))
    dt = np.dtype(spec)
    if dt == np.dtype(object):
        return ColType(dt)
    if dt not in _NP_TO_TORCH:
        raise TypeError(
            f"dtype {dt} is not supported on the device tier; use a 32-bit "
            f"dtype, or declare the column as a host column (object/str)"
        )
    return ColType(dt)


class Schema:
    """An ordered tuple of column types with a key prefix."""

    __slots__ = ("cols", "prefix")

    def __init__(self, cols: Iterable[Any], prefix: int = 1):
        self.cols: Tuple[ColType, ...] = tuple(coltype(c) for c in cols)
        if not 0 <= prefix <= len(self.cols):
            raise ValueError(
                f"prefix {prefix} out of range for {len(self.cols)} columns"
            )
        self.prefix = prefix

    def __len__(self) -> int:
        return len(self.cols)

    def __getitem__(self, i) -> ColType:
        return self.cols[i]

    def __iter__(self):
        return iter(self.cols)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Schema)
            and self.cols == other.cols
            and self.prefix == other.prefix
        )

    def __hash__(self) -> int:
        return hash((self.cols, self.prefix))

    def __repr__(self) -> str:
        inner = ", ".join(repr(c) for c in self.cols)
        return f"Schema[{inner}; prefix={self.prefix}]"

    @property
    def key(self) -> Tuple[ColType, ...]:
        """The key (prefix) column types."""
        return self.cols[: self.prefix]

    @property
    def values(self) -> Tuple[ColType, ...]:
        """The non-key column types."""
        return self.cols[self.prefix :]

    def with_prefix(self, prefix: int) -> "Schema":
        return Schema(self.cols, prefix)

    def assignable_to(self, other: "Schema") -> bool:
        """Column-wise type compatibility (the prefix is not compared)."""
        return self.cols == other.cols

    @staticmethod
    def concat(a: "Schema", b: "Schema", prefix: int = 1) -> "Schema":
        return Schema(a.cols + b.cols, prefix)


def schema_of(cols: Sequence[Any], prefix: int = 1) -> Schema:
    return Schema(cols, prefix)
