"""Per-dtype column operations: the routing hash and the ops registry.

The routing contract is one set of functions — ``fmix32`` (the murmur3
32-bit finalizer), ``_bits32`` (a column's uint32 lanes, -0.0 folded
onto +0.0), ``_seed32``, ``hash_device_column`` and ``combine_hashes``
— and every shuffle routes rows by it. It is bit-equal to the JAX
package's ``frame/ops.py``, so both packages send every key to the same
partition.

uint32 lanes are carried in int64 tensors holding values in
``[0, 2**32)``: PyTorch's CPU kernels have no uint32 shifts, adds or
remainders, and its int32 ``>>`` is an arithmetic shift. Every step
masks back to 32 bits, and products are split in 16-bit halves so no
intermediate leaves int64's range. The hand-written kernels
(``parallel/cuda_kernels.py``) compute the same function in native
``uint32`` arithmetic.

Host (object) columns hash on the host by a stable CRC-32
(``hash_host_column``; all-str columns through the native kernel, the
rest row by row), bit-equal to the JAX package's, so that host keys
route across processes as device keys do. The registry
(``Ops``, ``register_ops``, ``ops_for``) says which column types may
serve as shuffle and sort keys (``can_hash``, ``can_compare``).
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from bigslice_tpu_torch.slicetype import ColType

M32 = 0xFFFFFFFF
_GOLDEN32 = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 lanes x in [0, 2**32): the high
    16 bits of c contribute only their product's low 16 bits, shifted."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer over int64-carried uint32 lanes."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _bits32(col: torch.Tensor) -> torch.Tensor:
    """A device column's uint32 hash lanes (as int64 in [0, 2**32)):
    integers and bools value-cast (sign-extended, then the low 32 bits),
    floats bit-reinterpreted with -0.0 normalized to +0.0 so equal keys
    hash equally. NaN keeps its bits."""
    dt = col.dtype
    if dt == torch.uint32:
        return col.view(torch.int32).to(torch.int64) & M32
    if dt == torch.bool or not dt.is_floating_point:
        return col.to(torch.int64) & M32
    col = torch.where(col == 0, torch.zeros_like(col), col)
    if dt == torch.float32:
        return col.view(torch.int32).to(torch.int64) & M32
    if dt in (torch.float16, torch.bfloat16):  # the uint16 bits, widened
        return col.view(torch.int16).to(torch.int64) & 0xFFFF
    raise TypeError(f"cannot hash device column of dtype {dt}")


def _seed32(seed: int) -> int:
    return (seed * _GOLDEN32) & M32


def hash_device_column(col: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Hash one device column to uint32 lanes with a seed."""
    return fmix32(_bits32(col) ^ _seed32(seed))


def combine_hashes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Order-dependent (boost::hash_combine-style) combination of two
    uint32-lane hash columns."""
    return fmix32(a ^ ((b + _GOLDEN32 + (a << 6) + (a >> 2)) & M32))


def _fmix32_host(x: int) -> int:
    """``fmix32`` of one Python int in [0, 2**32)."""
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def _fmix32_np(x: np.ndarray) -> np.ndarray:
    """``fmix32`` over a numpy uint32 array (wrapping uint32 products)."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def _stable_obj_hash(v) -> int:
    """Stable (cross-process) 32-bit hash of a host object: zlib CRC-32
    of a str's UTF-8 bytes (surrogates passed through) or of bytes; a
    bool's value; an int's low 32 bits; the CRC-32 of a float's
    ``repr``; a tuple's elements combined in order from a
    length-derived seed."""
    if isinstance(v, str):
        return zlib.crc32(v.encode("utf-8", "surrogatepass"))
    if isinstance(v, bytes):
        return zlib.crc32(v)
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, np.integer)):
        return int(v) & M32
    if isinstance(v, float):
        return zlib.crc32(repr(v).encode())
    if isinstance(v, tuple):
        h = len(v) * 0x85EBCA6B & M32
        for e in v:
            b = _stable_obj_hash(e)
            h = _fmix32_host(h ^ ((b + _GOLDEN32 + (h << 6) + (h >> 2))
                                  & M32))
        return h
    raise TypeError(f"cannot hash host value of type {type(v).__name__}")


def hash_host_column(col, seed: int = 0) -> np.ndarray:
    """Hash a host (object) column to numpy uint32 on the host.

    An all-str column takes the native CRC kernel
    (``native.crc32_strings``), bit-identical to the per-row path: both
    are the zlib CRC-32 of the UTF-8 bytes. A column the kernel refuses
    (a non-str element, a lone surrogate) or a process without it takes
    the exact per-row hash."""
    # Spot-check two cells before building a full list: a mixed or
    # non-str column must not pay an O(n) copy only to be refused.
    if len(col) and isinstance(col[0], str) \
            and isinstance(col[len(col) // 2], str):
        from bigslice_tpu_torch import native

        if native.enabled():
            h = native.crc32_strings(
                col.tolist() if isinstance(col, np.ndarray) else col)
            if h is not None:
                return _fmix32_np(h ^ np.uint32(_seed32(seed)))
    out = np.fromiter((_stable_obj_hash(v) for v in col), dtype=np.uint32,
                      count=len(col))
    return _fmix32_np(out ^ np.uint32(_seed32(seed)))


class Ops:
    """Operations for one column type: whether it may be hashed and
    compared as a key, its host hash, and its host sort key."""

    def __init__(self, can_hash: bool = True, can_compare: bool = True,
                 hash_fn: Optional[Callable[[np.ndarray, int],
                                            np.ndarray]] = None,
                 less_key: Optional[Callable] = None):
        self.can_hash = can_hash
        self.can_compare = can_compare
        self.hash_fn = hash_fn
        self.less_key = less_key


_REGISTRY: Dict[str, Ops] = {}


def register_ops(tag: str, ops: Ops) -> None:
    """Register the ops of host columns tagged ``tag``."""
    _REGISTRY[tag] = ops


def ops_for(ct: ColType) -> Ops:
    """The ops of a column type: device scalars hash and compare; vector
    columns are payload only; host columns take their tag's registered
    ops, else CRC hashing and Python's ordering."""
    if ct.is_device:
        scalar = ct.shape == ()
        return Ops(can_hash=scalar, can_compare=scalar)
    if ct.tag in _REGISTRY:
        return _REGISTRY[ct.tag]
    return Ops(can_hash=True, can_compare=True, hash_fn=hash_host_column)


def can_hash(ct: ColType) -> bool:
    return ops_for(ct).can_hash


def can_compare(ct: ColType) -> bool:
    return ops_for(ct).can_compare


def device_key(ct: ColType) -> bool:
    """A key of the device tier: a scalar device column, which hashes
    and compares on the card. Host keys hash and compare on the JAX
    package's host tier, which this package does not have."""
    return ct.is_device and can_hash(ct)
