"""The Slice abstraction: typed, sharded, columnar datasets.

A slice has a schema (column types + key prefix), a shard count,
dependencies (possibly shuffled), an optional combiner, and a per-shard
reader that composes over its dependencies' readers. The planner
(exec/compile.py) fuses shuffle-free chains of slices into one task per
shard.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, Optional, Sequence, Tuple

from bigslice_tpu_torch import typecheck
from bigslice_tpu_torch.slicetype import Schema
from bigslice_tpu_torch.sliceio import Reader, ReaderFactory


@dataclasses.dataclass(frozen=True)
class Name:
    """A unique, human-readable slice name: operation + caller
    file:line + per-call-site index."""

    op: str
    file: str = ""
    line: int = 0
    index: int = 0

    def __str__(self) -> str:
        base = self.op
        if self.file:
            base = f"{base}@{os.path.basename(self.file)}:{self.line}"
        if self.index:
            base = f"{base}#{self.index}"
        return base


_name_lock = threading.Lock()
_name_counters = {}


def make_name(op: str) -> Name:
    loc = typecheck.caller_location()
    file, line = loc if loc else ("", 0)
    with _name_lock:
        key = (op, file, line)
        idx = _name_counters.get(key, 0)
        _name_counters[key] = idx + 1
    return Name(op, file, line, idx)


@dataclasses.dataclass(frozen=True)
class Dep:
    """A dependency on another slice.

    shuffle:     records are hash-partitioned by key prefix before this
                 slice reads them.
    partitioner: optional custom partition function (not used by the
                 operators of this package yet).
    expand:      partition streams are merged by key rather than
                 concatenated (Reduce-style consumers).
    broadcast:   every consumer shard reads EVERY producer task's
                 partition 0 (the full dataset), in producer-shard
                 order: a fusion boundary, like shuffle. The host tier
                 of globally coupled ops (SelfAttend); the device tier
                 reads the producer's device output aligned instead.
    """

    slice: "Slice"
    shuffle: bool = False
    partitioner: Optional[Callable] = None
    expand: bool = False
    broadcast: bool = False


class Combiner:
    """An associative per-key value combiner: ``fn(a_vals, b_vals)``
    combines two rows' value columns."""

    def __init__(self, fn: Callable, name: str = "combine"):
        self.fn = fn
        self.name = name

    def __repr__(self):
        return f"Combiner({self.name})"


class Pragma:
    """An execution hint carried from a slice to its tasks."""

    @property
    def procs(self) -> int:
        return 1

    @property
    def exclusive(self) -> bool:
        return False

    @property
    def materialize(self) -> bool:
        return False


class Procs(Pragma):
    """The slice's tasks each take ``n`` of the local executor's
    ``procs`` permits."""

    def __init__(self, n: int):
        self._n = max(1, n)

    @property
    def procs(self) -> int:
        return self._n


class Exclusive(Pragma):
    """The slice's tasks each take all of the local executor's permits:
    nothing else runs beside one."""

    @property
    def exclusive(self) -> bool:
        return True


class Materialize(Pragma):
    """Break pipelining: the slice's output is stored, and its consumers
    read it as a task boundary of one partition."""

    @property
    def materialize(self) -> bool:
        return True


class Slice(Pragma):
    """Base class for all slice operators. ``pragmas`` aggregate: the
    largest ``procs``, and ``exclusive``/``materialize`` when any
    pragma sets them."""

    def __init__(self, schema: Schema, num_shards: int, name: Name,
                 pragmas: Sequence[Pragma] = ()):
        self.schema = schema
        self.num_shards = num_shards
        self.name = name
        self.pragmas = tuple(pragmas)

    @property
    def procs(self) -> int:
        return max([1] + [p.procs for p in self.pragmas])

    @property
    def exclusive(self) -> bool:
        return any(p.exclusive for p in self.pragmas)

    @property
    def materialize(self) -> bool:
        return any(p.materialize for p in self.pragmas)

    def deps(self) -> Tuple[Dep, ...]:
        return ()

    def combiner(self) -> Optional[Combiner]:
        return None

    def reader(self, shard: int, deps: Sequence[ReaderFactory]) -> Reader:
        """This slice's output for ``shard`` given one reader factory
        per dependency."""
        raise NotImplementedError

    @property
    def prefix(self) -> int:
        return self.schema.prefix

    def __repr__(self) -> str:
        types = ", ".join(repr(c) for c in self.schema)
        return f"{self.name.op}<{types}>"


def unwrap(slice_: Slice) -> Slice:
    """Strip the type-amending wrappers (``Prefixed``) off a slice."""
    from bigslice_tpu_torch.ops.mapops import _PrefixedSlice

    while isinstance(slice_, _PrefixedSlice):
        slice_ = slice_.dep_slice
    return slice_


def single_dep(slice_: Slice, shuffle: bool = False, expand: bool = False,
               partitioner=None) -> Tuple[Dep, ...]:
    return (Dep(slice_, shuffle, partitioner, expand),)
