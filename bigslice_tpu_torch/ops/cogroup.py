"""Cogroup — the general N-ary grouping and outer join by key.

``Cogroup(a, b, ...)`` shuffles every input by its key prefix (the key
types must agree); each output row is one distinct key over all inputs
followed, per input, by the *list* of that input's value rows under the
key: one object column of lists per input value column, an empty list
where the input lacks the key. One input is group-by-key; several are a
full outer join with grouped values.

The device executor lowers it (``parallel/cogroup.py``): one tagged,
stable sort over the union of the inputs' shuffled rows, a rank-scatter
into per-input [keys, G] matrices with exact counts, a capacity G that
the executor discovers, and a host decode into the lists; inputs with
host or vector columns, a Cogroup fused with other stages or feeding a
shuffle and a machine-combined group run on its host tier. The local
executor runs the host reader: each
input's partition sorted on bounded memory (``sortio.sort_reader``) and
a sorted merge of whole groups across the inputs (``_Cursor``).
"""

from __future__ import annotations

from typing import List

import numpy as np

from bigslice_tpu_torch import sliceio, typecheck
from bigslice_tpu_torch.frame import ops as frame_ops
from bigslice_tpu_torch.frame.frame import Frame
from bigslice_tpu_torch.ops.base import Dep, Slice, make_name
from bigslice_tpu_torch.slicetype import ColType, Schema


class Cogroup(Slice):
    """Group one or more keyed slices by their shared key prefix.

    Output schema: the key columns, then for each input and each of its
    value columns a host column of lists (tag ``"list"``); prefix = the
    key count. ``num_shards`` is the largest of the inputs'."""

    def __init__(self, *slices: Slice):
        typecheck.check(len(slices) >= 1,
                        "cogroup: expected at least one slice")
        key_types = None
        for s in slices:
            typecheck.check(
                s.prefix >= 1, "cogroup: input %s must have a key prefix",
                s.name,
            )
            kt = s.schema.key
            if key_types is None:
                key_types = kt
            else:
                typecheck.check(
                    tuple(c.dtype for c in kt)
                    == tuple(c.dtype for c in key_types),
                    "cogroup: key column types mismatch: %s vs %s",
                    kt, key_types,
                )
        for ct in key_types:
            typecheck.check(
                frame_ops.can_hash(ct) and frame_ops.can_compare(ct),
                "cogroup: key column type %s is not groupable", ct,
            )
        cols: List[ColType] = list(key_types)
        for s in slices:
            cols.extend(ColType(np.dtype(object), tag="list")
                        for _ in s.schema.values)
        super().__init__(Schema(cols, prefix=len(key_types)),
                         max(s.num_shards for s in slices),
                         make_name("cogroup"),
                         pragmas=tuple(p for s in slices for p in s.pragmas))
        self.slices = tuple(slices)

    @property
    def nvals(self) -> tuple:
        """Each input's value-column count."""
        return tuple(len(s.schema) - s.prefix for s in self.slices)

    def deps(self):
        return tuple(Dep(s, shuffle=True) for s in self.slices)

    def reader(self, shard, deps):
        nk = self.prefix

        def read():
            from bigslice_tpu_torch import sortio

            cursors = [
                _Cursor(sortio.sort_reader(dep(), self.slices[i].schema),
                        nk, len(self.slices[i].schema) - nk)
                for i, dep in enumerate(deps)
            ]
            out_rows = []
            while True:
                best = None
                for cur in cursors:
                    k = cur.key()
                    if k is not None and (best is None or k < best):
                        best = k
                if best is None:
                    break
                row = list(best)
                for cur in cursors:
                    row.extend(cur.take_group(best))
                out_rows.append(tuple(row))
                if len(out_rows) >= sliceio.DEFAULT_CHUNK_ROWS:
                    yield Frame.from_rows(out_rows, self.schema)
                    out_rows = []
            if out_rows:
                yield Frame.from_rows(out_rows, self.schema)

        return read()


class _Cursor:
    """Buffered cursor over a key-sorted frame stream (host numpy
    columns): the current key, and whole groups, which may span frame
    boundaries. Group starts are found once a frame by an adjacent-row
    key diff (any key type, object cells included)."""

    def __init__(self, reader, nk: int, nvals: int):
        self.reader = reader
        self.nk = nk
        self.nvals = nvals
        self.cols = None
        self.n = 0
        self.i = 0
        self._starts = None
        self._run = 0
        self._advance_frame()

    def _advance_frame(self):
        for f in self.reader:
            if len(f):
                self.cols = f.numpy_cols()
                self.n = len(f)
                self.i = 0
                diff = np.zeros(self.n, dtype=bool)
                diff[0] = True
                for a in self.cols[: self.nk]:
                    diff[1:] |= np.asarray(a[1:] != a[:-1], dtype=bool)
                self._starts = np.flatnonzero(diff)
                self._run = 0
                return
        self.cols = None

    def key(self):
        if self.cols is None:
            return None
        return tuple(c[self.i] for c in self.cols[: self.nk])

    def take_group(self, key):
        """The value-column lists of every contiguous row equal to
        ``key`` (empty lists when the current key differs)."""
        groups = None
        while self.cols is not None and self.key() == key:
            start = self.i
            end = (int(self._starts[self._run + 1])
                   if self._run + 1 < len(self._starts) else self.n)
            if groups is None:
                groups = [[] for _ in range(len(self.cols) - self.nk)]
            for j, c in enumerate(self.cols[self.nk:]):
                groups[j].extend(c[start:end])
            self.i = end
            self._run += 1
            if self.i >= self.n:
                self._advance_frame()
        if groups is None:
            return [[] for _ in range(self.nvals)]
        return groups
