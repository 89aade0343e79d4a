"""Host-tier sources and sinks: ReaderFunc, WriterFunc, ScanReader.

Arbitrary Python doing I/O a shard at a time, feeding the pipelines
downstream; they run on the local executor (on the device executor,
its host tier). A path is a local file or any fsspec URL
(``utils/fileio.py``).
"""

from __future__ import annotations

import io
import itertools
from typing import Callable, Optional, Sequence, Union

import numpy as np

from bigslice_tpu_torch import sliceio, typecheck
from bigslice_tpu_torch.frame.frame import Frame, obj_col
from bigslice_tpu_torch.ops.base import Dep, Slice, make_name
from bigslice_tpu_torch.slicetype import Schema
from bigslice_tpu_torch.utils import fileio


class ReaderFunc(Slice):
    """A custom per-shard source: ``fn(shard)`` yields batches, each a
    ``Frame`` or a tuple of column sequences; ``out`` declares the
    schema."""

    def __init__(self, num_shards: int, fn: Callable, out,
                 prefix: int = 1):
        typecheck.check(num_shards >= 1,
                        "readerfunc: num_shards must be >= 1")
        schema = out if isinstance(out, Schema) else Schema(out, prefix)
        super().__init__(schema, num_shards, make_name("reader"))
        self.fn = fn

    def reader(self, shard, deps):
        def read():
            for batch in self.fn(shard):
                cols = batch.cols if isinstance(batch, Frame) else batch
                f = Frame(list(cols), self.schema)
                if len(f):
                    yield f

        return read()


class WriterFunc(Slice):
    """A per-shard side-effecting pass-through: ``fn(shard, frame)`` is
    called for every batch, whose rows pass on unchanged; ``done(shard)``
    runs at the end of the stream."""

    def __init__(self, slice_: Slice, fn: Callable,
                 done: Optional[Callable] = None):
        super().__init__(slice_.schema, slice_.num_shards,
                         make_name("writer"), pragmas=slice_.pragmas)
        self.dep_slice = slice_
        self.fn = fn
        self.done = done

    def deps(self):
        return (Dep(self.dep_slice),)

    def reader(self, shard, deps):
        def read():
            for f in deps[0]():
                self.fn(shard, f)
                yield f
            if self.done is not None:
                self.done(shard)

        return read()


#: Rows a frame for random-access (sequence) sources.
SEQ_CHUNK_ROWS = 1 << 16


class ScanReader(Slice):
    """A line-oriented text source: every shard scans the whole input
    and keeps the lines ``i % num_shards == shard``. ``source`` is a
    local path, a callable yielding lines, or a sequence of lines (a
    sequence stripes by random access, ``source[shard::num_shards]``)."""

    def __init__(self, num_shards: int,
                 source: Union[str, Callable, Sequence]):
        typecheck.check(num_shards >= 1,
                        "scanreader: num_shards must be >= 1")
        super().__init__(Schema([str], prefix=1), num_shards,
                         make_name("scanreader"))
        self.source = source

    def _lines(self):
        if callable(self.source):
            yield from self.source()
            return
        with io.TextIOWrapper(fileio.open_read(self.source),
                              encoding="utf-8") as fp:
            for line in fp:
                yield line.rstrip("\n")

    def reader(self, shard, deps):
        ns = self.num_shards

        def frame_of(lines):
            return Frame([obj_col(lines)], self.schema)

        def read_seq(seq):
            step = max(sliceio.DEFAULT_CHUNK_ROWS, SEQ_CHUNK_ROWS)
            mine = seq[shard::ns] if ns > 1 else seq
            for i in range(0, len(mine), step):
                batch = list(mine[i: i + step])
                if batch:
                    yield frame_of(batch)

        def read():
            it = self._lines()
            if ns > 1:
                it = itertools.islice(it, shard, None, ns)
            while True:
                batch = list(itertools.islice(
                    it, sliceio.DEFAULT_CHUNK_ROWS))
                if not batch:
                    return
                yield frame_of(batch)

        if isinstance(self.source, (list, tuple, np.ndarray)):
            return read_seq(self.source)
        return read()
