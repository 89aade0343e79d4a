"""External sort and spill: keyed data beyond memory on bounded memory.

A stream larger than memory is read in runs; each run is sorted and
spilled to disk in the BSF4 codec (``frame/codec.py``), and the runs
stream back through a k-way merge (``sliceio.merge_reader``).

- *in-run sorting*: each frame is copied to the host once as it
  arrives, and each run sorts there (``Frame.sorted_by_key``: the host
  lexsort), whatever its column types;
- *spill and merge* are host tier (disk and the merge).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from typing import List, Optional

from bigslice_tpu_torch import sliceio
from bigslice_tpu_torch.frame import codec
from bigslice_tpu_torch.frame.frame import Frame
from bigslice_tpu_torch.slicetype import Schema

#: Rows per sorted spill run.
DEFAULT_RUN_ROWS = 1 << 18

#: Rows spilled by every Spiller of the process (read under its lock).
SPILLED_ROWS = 0
_SPILLED_LOCK = threading.Lock()


class Spiller:
    """Spill frame runs to a private temp directory; read them back as
    streams, one frame resident a run."""

    def __init__(self, dir: Optional[str] = None):
        self.dir = tempfile.mkdtemp(prefix="bigslice-torch-spill-",
                                    dir=dir)
        self._n = 0

    def spill(self, frames) -> int:
        path = os.path.join(self.dir, f"run-{self._n:06d}")
        self._n += 1
        rows = 0
        with open(path, "wb") as fp:
            for f in frames:
                fp.write(codec.encode_frame(f))
                rows += len(f)
        global SPILLED_ROWS
        with _SPILLED_LOCK:
            SPILLED_ROWS += rows
        return rows

    def readers(self) -> List[sliceio.Reader]:
        return [self._read(os.path.join(self.dir, f"run-{i:06d}"))
                for i in range(self._n)]

    def _read(self, path: str) -> sliceio.Reader:
        with open(path, "rb") as fp:
            yield from codec.read_stream(fp)

    def cleanup(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


def sort_reader(reader: sliceio.Reader, schema: Schema,
                run_rows: Optional[int] = None,
                spill_dir: Optional[str] = None) -> sliceio.Reader:
    """Sort a stream by its key prefix on bounded memory: runs of up to
    ``run_rows`` rows are sorted and spilled, then merged back. A
    stream that fits one run never touches disk."""
    if run_rows is None:
        run_rows = DEFAULT_RUN_ROWS  # read late: tests may patch it
    spiller: Optional[Spiller] = None
    pending: List[Frame] = []
    have = 0

    def flush() -> Frame:
        nonlocal pending, have
        run = Frame.concat(pending).sorted_by_key()
        pending, have = [], 0
        return run

    for f in reader:
        if not len(f):
            continue
        pending.append(f.to_host())
        have += len(f)
        if have >= run_rows:
            if spiller is None:
                spiller = Spiller(spill_dir)
            spiller.spill(sliceio.frame_reader(
                flush(), sliceio.DEFAULT_CHUNK_ROWS))
    if spiller is None:
        if pending:
            yield from sliceio.frame_reader(flush(),
                                            sliceio.DEFAULT_CHUNK_ROWS)
        return
    if pending:
        spiller.spill(sliceio.frame_reader(flush(),
                                           sliceio.DEFAULT_CHUNK_ROWS))
    try:
        yield from sliceio.merge_reader(spiller.readers(), schema)
    finally:
        spiller.cleanup()


def reduce_reader(readers: List[sliceio.Reader], schema: Schema,
                  combine_fn) -> sliceio.Reader:
    """Merge key-sorted combined streams (at most one row a key each)
    and combine equal keys across them: one row a key out.

    A combine fn that classifies as per-column add/max/min over scalar
    device value columns takes ``segment.grouped_reduceat`` over each
    merged frame with a one-row carry across frames; any other fn is
    applied per row."""
    from bigslice_tpu_torch.parallel.dense import classified_ops_cached
    from bigslice_tpu_torch.parallel.segment import canonical_combine

    nk = schema.prefix
    nvals = len(schema) - nk
    val_cts = list(schema)[nk:]
    ops = None
    if nk >= 1 and all(ct.is_device and ct.shape == () for ct in val_cts):
        try:
            ops = classified_ops_cached(
                combine_fn, nvals, tuple(ct.dtype for ct in val_cts))
        except TypeError:  # unhashable fn
            ops = None
    if ops is not None:
        yield from _reduce_reader_vector(readers, schema, ops)
        return
    cfn = canonical_combine(combine_fn, nvals)
    cur_key = None
    cur_vals = None
    out_rows = []
    for f in sliceio.merge_reader(readers, schema):
        for row in f.rows():
            k, v = row[:nk], row[nk:]
            if k == cur_key:
                cur_vals = cfn(cur_vals, v)
            else:
                if cur_key is not None:
                    out_rows.append(cur_key + tuple(cur_vals))
                    if len(out_rows) >= sliceio.DEFAULT_CHUNK_ROWS:
                        yield Frame.from_rows(out_rows, schema)
                        out_rows = []
                cur_key, cur_vals = k, v
    if cur_key is not None:
        out_rows.append(cur_key + tuple(cur_vals))
    if out_rows:
        yield Frame.from_rows(out_rows, schema)


def _reduce_reader_vector(readers: List[sliceio.Reader], schema: Schema,
                          ops) -> sliceio.Reader:
    """Equal-key combining of the merged stream a frame at a time
    (``grouped_reduceat``); the last group carries into the next frame
    as a one-row frame."""
    from bigslice_tpu_torch.parallel.segment import grouped_reduceat

    nk = schema.prefix
    carry = None
    for f in sliceio.merge_reader(readers, schema):
        if not len(f):
            continue
        if carry is not None:
            f = Frame.concat([carry, f])
            carry = None
        cols = f.numpy_cols()
        keys, vals = grouped_reduceat(cols[:nk], cols[nk:], ops)
        out = Frame(keys + vals, schema)
        if len(out) > 1:
            yield from sliceio.frame_reader(
                out.slice(0, len(out) - 1), sliceio.DEFAULT_CHUNK_ROWS)
        carry = out.slice(len(out) - 1, len(out))
    if carry is not None and len(carry):
        yield carry
