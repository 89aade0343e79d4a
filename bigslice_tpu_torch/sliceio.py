"""Record I/O: a *Reader* is an ``Iterator[Frame]`` — a pull-based
stream of columnar batches; a *ReaderFactory* is a zero-argument
callable producing a fresh Reader.

``merge_reader`` is the host tier's k-way merge of key-sorted streams
(spilled runs, sortio's reduce): a vectorized watermark merge for
integer keys, a per-row heap merge for the rest, in the same order.
"""

from __future__ import annotations

import heapq
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from bigslice_tpu_torch.frame.frame import Frame
from bigslice_tpu_torch.slicetype import Schema

Reader = Iterator[Frame]
ReaderFactory = Callable[[], Reader]

#: Default batch size for host-tier sources.
DEFAULT_CHUNK_ROWS = 4096

#: Target rows per batch entering a fused chain's first device stage on
#: the local executor (the compiler re-chunks there, ``_make_do``).
DEVICE_BATCH_ROWS = 1 << 16


def empty_reader() -> Reader:
    return iter(())


def frame_reader(frame: Frame, chunk: Optional[int] = None) -> Reader:
    """Stream a frame in chunks of at most ``chunk`` rows."""
    if chunk is None or chunk >= len(frame):
        if len(frame):
            yield frame
        return
    for i in range(0, len(frame), chunk):
        yield frame.slice(i, min(i + chunk, len(frame)))


def multi_reader(readers: Sequence[Reader]) -> Reader:
    """Concatenate readers."""
    for r in readers:
        yield from r


def read_all(reader: Reader, schema: Optional[Schema] = None) -> Frame:
    """Drain a reader into a single frame."""
    frames = [f for f in reader if len(f)]
    if not frames:
        if schema is None:
            raise ValueError("read_all of empty reader with no schema")
        return Frame.empty(schema)
    return Frame.concat(frames)


def rebatch(reader: Reader, rows: int) -> Reader:
    """Re-chunk a stream to batches of ``rows`` rows (the last one
    shorter)."""
    pending: List[Frame] = []
    have = 0
    for f in reader:
        if not len(f):
            continue
        pending.append(f)
        have += len(f)
        while have >= rows:
            merged = Frame.concat(pending)
            yield merged.slice(0, rows)
            rest = merged.slice(rows, len(merged))
            pending = [rest] if len(rest) else []
            have = len(rest)
    if have:
        yield Frame.concat(pending)


def merge_reader(readers: Sequence[Reader], schema: Schema) -> Reader:
    """Streaming k-way merge of key-sorted readers on the host. Rows
    come out sorted by (key, input index, position within input).

    Scalar integer keys take the vectorized watermark merge (a batch
    lexsort of every buffer's safely emittable prefix); float keys (NaN
    breaks every watermark comparison), object keys and vector key
    columns take the per-row heap merge. Both orders are the same."""
    if schema.prefix >= 1 and all(
        ct.is_device and ct.shape == ()
        and np.dtype(ct.dtype).kind in ("i", "u", "b")
        for ct in schema.key
    ):
        yield from _merge_reader_vector(readers, schema)
        return
    yield from _merge_reader_heap(readers, schema)


def _merge_reader_vector(readers: Sequence[Reader],
                         schema: Schema) -> Reader:
    """Batch merge on the WATERMARK rule: wm = the smallest buffered
    tail key among inputs not yet exhausted; every buffered row with a
    key strictly below wm is final, so those rows concatenate and
    lexsort by (key, input, position). Rows equal to wm wait: an input
    whose tail equals wm extends its buffer a frame a round until its
    tail passes wm or it is exhausted (then its bound is +inf), so
    buffering is bounded by the longest equal-key run."""
    prefix = schema.prefix
    bufs: dict = {}  # input index -> [numpy column lists] (nonempty)
    streams = {}
    exhausted = set()
    pos0 = {}
    for j, r in enumerate(readers):
        f = _next_nonempty(r)
        if f is not None:
            bufs[j] = [f.numpy_cols()]
            streams[j] = r
            pos0[j] = 0
        else:
            exhausted.add(j)

    def nrows(cols) -> int:
        return len(cols[0])

    def tail_key(frames):
        cols = frames[-1]
        return tuple(c[nrows(cols) - 1] for c in cols[:prefix])

    def below_wm(cols, wm) -> int:
        """Length of the prefix of rows with key strictly below wm."""
        lt = None
        eq = np.ones(nrows(cols), dtype=bool)
        for c, w in zip(cols[:prefix], wm):
            step = eq & (c < w)
            lt = step if lt is None else (lt | step)
            eq = eq & (c == w)
        return int(lt.sum())  # sorted input: the mask is a prefix

    def pull(j) -> None:
        nf = _next_nonempty(streams[j])
        if nf is None:
            exhausted.add(j)
        else:
            bufs.setdefault(j, []).append(nf.numpy_cols())

    while bufs:
        open_tails = [tail_key(bufs[j]) for j in bufs
                      if j not in exhausted]
        wm = min(open_tails) if open_tails else None  # None = +inf
        parts, tags, poss = [], [], []
        for j in sorted(bufs):
            taken = 0
            frames = bufs[j]
            while frames:
                cols = frames[0]
                n = nrows(cols) if wm is None else below_wm(cols, wm)
                if n == 0:
                    break
                parts.append([c[:n] for c in cols])
                tags.append(np.full(n, j, np.int64))
                poss.append(np.arange(taken, taken + n, dtype=np.int64)
                            + pos0[j])
                taken += n
                if n < nrows(cols):
                    frames[0] = [c[n:] for c in cols]
                    break
                frames.pop(0)
            pos0[j] += taken
            if not frames:
                del bufs[j]
        if parts:
            merged = [np.concatenate([p[i] for p in parts])
                      for i in range(len(schema))]
            order = np.lexsort(tuple(reversed([
                *merged[:prefix], np.concatenate(tags),
                np.concatenate(poss)])))
            out = Frame([c[order] for c in merged], schema)
            yield from frame_reader(out, DEFAULT_CHUNK_ROWS)
        if wm is None:
            break
        for j in list(bufs):
            if j not in exhausted and tail_key(bufs[j]) == wm:
                pull(j)


def _merge_reader_heap(readers: Sequence[Reader],
                       schema: Schema) -> Reader:
    cursors = []  # [numpy cols, row index, reader]
    for r in readers:
        f = _next_nonempty(r)
        if f is not None:
            cursors.append([f.numpy_cols(), 0, r])
    if not cursors:
        return
    prefix = schema.prefix

    def keyat(cur):
        cols, i, _ = cur
        return tuple(c[i] for c in cols[:prefix])

    heap = [(keyat(c), j) for j, c in enumerate(cursors)]
    heapq.heapify(heap)
    out_rows = []
    while heap:
        _, j = heapq.heappop(heap)
        cur = cursors[j]
        cols, i, r = cur
        out_rows.append(tuple(c[i] for c in cols))
        if len(out_rows) >= DEFAULT_CHUNK_ROWS:
            yield Frame.from_rows(out_rows, schema)
            out_rows = []
        i += 1
        if i >= len(cols[0]):
            nf = _next_nonempty(r)
            if nf is None:
                continue
            cur[0], cur[1] = nf.numpy_cols(), 0
        else:
            cur[1] = i
        heapq.heappush(heap, (keyat(cur), j))
    if out_rows:
        yield Frame.from_rows(out_rows, schema)


def _next_nonempty(r: Reader) -> Optional[Frame]:
    for f in r:
        if len(f):
            return f
    return None
