"""Checksummed columnar frame codec for host and file persistence: the
spill exchange's entries and the ``FileStore``'s partitions.

The container is the JAX package's, byte for byte: a numeric frame
encodes here exactly as ``bigslice_tpu.frame.codec.encode_frame``
encodes it (the same ``<i4``-style dtype descr, tag, trailing dims taken
from the column itself, and CRC32 over the body), so files written by
either package decode in the other.

``BSF4`` (the writer) — numeric columns carry their dtype and trailing
dims in the column header and their payload as raw C-order bytes, so
decode returns them as zero-copy views over the frame buffer
(``torch.frombuffer`` semantics through a read-only numpy view, which
the tensor keeps alive). A header-only scan (``scan_frame``) walks row
counts and column extents without touching payload bytes.

``BSF3`` (legacy) — numeric payloads are ``np.save`` containers. Its
reader stays, and ``encode_frame_v3`` mints such frames for
compatibility tests.

Format (little-endian), common envelope::

  magic   4s   b"BSF3" | b"BSF4"
  blen    u64  body length
  crc32   u32  over the body (validated before any parsing)
  body:
    prefix u32, ncols u32, nrows u32
    per column: kind u8 (0=numeric, 1=object pickle),
                taglen u16 + tag utf-8,
                ndim u8 + ndim*u32 trailing dims (vector columns),
                [BSF4, kind 0 only] dlen u8 + dtype descr ascii,
                len u64, bytes (BSF3 numeric: npy container;
                BSF4 numeric: raw C-order column bytes)

Object columns (kind 1) are pickled lists; they decode into the port's
host object column (``frame.obj_col``). Unpickling runs code: decode
only streams this program wrote.
"""

from __future__ import annotations

import io
import pickle
import struct
import threading
import time
import warnings
import zlib
from typing import BinaryIO, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from bigslice_tpu_torch.frame.frame import Frame, obj_col
from bigslice_tpu_torch.slicetype import ColType, Schema

MAGIC = b"BSF3"    # legacy container (npy numeric payloads)
MAGIC4 = b"BSF4"   # raw-payload container (zero-copy decode)
#: Every frame magic this module reads.
MAGICS = (MAGIC, MAGIC4)


class CorruptionError(IOError):
    """A frame stream failed its checksum or does not parse."""


# -- decode clock ---------------------------------------------------------
#
# Staging wants its read/decode split without plumbing timers through
# every store and reader layer: decode_frame charges its elapsed time to
# a per-thread accumulator that the caller brackets around a drain.

_CLOCK = threading.local()


class decode_clock:
    """Context manager accumulating this thread's ``decode_frame`` time
    into ``.seconds``. Nests: an inner clock re-charges its total to the
    enclosing clock on exit."""

    def __enter__(self):
        self._prev = getattr(_CLOCK, "t", None)
        _CLOCK.t = 0.0
        self.seconds = 0.0
        return self

    def __exit__(self, *exc):
        self.seconds = _CLOCK.t
        if self._prev is None:
            del _CLOCK.t
        else:
            _CLOCK.t = self._prev + self.seconds
        return False


def _clock_charge(dt: float) -> None:
    t = getattr(_CLOCK, "t", None)
    if t is not None:
        _CLOCK.t = t + dt


# -- encode ---------------------------------------------------------------

def _host_array(c) -> np.ndarray:
    """A column as a C-contiguous host numpy array (object columns as
    they are)."""
    if isinstance(c, torch.Tensor):
        return c.detach().cpu().contiguous().numpy()
    return np.asarray(c)


def _encode(frame: Frame, magic: bytes) -> bytes:
    body = io.BytesIO()
    cols = [_host_array(c) for c in frame.cols]
    nrows = int(cols[0].shape[0]) if cols else 0
    body.write(struct.pack("<III", frame.prefix, len(cols), nrows))
    for c, ct in zip(cols, frame.schema):
        descr = b""
        if c.dtype == np.dtype(object):
            payload = pickle.dumps(list(c), protocol=pickle.HIGHEST_PROTOCOL)
            kind, dims = 1, ct.shape
        elif magic == MAGIC4:
            payload = np.ascontiguousarray(c).tobytes()
            kind = 0
            descr = c.dtype.str.encode("ascii")
            # Dims from the ARRAY, like nrows: the raw payload must agree
            # with its header even where the schema disagrees with the
            # column (BSF4's header is the payload's only description).
            dims = tuple(int(d) for d in c.shape[1:])
        else:
            buf = io.BytesIO()
            np.save(buf, c, allow_pickle=False)
            payload = buf.getvalue()
            kind, dims = 0, ct.shape
        tag = ct.tag.encode("utf-8")
        body.write(struct.pack("<BH", kind, len(tag)))
        body.write(tag)
        body.write(struct.pack("<B", len(dims)))
        for d in dims:
            body.write(struct.pack("<I", d))
        if descr:
            body.write(struct.pack("<B", len(descr)))
            body.write(descr)
        body.write(struct.pack("<Q", len(payload)))
        body.write(payload)
    payload = body.getvalue()
    return magic + struct.pack("<QI", len(payload), zlib_crc(payload)) \
        + payload


def encode_frame(frame: Frame) -> bytes:
    """Encode one frame in the current (BSF4) container."""
    return _encode(frame, MAGIC4)


def encode_frame_v3(frame: Frame) -> bytes:
    """The legacy BSF3 encoder (npy numeric payloads), for compatibility
    tests; writers use ``encode_frame``."""
    return _encode(frame, MAGIC)


def zlib_crc(payload) -> int:
    """CRC32 of any buffer-protocol object (bytes, memoryview)."""
    return zlib.crc32(payload) & 0xFFFFFFFF


# -- header-only scan -----------------------------------------------------

class ColExtent(NamedTuple):
    """Where one column's payload lives inside the stream buffer."""

    kind: int                     # 0 numeric, 1 object pickle
    tag: str
    dims: Tuple[int, ...]         # trailing (vector) dims
    dtype: Optional[np.dtype]     # None for object cols / BSF3 numerics
    payload_offset: int           # absolute offset into the buffer
    payload_len: int


class FrameExtent(NamedTuple):
    """One frame's header facts: row count and column extents, gathered
    without touching (or checksumming) payload bytes."""

    version: int                  # 3 | 4
    nrows: int
    prefix: int
    cols: Tuple[ColExtent, ...]
    offset: int                   # frame start (magic byte)
    end: int                      # offset of the next frame


def _parse_envelope(data, offset: int) -> Tuple[int, int, int, int]:
    """(version, blen, crc, body_start) of the frame at ``offset``."""
    if len(data) < offset + 16:
        raise CorruptionError("truncated frame stream")
    magic = bytes(data[offset : offset + 4])
    if magic not in MAGICS:
        raise CorruptionError("bad magic in frame stream")
    blen, crc = struct.unpack_from("<QI", data, offset + 4)
    return (4 if magic == MAGIC4 else 3), blen, crc, offset + 16


def scan_frame(data, offset: int = 0) -> FrameExtent:
    """Header-only scan of one frame: row count and column extents with
    payload bytes skipped (no CRC check — ``decode_frame`` is the
    integrity gate). BSF3 numeric columns scan with ``dtype=None``
    (their dtype lives inside the npy payload)."""
    version, blen, _crc, body_start = _parse_envelope(data, offset)
    end = body_start + blen
    if len(data) < end:
        raise CorruptionError("truncated frame stream")
    try:
        pos = body_start
        prefix, ncols, nrows = struct.unpack_from("<III", data, pos)
        pos += 12
        cols: List[ColExtent] = []
        for _ in range(ncols):
            kind, taglen = struct.unpack_from("<BH", data, pos)
            pos += 3
            tag = bytes(data[pos : pos + taglen]).decode("utf-8")
            pos += taglen
            (ndim,) = struct.unpack_from("<B", data, pos)
            pos += 1
            dims = (struct.unpack_from(f"<{ndim}I", data, pos)
                    if ndim else ())
            pos += 4 * ndim
            dtype = None
            if version == 4 and kind == 0:
                (dlen,) = struct.unpack_from("<B", data, pos)
                pos += 1
                dtype = np.dtype(bytes(data[pos : pos + dlen]).decode("ascii"))
                pos += dlen
            (plen,) = struct.unpack_from("<Q", data, pos)
            pos += 8
            cols.append(ColExtent(kind, tag, tuple(dims), dtype, pos, plen))
            pos += plen
    except (struct.error, UnicodeDecodeError, TypeError, ValueError) as e:
        # A header field cut by truncation or scrambled by corruption
        # surfaces as this module's error, not a struct internal.
        raise CorruptionError("corrupt frame header") from e
    if pos != end:
        raise CorruptionError("frame body length mismatch")
    return FrameExtent(version, nrows, prefix, tuple(cols), offset, end)


def scan_frames(data) -> Iterator[FrameExtent]:
    """Header-only scan of a whole stream buffer: exact row totals
    without decoding a byte of payload."""
    pos = 0
    while pos < len(data):
        ext = scan_frame(data, pos)
        yield ext
        pos = ext.end


# -- decode ---------------------------------------------------------------

def _view(data, dtype: np.dtype, count: int, offset: int, nrows: int,
          dims: Tuple[int, ...]) -> torch.Tensor:
    """A zero-copy tensor over ``count`` items of ``data``. The numpy
    view under it is read-only and keeps ``data`` alive; the tensor keeps
    the numpy view alive. Torch has no read-only tensors (it warns when
    it wraps one), so callers never write a decoded column: staging
    copies out of it."""
    arr = np.frombuffer(data, dtype, count=count, offset=offset)
    if arr.flags.writeable:  # a writable source buffer (bytearray)
        arr.setflags(write=False)
    if dims:
        arr = arr.reshape((nrows,) + dims)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(arr)


def decode_frame(data, offset: int = 0) -> tuple:
    """Decode one frame; returns (frame, next_offset).

    BSF4 numeric columns come back as zero-copy views over ``data``
    (``_view``), which keep ``data`` alive; BSF3 frames decode through
    the npy reader. The CRC over the body is checked before any
    parsing, for both versions."""
    t0 = time.perf_counter()
    version, blen, crc, body_start = _parse_envelope(data, offset)
    end = body_start + blen
    if len(data) < end:
        raise CorruptionError("truncated frame stream")
    # CRC over a memoryview slice: no body copy on the zero-copy path.
    if zlib_crc(memoryview(data)[body_start:end]) != crc:
        raise CorruptionError("frame checksum mismatch")
    ext = scan_frame(data, offset)
    cols: list = []
    coltypes: List[ColType] = []
    for ce in ext.cols:
        payload_end = ce.payload_offset + ce.payload_len
        if payload_end > end:
            raise CorruptionError("truncated frame stream")
        if ce.kind == 1:
            cols.append(obj_col(pickle.loads(
                data[ce.payload_offset : payload_end])))
            coltypes.append(ColType(np.dtype(object), ce.tag, ce.dims))
            continue
        if version == 4:
            count = ext.nrows
            for d in ce.dims:
                count *= d
            if count * ce.dtype.itemsize != ce.payload_len:
                raise CorruptionError("column payload size mismatch")
            col = _view(data, ce.dtype, count, ce.payload_offset, ext.nrows,
                        ce.dims)
        else:
            col = torch.from_numpy(np.load(
                io.BytesIO(data[ce.payload_offset : payload_end]),
                allow_pickle=False))
        cols.append(col)
        coltypes.append(ColType(np.dtype(ce.dtype) if ce.dtype is not None
                                else col.numpy().dtype, ce.tag,
                                tuple(col.shape[1:])))
    frame = Frame(cols, Schema(coltypes, ext.prefix))
    _clock_charge(time.perf_counter() - t0)
    return frame, end


class FrameWriter:
    """Streams encoded frames to a binary file object."""

    def __init__(self, fp: BinaryIO):
        self.fp = fp
        self.nrows = 0

    def write(self, frame: Frame) -> None:
        self.fp.write(encode_frame(frame))
        self.nrows += len(frame)


def read_frames(data) -> Iterator[Frame]:
    """Every frame of a whole stream buffer, in order."""
    pos = 0
    while pos < len(data):
        frame, pos = decode_frame(data, pos)
        yield frame


def write_stream(fp: BinaryIO, frames) -> int:
    """Write ``frames`` to ``fp``; returns the rows written."""
    w = FrameWriter(fp)
    for f in frames:
        w.write(f)
    return w.nrows


def _read_exact(fp, n: int) -> bytes:
    """Read exactly n bytes, looping over short reads."""
    parts = []
    got = 0
    while got < n:
        chunk = fp.read(n - got)
        if not chunk:
            break
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def read_stream(fp: BinaryIO) -> Iterator[Frame]:
    """Incrementally decode frames from a file object, one frame's bytes
    resident at a time: a consumed frame's buffer frees with its
    columns."""
    while True:
        header = _read_exact(fp, 16)
        if not header:
            return
        if len(header) < 16 or header[:4] not in MAGICS:
            raise CorruptionError("bad frame header in stream")
        (blen, _crc) = struct.unpack_from("<QI", header, 4)
        body = _read_exact(fp, blen)
        frame, _ = decode_frame(header + body)
        yield frame
