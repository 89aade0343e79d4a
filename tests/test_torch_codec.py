"""The port's BSF4 codec against the JAX package's
(``bigslice_tpu.frame.codec``), on seeded frames.

A numeric frame must encode byte for byte as the JAX package encodes
it, and each package must decode the other's bytes (BSF3 frames the
JAX package writes too); the comparisons are exact. Corruption raises
``CorruptionError``, ``scan_frames`` reads headers only, and decoded
columns are zero-copy views over an immutable buffer that outlive the
caller's reference to it.
"""

import gc
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bigslice_tpu.frame import codec as ref_codec  # noqa: E402
from bigslice_tpu.frame.frame import Frame as RefFrame  # noqa: E402
from bigslice_tpu.frame.frame import obj_col as ref_obj_col  # noqa: E402
from bigslice_tpu_torch.frame import codec  # noqa: E402
from bigslice_tpu_torch.frame.frame import Frame, obj_col  # noqa: E402
from bigslice_tpu_torch.slicetype import ColType, Schema  # noqa: E402


def _numeric_cols(seed: int, n=None):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(0, 300)) if n is None else n
    return [
        rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32),
        rng.randn(n).astype(np.float32),
        rng.randint(0, 2**32 - 1, n, dtype=np.uint64).astype(np.uint32),
        rng.randint(0, 255, n).astype(np.uint8),
        rng.rand(n, 3).astype(np.float32),          # a vector column
        rng.randint(0, 2, n).astype(np.bool_),
    ]


def _assert_cols_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == np.dtype(object):
            assert list(g) == list(w)
        else:
            assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bsf4_bytes_equal_the_jax_packages(seed):
    cols = _numeric_cols(seed)
    for prefix in (1, 2):
        want = ref_codec.encode_frame(RefFrame(cols, prefix=prefix))
        got = codec.encode_frame(Frame.from_numpy(cols, prefix=prefix))
        assert got == want


@pytest.mark.parametrize("seed", [4, 5])
def test_bsf3_bytes_equal_the_jax_packages(seed):
    cols = _numeric_cols(seed)
    want = ref_codec.encode_frame_v3(RefFrame(cols, prefix=1))
    assert codec.encode_frame_v3(Frame.from_numpy(cols)) == want


@pytest.mark.parametrize("encoder", ["bsf4", "bsf3"])
def test_the_port_decodes_the_jax_packages_bytes(encoder):
    rng = np.random.RandomState(11)
    stream = b""
    frames = []
    for i in range(4):
        cols = _numeric_cols(20 + i) + [
            ref_obj_col([f"s{int(x)}" for x in
                         rng.randint(0, 50, len(_numeric_cols(20 + i)[0]))])]
        frames.append(cols)
        f = RefFrame(cols, prefix=1)
        stream += (ref_codec.encode_frame(f) if encoder == "bsf4"
                   else ref_codec.encode_frame_v3(f))
    decoded = list(codec.read_frames(stream))
    assert len(decoded) == len(frames)
    for d, cols in zip(decoded, frames):
        _assert_cols_equal(d.cols, cols)
        assert d.schema.prefix == 1
        assert d.schema[6].tag == "str"


def test_the_jax_package_decodes_the_ports_bytes():
    for i in range(3):
        cols = _numeric_cols(30 + i)
        n = len(cols[0])
        port = Frame(cols + [obj_col([f"k{j}" for j in range(n)])],
                     prefix=2)
        got, end = ref_codec.decode_frame(codec.encode_frame(port))
        assert got.schema.prefix == 2
        _assert_cols_equal(got.to_host().cols,
                           cols + [np.array([f"k{j}" for j in range(n)],
                                            dtype=object)])


def test_stream_through_a_file_round_trips():
    frames = [Frame.from_numpy(_numeric_cols(40 + i)) for i in range(3)]
    fp = io.BytesIO()
    assert codec.write_stream(fp, frames) == sum(len(f) for f in frames)
    fp.seek(0)
    back = list(codec.read_stream(fp))
    for b, f in zip(back, frames):
        _assert_cols_equal(b.cols, [c.numpy() for c in f.cols])


@pytest.mark.parametrize("damage", ["flip", "truncate", "magic"])
def test_corruption_raises(damage):
    blob = bytearray(codec.encode_frame(Frame.from_numpy(
        _numeric_cols(7, n=64))))
    if damage == "flip":
        blob[40] ^= 0x01
    elif damage == "truncate":
        blob = blob[: len(blob) // 2]
    else:
        blob[0:4] = b"XXXX"
    with pytest.raises(codec.CorruptionError):
        codec.decode_frame(bytes(blob))
    with pytest.raises(codec.CorruptionError):
        list(codec.read_stream(io.BytesIO(bytes(blob))))


def test_scan_frames_reads_headers_only():
    frames = [Frame.from_numpy(_numeric_cols(50 + i)) for i in range(4)]
    stream = b"".join(codec.encode_frame(f) for f in frames)
    exts = list(codec.scan_frames(stream))
    assert [e.nrows for e in exts] == [len(f) for f in frames]
    assert [e.nrows for e in exts] == [
        e.nrows for e in ref_codec.scan_frames(stream)]
    ce = exts[0].cols[0]
    col = np.frombuffer(stream, ce.dtype, count=exts[0].nrows,
                        offset=ce.payload_offset)
    assert np.array_equal(col, frames[0].cols[0].numpy())
    ext3 = codec.scan_frame(codec.encode_frame_v3(frames[0]))
    assert ext3.version == 3 and ext3.cols[0].dtype is None
    # A damaged payload leaves the scan intact; decode still fails.
    if ce.payload_len:
        bad = bytearray(stream)
        bad[ce.payload_offset] ^= 0xFF
        assert list(codec.scan_frames(bytes(bad)))[0].nrows == exts[0].nrows
        with pytest.raises(codec.CorruptionError):
            codec.decode_frame(bytes(bad))


def test_decoded_columns_are_readonly_views_that_outlive_the_buffer():
    f = Frame.from_numpy([np.arange(100, dtype=np.int32),
                          np.linspace(0, 1, 100, dtype=np.float32)])
    blob = codec.encode_frame(f)
    lo = np.frombuffer(blob, np.uint8).ctypes.data
    dec, _ = codec.decode_frame(blob)
    for c in dec.cols:
        # Zero copy: the column's bytes lie inside the immutable buffer.
        assert lo <= c.data_ptr() < lo + len(blob)
    assert memoryview(blob).readonly
    expect = [c.clone() for c in dec.cols]
    del blob, f
    gc.collect()
    for c, e in zip(dec.cols, expect):
        assert torch.equal(c, e)


def test_dims_follow_the_column_not_the_schema():
    schema = Schema([ColType(np.dtype(np.float32), "", ())], 1)
    col = torch.from_numpy(np.random.RandomState(0).rand(8, 3).astype(
        np.float32))
    f = Frame([col], schema)
    for enc in (codec.encode_frame, codec.encode_frame_v3):
        g, _ = codec.decode_frame(enc(f))
        assert torch.equal(g.cols[0], col)


def test_decode_clock_accumulates():
    blob = codec.encode_frame(Frame.from_numpy([np.arange(64,
                                                          dtype=np.int32)]))
    with codec.decode_clock() as ck:
        codec.decode_frame(blob)
        codec.decode_frame(blob)
    assert ck.seconds > 0.0
