"""The port's Frame and Schema against the JAX package's, on the CPU.

The cases of tests/test_frame.py, each on the same numpy inputs in both
packages: schemas by their repr (the packages' ColType classes differ),
cells exactly, hashes bit for bit (``hash_keys`` as uint32), the codec
through each package's decoder. The helpers ``Frame.__eq__``,
``with_prefix``, ``with_cols``, ``to_pylists`` and ``Schema.with_prefix``,
``assignable_to``, ``concat``, ``schema_of`` answer as the JAX
package's do, and bfloat16 keys hash and route as the JAX package
routes them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

from bigslice_tpu import Frame as RefFrame  # noqa: E402
from bigslice_tpu import Schema as RefSchema  # noqa: E402
from bigslice_tpu.frame import codec as ref_codec  # noqa: E402
from bigslice_tpu.frame import ops as ref_ops  # noqa: E402
from bigslice_tpu.slicetype import schema_of as ref_schema_of  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.frame import codec  # noqa: E402
from bigslice_tpu_torch.frame import ops as frame_ops  # noqa: E402
from bigslice_tpu_torch.frame.frame import Frame, to_numpy  # noqa: E402
from bigslice_tpu_torch.slicetype import BFLOAT16, ColType  # noqa: E402
from bigslice_tpu_torch.slicetype import Schema, schema_of  # noqa: E402


def _u32(h):
    return to_numpy(h).astype(np.uint32)


def test_schema_basics():
    s = Schema([np.int32, np.float32, str], prefix=2)
    ref = RefSchema([np.int32, np.float32, str], prefix=2)
    assert repr(s) == repr(ref)
    assert len(s) == 3 and s.prefix == 2
    assert s[0].is_device and s[2].is_host
    assert s.key == s.cols[:2]
    assert s == Schema([np.int32, np.float32, str], prefix=2)
    assert s != s.with_prefix(1)
    assert repr(s.with_prefix(1)) == repr(ref.with_prefix(1))
    assert s.assignable_to(s.with_prefix(0))
    assert not s.assignable_to(Schema([np.int32, np.int32, str]))
    cat = Schema.concat(s, Schema([np.uint8]), prefix=3)
    assert repr(cat) == repr(RefSchema.concat(ref, RefSchema([np.uint8]),
                                              prefix=3))
    assert schema_of([np.int32, str], 2) == Schema([np.int32, str], 2)
    assert repr(schema_of([np.int32])) == repr(ref_schema_of([np.int32]))


def test_schema_prefix_range():
    with pytest.raises(ValueError):
        Schema([np.int32], prefix=2)
    with pytest.raises(ValueError):
        RefSchema([np.int32], prefix=2)


def test_frame_construction_and_infer():
    f = Frame([[1, 2, 3], ["a", "b", "c"]])
    ref = RefFrame([[1, 2, 3], ["a", "b", "c"]])
    assert len(f) == 3
    assert f.schema[0].dtype == np.int32  # int64 cast down to int32
    assert f.schema[1].is_host
    assert f.row(1) == ref.row(1) == (2, "b")
    assert repr(f.schema) == repr(ref.schema)


def test_frame_ragged_rejected():
    with pytest.raises(ValueError):
        Frame([[1, 2], ["a"]])


def test_slice_take_concat():
    cols = [np.arange(10, dtype=np.int32), np.arange(10, dtype=np.float32)]
    f, ref = Frame(cols), RefFrame(cols)
    s, rs = f.slice(2, 5), ref.slice(2, 5)
    assert len(s) == 3 and s.row(0) == rs.row(0) == (2, 2.0)
    t = f.take(np.array([9, 0, 4]))
    assert [r[0] for r in t.rows()] == [9, 0, 4]
    c = Frame.concat([s, t])
    assert len(c) == 6 and c.row(3) == (9, 9.0)
    assert c.to_pylists() == RefFrame.concat(
        [rs, ref.take(np.array([9, 0, 4]))]).to_pylists()


def test_from_rows_roundtrip():
    schema = Schema([np.int32, str], prefix=1)
    rows = [(1, "x"), (2, "y")]
    f = Frame.from_rows(rows, schema)
    assert list(f.rows()) == rows
    assert f == Frame([np.array([1, 2], np.int32),
                       np.array(["x", "y"], dtype=object)], schema)


@pytest.mark.parametrize("seed", [1, 2])
def test_hash_deterministic_and_spread(seed):
    cols = [np.arange(1000, dtype=np.int32)]
    f = Frame(cols)
    h = _u32(f.hash_keys(seed=seed))
    np.testing.assert_array_equal(h, _u32(f.hash_keys(seed=seed)))
    np.testing.assert_array_equal(
        h, np.asarray(RefFrame(cols).hash_keys(seed=seed)))
    assert not np.array_equal(h, _u32(f.hash_keys(seed=seed + 1)))
    parts = to_numpy(f.partition_ids(8))
    np.testing.assert_array_equal(
        parts, np.asarray(RefFrame(cols).partition_ids(8)))
    assert np.bincount(parts, minlength=8).min() > 0


def test_hash_host_column_stable():
    col = np.array(["apple", "banana", "apple"], dtype=object)
    h = _u32(Frame([col]).hash_keys())
    assert h[0] == h[2] != h[1]
    np.testing.assert_array_equal(h, np.asarray(RefFrame([col]).hash_keys()))


def test_hash_multicolumn():
    cols = [np.array([1, 1, 2], np.int32), np.array([1, 2, 1], np.int32)]
    h = _u32(Frame(cols, prefix=2).hash_keys())
    assert len(set(h.tolist())) == 3  # an order-dependent combine
    np.testing.assert_array_equal(
        h, np.asarray(RefFrame(cols, prefix=2).hash_keys()))


def test_float_negzero_hash_equal():
    col = np.array([0.0, -0.0], np.float32)
    h = _u32(Frame([col]).hash_keys())
    assert h[0] == h[1]
    np.testing.assert_array_equal(h, np.asarray(RefFrame([col]).hash_keys()))


def test_sort_indices_device_and_host():
    cols = [np.array([3, 1, 2], np.int32), np.array([0, 1, 2], np.int32)]
    np.testing.assert_array_equal(Frame(cols).sort_indices(), [1, 2, 0])
    g = [np.array(["b", "a", "c"], dtype=object)]
    np.testing.assert_array_equal(Frame(g).sort_indices(),
                                  RefFrame(g).sort_indices())


def test_sort_multicolumn_stable():
    cols = [np.array([1, 2, 1, 2], np.int32),
            np.array([9, 8, 7, 6], np.int32)]
    out = Frame(cols, prefix=2).sorted_by_key()
    assert list(out.rows()) == [(1, 7), (1, 9), (2, 6), (2, 8)]
    assert out == Frame([np.array([1, 1, 2, 2], np.int32),
                         np.array([7, 9, 6, 8], np.int32)], prefix=2)


def test_empty_frame():
    schema = Schema([np.int32, str])
    f = Frame.empty(schema)
    assert len(f) == 0 and list(f.rows()) == []
    assert f == Frame.empty(schema)
    assert f.to_pylists() == RefFrame.empty(RefSchema([np.int32, str])) \
        .to_pylists() == [[], []]


def test_jax_columns():
    """A JAX array column enters the port as numpy."""
    import jax.numpy as jnp

    f = Frame([np.asarray(jnp.arange(5, dtype=jnp.int32))])
    assert len(f) == 5
    assert f.to_host().row(4) == (4,)
    assert f.hash_keys().shape == (5,)


class TestCodec:
    def roundtrip(self, f):
        data = codec.encode_frame(f)
        out, pos = codec.decode_frame(data)
        assert pos == len(data)
        assert out == f.to_host() == f
        ref, _ = ref_codec.decode_frame(data)  # the JAX package reads it
        assert ref.to_pylists() == f.to_pylists()

    def test_numeric(self):
        self.roundtrip(Frame([np.arange(100, dtype=np.int32),
                              np.linspace(0, 1, 100, dtype=np.float32)],
                             prefix=2))

    def test_object(self):
        self.roundtrip(Frame([np.array(["a", "bb", "ccc"], dtype=object)]))

    def test_empty(self):
        self.roundtrip(Frame.empty(Schema([np.int32])))

    def test_stream(self):
        frames = [Frame([np.arange(i + 1, dtype=np.int32)]) for i in range(5)]
        blob = b"".join(codec.encode_frame(f) for f in frames)
        out = list(codec.read_frames(blob))
        assert len(out) == 5
        assert all(a == b for a, b in zip(out, frames))

    def test_corruption_detected(self):
        data = bytearray(codec.encode_frame(
            Frame([np.arange(10, dtype=np.int32)])))
        data[len(data) // 2] ^= 0xFF
        with pytest.raises(codec.CorruptionError):
            codec.decode_frame(bytes(data))


def test_fmix32_mixes():
    x = np.arange(4, dtype=np.uint32)
    y = to_numpy(frame_ops.fmix32(torch.from_numpy(x.astype(np.int64))))
    assert len(set(y.tolist())) == 4
    np.testing.assert_array_equal(y.astype(np.uint32), ref_ops.fmix32(x))


def test_float64_ndarray_downcast_to_device():
    f = Frame([np.array([1.5, 2.5, 1.5, 3.5]), np.arange(4, dtype=np.int64)])
    assert f.schema[0].dtype == np.float32
    assert f.schema[1].dtype == np.int32
    assert len(f.hash_keys()) == 4


def test_codec_preserves_coltype_tag():
    col = np.empty(2, dtype=object)
    col[:] = ["a", "b"]
    f = Frame([col], Schema([ColType(np.dtype(object), "mytag")], 1))
    out, _ = codec.decode_frame(codec.encode_frame(f))
    assert out.schema[0].tag == "mytag"
    assert out == f


def test_frame_eq_with_prefix_with_cols_to_pylists():
    cols = [np.array([3, 1, 2], np.int32),
            np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], np.float32),
            np.array(["x", "y", "z"], dtype=object)]
    f, ref = Frame(cols), RefFrame(cols)
    assert f.to_pylists() == ref.to_pylists()
    assert f == Frame(cols) and f != f.with_prefix(2)
    assert f.with_prefix(2).prefix == ref.with_prefix(2).prefix == 2
    assert (f == "x") is False
    swapped = f.with_cols([cols[0] + 1, cols[1], cols[2]], f.schema)
    assert swapped != f and swapped.to_pylists()[0] == [4, 2, 3]
    nan = Frame([np.array([np.nan], np.float32)])
    assert nan != nan  # NaN is unequal to itself, as in np.array_equal
    assert (RefFrame([np.array([np.nan], np.float32)])
            != RefFrame([np.array([np.nan], np.float32)]))


@pytest.mark.parametrize("seed", [0, 7])
def test_bfloat16_keys_hash_and_route_as_the_jax_package(seed):
    """bfloat16 device columns: their uint16 bits widened, -0.0 folded
    onto +0.0 (reference frame/ops.py), bit-equal to the JAX package, and
    a Reshuffle sends each row to the JAX package's shard."""
    import bigslice_tpu as ref_bs
    from bigslice_tpu.exec.session import Session as RefSession

    rng = np.random.RandomState(seed)
    col = (rng.randn(500) * 100).astype(ml_dtypes.bfloat16)
    col[:4] = np.array([0.0, -0.0, np.inf, -np.inf], ml_dtypes.bfloat16)
    f = Frame([col, np.arange(500, dtype=np.int32)])
    assert f.cols[0].dtype == torch.bfloat16
    assert f.schema[0].dtype == BFLOAT16 == np.dtype(ml_dtypes.bfloat16)
    assert f.numpy_cols()[0].tobytes() == col.tobytes()
    ref = RefFrame([col, np.arange(500, dtype=np.int32)])
    assert repr(f.schema) == repr(ref.schema)
    h = _u32(f.hash_keys(seed))
    np.testing.assert_array_equal(h, np.asarray(ref.hash_keys(seed)))
    assert h[0] == h[1]
    vals = np.arange(500, dtype=np.int32)
    got = bst.result_shard_rows(bst.Session(
        executor=bst.MeshExecutor(device="cpu")).run(
            bst.Reshuffle(bst.Const(4, col, vals))))
    want = bst.result_shard_rows(RefSession().run(
        ref_bs.Reshuffle(ref_bs.Const(4, col, vals))))
    for g, w in zip(got, want):
        assert sorted(g[1].tolist()) == sorted(w[1].tolist())


def test_bfloat16_without_ml_dtypes():
    """Where ml_dtypes is missing, a bfloat16 column's schema type is a
    two-byte stand-in: its host copy holds the bits, which come back to
    the same tensor, and its keys hash and route as with ml_dtypes."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import sys
        sys.modules["ml_dtypes"] = None
        import numpy as np, torch
        from bigslice_tpu_torch.frame.frame import Frame
        from bigslice_tpu_torch.parallel import cuda_kernels
        from bigslice_tpu_torch.slicetype import BFLOAT16
        assert BFLOAT16 == np.dtype([("bfloat16", "<u2")]), BFLOAT16
        t = torch.tensor([1.5, -0.0, 0.0, 3.0, float("nan")],
                         dtype=torch.bfloat16)
        f = Frame([t])
        assert f.schema[0].dtype == BFLOAT16 and f.schema[0].is_device
        host = f.numpy_cols()[0]
        assert host.dtype == BFLOAT16
        back = Frame([host])
        assert back.cols[0].dtype == torch.bfloat16
        assert torch.equal(back.cols[0].view(torch.int16),
                           t.view(torch.int16))
        h = f.hash_keys(3)
        assert int(h[1]) == int(h[2])
        ids, _ = cuda_kernels.hash_partition([t], 4, 3)
        print(",".join(str(int(x)) for x in h.tolist()),
              ",".join(str(int(x)) for x in ids.tolist()))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    t = torch.tensor([1.5, -0.0, 0.0, 3.0, float("nan")],
                     dtype=torch.bfloat16)
    want_h = ",".join(str(int(x)) for x in
                      Frame([t]).hash_keys(3).tolist())
    want_ids = ",".join(str(int(x)) for x in
                        frame_ops.hash_device_column(t, 3).remainder(4)
                        .tolist())
    assert out.stdout.split() == [want_h, want_ids]
