"""tests/test_fuzz.py's eight properties on the port.

Each property draws its data with hypothesis as the reference does,
builds it in both packages, and holds the port to the reference's
oracle and to the JAX package's own answer on the same data. The runs
are derandomized (a fixed example sequence, no example database), with
fewer examples than the reference's 25, so that the count of passes and
the time are the same from run to run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st  # noqa: E402

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.frame import codec as ref_codec  # noqa: E402
from bigslice_tpu.frame import frame as ref_frame  # noqa: E402
from bigslice_tpu import slicetype as ref_slicetype  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch import slicetest  # noqa: E402
from bigslice_tpu_torch.frame import codec  # noqa: E402
from bigslice_tpu_torch.frame import frame as port_frame  # noqa: E402
from bigslice_tpu_torch import slicetype  # noqa: E402

CHEAP = dict(max_examples=12, deadline=None, derandomize=True,
             database=None)
COSTLY = dict(max_examples=5, deadline=None, derandomize=True,
              database=None)


def _port_session():
    return bst.Session(executor=bst.MeshExecutor(device="cpu"))


def _ref_mesh_session(nshards):
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    mesh = Mesh(np.array(jax.devices()[:nshards]), ("shards",))
    return Session(executor=MeshExecutor(mesh))


# -- codec round-trips --------------------------------------------------


@st.composite
def frame_specs(draw):
    """(columns, column kinds, prefix): the reference's ``frames``
    strategy, as data either package can build a frame from."""
    n = draw(st.integers(min_value=0, max_value=200))
    ncols = draw(st.integers(min_value=1, max_value=4))
    cols, kinds = [], []
    for _ in range(ncols):
        kind = draw(st.sampled_from(["device", "vector", "str"]))
        if kind == "device":
            dt = draw(st.sampled_from([np.int32, np.uint32, np.float32,
                                       np.bool_]))
            if dt == np.bool_:
                col = draw(st.lists(st.booleans(), min_size=n, max_size=n))
            elif dt == np.float32:
                col = draw(st.lists(st.floats(allow_nan=False,
                                              allow_infinity=False,
                                              width=32),
                                    min_size=n, max_size=n))
            else:
                col = draw(st.lists(st.integers(min_value=0,
                                                max_value=2**31 - 1),
                                    min_size=n, max_size=n))
            cols.append(np.asarray(col, dt))
            kinds.append(("device", np.dtype(dt), ()))
        elif kind == "vector":
            w = draw(st.integers(min_value=1, max_value=4))
            cols.append(np.arange(n * w, dtype=np.float32).reshape(n, w))
            kinds.append(("vector", np.dtype(np.float32), (w,)))
        else:
            cols.append(draw(st.lists(st.text(max_size=12), min_size=n,
                                      max_size=n)))
            kinds.append(("str", None, ()))
    prefix = draw(st.integers(min_value=0, max_value=ncols))
    return cols, kinds, prefix


def _build(spec, frame_mod, st_mod):
    cols, kinds, prefix = spec
    out, types = [], []
    for c, (kind, dt, shape) in zip(cols, kinds):
        if kind == "str":
            out.append(frame_mod.obj_col(list(c)))
            types.append(st_mod.ColType(np.dtype(object), tag="str"))
        else:
            out.append(c)
            types.append(st_mod.ColType(dt, shape=shape))
    return frame_mod.Frame(out, st_mod.Schema(types, prefix=prefix))


def _same_frame(got, want_cols, kinds):
    assert len(got) == len(want_cols[0])
    for a, b, (kind, _, _) in zip(got.cols, want_cols, kinds):
        if kind == "str":
            assert list(a) == list(b)
        else:
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            np.testing.assert_array_equal(a, np.asarray(b))


@given(frame_specs())
@settings(**CHEAP)
def test_codec_roundtrip(spec):
    """tests/test_fuzz.py::test_codec_roundtrip: the port's encoding
    decodes to the frame in the port and in the JAX package."""
    frame = _build(spec, port_frame, slicetype)
    data = codec.encode_frame(frame)
    out = list(codec.read_frames(data))
    assert len(out) == 1
    _same_frame(out[0], spec[0], spec[1])
    ref_out = list(ref_codec.read_frames(data))
    assert len(ref_out) == 1
    _same_frame(ref_out[0], spec[0], spec[1])


@given(frame_specs())
@settings(**CHEAP)
def test_codec_detects_corruption(spec):
    """tests/test_fuzz.py::test_codec_detects_corruption: one flipped
    body byte never decodes cleanly, in either package."""
    frame = _build(spec, port_frame, slicetype)
    if not len(frame):
        return
    data = bytearray(codec.encode_frame(frame))
    if len(data) <= 17:
        return
    data[17] ^= 0xFF
    for reader in (codec.read_frames, ref_codec.read_frames):
        with pytest.raises(Exception):
            list(reader(bytes(data)))


# -- oracle equivalence over random shardings ---------------------------


@given(st.lists(st.integers(min_value=-1000, max_value=1000), min_size=1,
                max_size=300),
       st.integers(min_value=1, max_value=9))
@settings(**CHEAP)
def test_intmax_matches_oracle(values, num_shards):
    """tests/test_fuzz.py::test_intmax_matches_oracle."""
    import jax.numpy as jnp

    from bigslice_tpu import slicetest as ref_slicetest

    arr = np.asarray(values, np.int32)
    keys = (np.abs(arr) % 5).astype(np.int32)
    got = dict(slicetest.run(
        bst.Reduce(bst.Const(num_shards, keys, arr),
                   lambda a, b: torch.maximum(a, b)),
        session=_port_session()).rows())
    oracle = {}
    for k, v in zip(keys.tolist(), arr.tolist()):
        oracle[k] = max(oracle.get(k, -(2**31)), v)
    assert got == oracle
    assert got == dict(ref_slicetest.run(ref_bs.Reduce(
        ref_bs.Const(num_shards, keys, arr),
        lambda a, b: jnp.maximum(a, b))).rows())


@given(st.integers(min_value=0, max_value=400),
       st.integers(min_value=1, max_value=8),
       st.integers(min_value=1, max_value=50))
@settings(**CHEAP)
def test_partition_conservation(n, nparts, nkeys):
    """tests/test_fuzz.py::test_partition_conservation: every row in one
    in-range partition, deterministic, and the JAX package's."""
    rng = np.random.RandomState(n * 31 + nparts)
    keys = rng.randint(0, nkeys, n).astype(np.int32)
    f = port_frame.Frame([keys], slicetype.Schema([np.int32], prefix=1))
    ids = f.partition_ids(nparts)
    assert tuple(ids.shape) == (n,)
    if n:
        assert int(ids.min()) >= 0 and int(ids.max()) < nparts
    np.testing.assert_array_equal(ids.numpy(), f.partition_ids(nparts))
    rf = ref_frame.Frame([keys], ref_slicetype.Schema([np.int32], prefix=1))
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(rf.partition_ids(nparts)))


# -- dense lowering vs oracle ------------------------------------------


@given(n=st.integers(min_value=1, max_value=600),
       K=st.integers(min_value=1, max_value=300),
       nshards=st.sampled_from([1, 3, 8]),
       op=st.sampled_from(["add", "max", "min"]),
       seed=st.integers(min_value=0, max_value=2**16))
@settings(**COSTLY)
def test_dense_reduce_matches_oracle_quickcheck(n, K, nshards, op, seed):
    """tests/test_fuzz.py::test_dense_reduce_matches_oracle_quickcheck:
    the declared dense table, shard for shard as the JAX package's."""
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    keys = rng.randint(0, K, n).astype(np.int32)
    vals = rng.randint(-1000, 1000, n).astype(np.int32)

    def fn(mod):
        return {"add": lambda a, b: a + b,
                "max": lambda a, b: mod.maximum(a, b),
                "min": lambda a, b: mod.minimum(a, b)}[op]

    red = {"add": np.sum, "max": np.max, "min": np.min}[op]
    want = {int(k): int(red(vals[keys == k])) for k in np.unique(keys)}
    r = bst.Reduce(bst.Const(nshards, keys, vals), fn(torch), dense_keys=K)
    assert r.frame_combiner.dense_keys == K
    res = _port_session().run(r)
    assert dict(res.rows()) == want
    ref = _ref_mesh_session(nshards).run(ref_bs.Reduce(
        ref_bs.Const(nshards, keys, vals), fn(jnp), dense_keys=K))
    got, exp = bst.result_shard_rows(res), bst.result_shard_rows(ref)
    for g, w in zip(got, exp):
        for gc, wc in zip(g, w):
            np.testing.assert_array_equal(gc, wc)


# -- device cogroup vs oracle ------------------------------------------


@given(n=st.integers(min_value=1, max_value=500),
       K=st.integers(min_value=1, max_value=200),
       nshards=st.sampled_from([1, 3, 8]),
       seed=st.integers(min_value=0, max_value=2**16),
       two_sided=st.booleans())
@settings(**COSTLY)
def test_device_cogroup_matches_oracle_quickcheck(n, K, nshards, seed,
                                                  two_sided):
    """tests/test_fuzz.py::test_device_cogroup_matches_oracle_quickcheck:
    no group member dropped or truncated, lists as the JAX package's."""
    rng = np.random.RandomState(seed)
    inputs = [(rng.randint(0, K, n).astype(np.int32),
               rng.randint(-999, 999, n).astype(np.int32))]
    if two_sided:
        m = max(1, n // 2)
        inputs.append((rng.randint(0, K, m).astype(np.int32),
                       rng.randint(-999, 999, m).astype(np.int32)))
    oracles = []
    for k, v in inputs:
        o = {}
        for kk, vv in zip(k.tolist(), v.tolist()):
            o.setdefault(kk, []).append(vv)
        oracles.append(o)
    rows = list(_port_session().run(bst.Cogroup(
        *[bst.Const(nshards, k, v) for k, v in inputs])).rows())
    assert {int(r[0]) for r in rows} == set().union(*map(set, oracles))
    for r in rows:
        for j, o in enumerate(oracles):
            assert sorted(int(x) for x in r[1 + j]) == sorted(
                o.get(int(r[0]), []))
    ref_rows = list(_ref_mesh_session(nshards).run(ref_bs.Cogroup(
        *[ref_bs.Const(nshards, k, v) for k, v in inputs])).rows())

    def canon(rs):
        return sorted((int(r[0]),) + tuple(
            tuple(sorted(int(x) for x in c)) for c in r[1:]) for r in rs)

    assert canon(rows) == canon(ref_rows)


# -- slice attention vs oracle -----------------------------------------


@given(seq=st.integers(min_value=1, max_value=96),
       heads=st.sampled_from([1, 2, 4, 8]),
       causal=st.booleans(),
       nshards=st.sampled_from([1, 4, 8]),
       seed=st.integers(min_value=0, max_value=2**16))
@settings(**COSTLY)
def test_selfattend_matches_oracle_quickcheck(seq, heads, causal, nshards,
                                              seed):
    """tests/test_fuzz.py::test_selfattend_matches_oracle_quickcheck:
    against the JAX package's dense reference at its 5e-4."""
    from bigslice_tpu.parallel.ulysses import dense_mha_reference

    dh = 4
    rng = np.random.RandomState(seed)
    q3, k3, v3 = (rng.randn(seq, heads, dh).astype(np.float32) * 0.3
                  for _ in range(3))
    flat = [x.reshape(seq, heads * dh) for x in (q3, k3, v3)]
    ref = np.asarray(dense_mha_reference(q3, k3, v3, causal=causal)
                     ).reshape(seq, heads * dh)
    att = bst.SelfAttend(bst.Const(nshards, *flat), causal=causal,
                         heads=heads)
    # Rows in sequence order: shard by shard, each in its order.
    out = np.stack([np.asarray(o)
                    for (o,) in _port_session().run(att).rows()])
    np.testing.assert_allclose(out, ref, rtol=5e-4, atol=5e-4)


# -- k-way merge oracle -------------------------------------------------


@st.composite
def sorted_streams(draw):
    """The reference's collision-heavy sorted streams, as (keys, vals,
    frame lengths) a stream."""
    streams = []
    for s in range(draw(st.integers(min_value=1, max_value=5))):
        total = draw(st.integers(min_value=0, max_value=120))
        keys = np.sort(np.asarray(draw(st.lists(
            st.integers(min_value=-3, max_value=6), min_size=total,
            max_size=total)), np.int32))
        vals = np.arange(total, dtype=np.int32) + s * 1000
        sizes, i = [], 0
        while i < total:
            n = draw(st.integers(min_value=1, max_value=9))
            sizes.append(n)
            i += n
        streams.append((keys, vals, sizes))
    return streams


def _frames(frame_mod, schema, keys, vals, sizes):
    out, i = [], 0
    for n in sizes:
        out.append(frame_mod.Frame([keys[i:i + n], vals[i:i + n]], schema))
        i += n
    return out


@given(sorted_streams())
@settings(**CHEAP)
def test_fuzz_merge_vector_matches_heap(streams):
    """tests/test_fuzz.py::test_fuzz_merge_vector_matches_heap: the
    watermark merge equals the heap merge, and the JAX package's."""
    from bigslice_tpu import sliceio as ref_sliceio

    from bigslice_tpu_torch import sliceio

    out = []
    for sio, fm, sm in ((sliceio, port_frame, slicetype),
                        (ref_sliceio, ref_frame, ref_slicetype)):
        schema = sm.Schema([np.int32, np.int32], prefix=1)
        for merge in (sio._merge_reader_vector, sio._merge_reader_heap):
            rows = [r for f in merge(
                [iter(_frames(fm, schema, *s)) for s in streams], schema)
                for r in f.rows()]
            out.append([tuple(int(x) for x in r) for r in rows])
    assert out[0] == out[1] == out[2] == out[3]
