"""tests/test_sortio.py's twelve cases on the port.

The external sort, the spiller, the merge readers and the merge-reduce
of ``bigslice_tpu_torch/sortio.py`` and ``sliceio.py`` against the JAX
package's on the same seeded numpy inputs: each case runs both and
compares the rows (integer cells exact, float cells bit for bit where
the reference case is bit-exact, else within its tolerance), then
holds the port to the reference case's own assertions.

One divergence is by design and pinned here: the JAX package picks its
in-run sort by a knob (``BIGSLICE_DEVICE_SORT``, the TPU default, and a
``DEVICE_SORT_MIN_ROWS`` floor); the port has no such knob (the
tensor's device decides) and sorts every frame of scalar device
columns with its device sort, which orders rows exactly as the
reference's two sorts do (``test_sorted_by_key_dispatches_to_device``).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu import sliceio as ref_sliceio  # noqa: E402
from bigslice_tpu import sortio as ref_sortio  # noqa: E402
from bigslice_tpu.frame import frame as ref_frame  # noqa: E402
from bigslice_tpu.slicetype import Schema as RefSchema  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch import sliceio, slicetest, sortio  # noqa: E402
from bigslice_tpu_torch.frame import frame as port_frame  # noqa: E402
from bigslice_tpu_torch.slicetype import Schema  # noqa: E402

# (the package, its Frame, its obj_col, its Schema, sliceio, sortio)
PORT = (bst, port_frame.Frame, port_frame.obj_col, Schema, sliceio, sortio)
REF = (ref_bs, ref_frame.Frame, ref_frame.obj_col, RefSchema, ref_sliceio,
       ref_sortio)


def _py(v):
    """A cell as a plain Python value (numpy and 0-d tensors alike)."""
    if isinstance(v, torch.Tensor):
        v = v.numpy()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v.item() if hasattr(v, "item") else v


def _rows(frame_or_frames):
    frames = (frame_or_frames if isinstance(frame_or_frames, list)
              else [frame_or_frames])
    return [tuple(_py(c) for c in r) for f in frames for r in f.rows()]


def _frames_of(pkg, keys, vals, chunk=100):
    _, Frame, _, _, sio, _ = pkg
    return sio.frame_reader(Frame([keys, vals]), chunk)


def _both(case):
    """``case(pkg)`` for each package; its rows equal."""
    got, want = case(PORT), case(REF)
    assert got == want
    return got


def test_sort_reader_in_memory():
    """tests/test_sortio.py::test_sort_reader_in_memory."""
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 1000, 500).astype(np.int32)
    vals = np.arange(500, dtype=np.int32)

    def case(pkg):
        schema = pkg[3]([np.int32, np.int32])
        return _rows(pkg[4].read_all(
            pkg[5].sort_reader(_frames_of(pkg, keys, vals), schema), schema))

    got = _both(case)
    assert [k for k, _ in got] == sorted(keys.tolist())
    assert sorted(got) == sorted(zip(keys.tolist(), vals.tolist()))


def test_sort_reader_spills(tmp_path):
    """tests/test_sortio.py::test_sort_reader_spills: runs of 600 rows
    spilled to disk and merged back; the spill dirs go when the stream
    drains."""
    rng = np.random.RandomState(1)
    n = 5000
    keys = rng.randint(0, 100000, n).astype(np.int32)
    vals = rng.randint(0, 100, n).astype(np.int32)

    def case(pkg):
        schema = pkg[3]([np.int32, np.int32])
        d = tmp_path / pkg[0].__name__
        d.mkdir()
        out = _rows(pkg[4].read_all(pkg[5].sort_reader(
            _frames_of(pkg, keys, vals, chunk=500), schema, run_rows=600,
            spill_dir=str(d)), schema))
        assert not [x for x in os.listdir(d) if "spill" in x]
        return out

    before = sortio.SPILLED_ROWS
    got = _both(case)
    assert sortio.SPILLED_ROWS - before == n
    assert [k for k, _ in got] == sorted(keys.tolist())
    assert sorted(got) == sorted(zip(keys.tolist(), vals.tolist()))


def test_sort_reader_host_keys():
    """tests/test_sortio.py::test_sort_reader_host_keys."""
    words = ["pear", "apple", "fig", "apple", "date"]

    def case(pkg):
        _, Frame, obj_col, S, sio, sort = pkg
        schema = S([str, np.int32])
        f = Frame([obj_col(words), np.arange(5, dtype=np.int32)], schema)
        return _rows(sio.read_all(sort.sort_reader(iter([f]), schema),
                                  schema))

    assert [w for w, _ in _both(case)] == sorted(words)


def test_reduce_reader():
    """tests/test_sortio.py::test_reduce_reader."""
    def case(pkg):
        _, Frame, _, S, sio, sort = pkg
        schema = S([np.int32, np.int32])
        a = Frame([np.array([1, 2, 4], np.int32),
                   np.array([10, 20, 40], np.int32)])
        b = Frame([np.array([2, 3, 4], np.int32),
                   np.array([2, 3, 4], np.int32)])
        return _rows(sio.read_all(sort.reduce_reader(
            [iter([a]), iter([b])], schema, lambda x, y: x + y), schema))

    assert _both(case) == [(1, 10), (2, 22), (3, 3), (4, 44)]


def test_spiller_roundtrip(tmp_path):
    """tests/test_sortio.py::test_spiller_roundtrip: two runs spilled,
    read back as two streams of their rows."""
    def case(pkg):
        Frame, sort = pkg[1], pkg[5]
        d = tmp_path / pkg[0].__name__
        d.mkdir()
        sp = sort.Spiller(str(d))
        sp.spill(iter([Frame([np.arange(10, dtype=np.int32)])]))
        sp.spill(iter([Frame([np.arange(5, dtype=np.int32)])]))
        out = [_rows(list(r)) for r in sp.readers()]
        sp.cleanup()
        assert not os.path.exists(sp.dir)
        return out

    got = _both(case)
    assert [len(r) for r in got] == [10, 5]


def test_cogroup_large_spilling(monkeypatch):
    """tests/test_sortio.py::test_cogroup_large_spilling: a Cogroup over
    more rows than the run budget (512) sorts externally through the
    disk on the local executor; the grouped rows equal the JAX
    package's and the host oracle."""
    rng = np.random.RandomState(2)
    n = 4000
    keys = rng.randint(0, 50, n).astype(np.int32)
    vals = rng.randint(0, 10, n).astype(np.int32)
    spills = {}
    for name, mod in (("port", sortio), ("ref", ref_sortio)):
        monkeypatch.setattr(mod, "DEFAULT_RUN_ROWS", 512)
        orig = mod.Spiller.spill

        def counting(self, frames, orig=orig, name=name):
            spills[name] = spills.get(name, 0) + 1
            return orig(self, frames)

        monkeypatch.setattr(mod.Spiller, "spill", counting)
    got = slicetest.sorted_rows(
        bst.Cogroup(bst.Const(4, keys, vals)),
        session=bst.Session(executor=bst.LocalExecutor(device="cpu")))
    from bigslice_tpu import slicetest as ref_slicetest

    want = ref_slicetest.scan_all(ref_bs.Cogroup(ref_bs.Const(4, keys,
                                                              vals)))
    oracle = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        oracle.setdefault(k, []).append(v)
    assert len(got) == len(want) == len(oracle)
    assert ({int(k): sorted(_py(x) for x in g) for k, g in got}
            == {int(k): sorted(_py(x) for x in g) for k, g in want}
            == {k: sorted(v) for k, v in oracle.items()})
    assert spills.get("port") and spills.get("ref")


def test_device_run_sort_matches_lexsort(monkeypatch):
    """tests/test_sortio.py::test_device_run_sort_matches_lexsort: the
    port's device run sort, the host lexsort, and the JAX package's
    device sort (forced on) order a two-key frame alike (stable)."""
    from bigslice_tpu.parallel import sortkernel as ref_sortkernel

    from bigslice_tpu_torch.parallel import sortkernel

    monkeypatch.setenv("BIGSLICE_DEVICE_SORT", "1")
    rng = np.random.RandomState(3)
    n = ref_sortkernel.DEVICE_SORT_MIN_ROWS + 17
    k1 = rng.randint(0, 50, n).astype(np.int32)
    k2 = rng.randint(0, 7, n).astype(np.int32)
    v = np.arange(n, dtype=np.int32)
    f = port_frame.Frame([k1, k2, v], Schema([np.int32] * 3, prefix=2))
    assert sortkernel.device_sortable(f)
    dev = sortkernel.device_sorted_by_key(f)
    host = f.take(f.sort_indices())
    rf = ref_frame.Frame([k1, k2, v], RefSchema([np.int32] * 3, prefix=2))
    ref = ref_sortkernel.device_sorted_by_key(rf)
    for a, b, c in zip(dev.cols, host.cols, ref.cols):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_sorted_by_key_dispatches_to_device(monkeypatch):
    """tests/test_sortio.py::test_sorted_by_key_dispatches_to_device. By
    design the port has no ``BIGSLICE_DEVICE_SORT`` knob nor a size
    floor: every frame of scalar device columns takes its device sort,
    with or without the knob, and object keys stay on the host path, as
    in the JAX package; the order equals the JAX package's."""
    from bigslice_tpu.parallel import sortkernel as ref_sortkernel

    from bigslice_tpu_torch.parallel import sortkernel

    called = []
    orig = sortkernel.device_sorted_by_key
    monkeypatch.setattr(sortkernel, "device_sorted_by_key",
                        lambda fr: called.append(1) or orig(fr))
    n = ref_sortkernel.DEVICE_SORT_MIN_ROWS
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("BIGSLICE_DEVICE_SORT", raising=False)
        else:
            monkeypatch.setenv("BIGSLICE_DEVICE_SORT", env)
        called.clear()
        col = np.arange(n, dtype=np.int32)[::-1].copy()
        out = port_frame.Frame([col], Schema([np.int32],
                                             prefix=1)).sorted_by_key()
        assert called and out.cols[0].tolist() == list(range(n))
        ref = ref_frame.Frame([col], RefSchema([np.int32],
                                               prefix=1)).sorted_by_key()
        assert np.asarray(ref.cols[0]).tolist() == list(range(n))
    called.clear()
    g = port_frame.Frame([port_frame.obj_col([f"w{i}" for i in range(n)])],
                         Schema([str], prefix=1))
    g.sorted_by_key()
    assert not called


def _stream(pkg, schema, seed, total):
    """One sorted two-key stream in ragged frames (the reference
    case's ``make_stream``)."""
    Frame = pkg[1]
    r = np.random.RandomState(seed)
    k1 = np.sort(r.randint(0, 40, total)).astype(np.int32)
    k2 = r.randint(0, 3, total).astype(np.int32)
    order = np.lexsort((k2, k1))
    k1, k2 = k1[order], k2[order]
    v = np.arange(total, dtype=np.int32) + seed * 1000
    frames, i = [], 0
    while i < total:
        n = int(r.randint(1, 64))
        frames.append(Frame([k1[i:i + n], k2[i:i + n], v[i:i + n]],
                            schema))
        i += n
    return frames


def test_merge_reader_vector_matches_heap():
    """tests/test_sortio.py::test_merge_reader_vector_matches_heap: the
    watermark merge and the heap merge give the same (key, input,
    position) order, in both packages."""
    rng = np.random.RandomState(21)
    totals = [int(rng.randint(50, 400)) for _ in range(5)]

    def case(pkg):
        schema = pkg[3]([np.int32, np.int32, np.int32], prefix=2)
        sio = pkg[4]
        a = _rows([f for f in sio._merge_reader_vector(
            [iter(_stream(pkg, schema, s, t))
             for s, t in enumerate(totals)], schema)])
        b = _rows([f for f in sio._merge_reader_heap(
            [iter(_stream(pkg, schema, s, t))
             for s, t in enumerate(totals)], schema)])
        assert a == b
        return a

    got = _both(case)
    assert got == sorted(got, key=lambda r: (r[0], r[1]))


def test_merge_reader_dispatch(monkeypatch):
    """tests/test_sortio.py::test_merge_reader_dispatch: integer scalar
    keys take the watermark merge; float and object keys the heap."""
    calls = []
    orig = sliceio._merge_reader_vector
    monkeypatch.setattr(sliceio, "_merge_reader_vector",
                        lambda r, s: calls.append(1) or orig(r, s))
    Frame, obj_col = port_frame.Frame, port_frame.obj_col
    ischema = Schema([np.int32, np.int32], prefix=1)
    f = Frame([np.array([1, 2], np.int32), np.array([5, 6], np.int32)],
              ischema)
    got = list(sliceio.merge_reader([iter([f])], ischema))
    assert calls and sum(len(x) for x in got) == 2
    calls.clear()
    fschema = Schema([np.float32, np.int32], prefix=1)
    ff = Frame([np.array([1.0, np.nan], np.float32),
                np.array([5, 6], np.int32)], fschema)
    got = list(sliceio.merge_reader([iter([ff])], fschema))
    assert not calls and sum(len(x) for x in got) == 2
    calls.clear()
    oschema = Schema([str, np.int32], prefix=1)
    of = Frame([obj_col(["a", "b"]), np.array([5, 6], np.int32)], oschema)
    list(sliceio.merge_reader([iter([of])], oschema))
    assert not calls


def test_merge_reader_long_equal_run():
    """tests/test_sortio.py::test_merge_reader_long_equal_run: an equal
    key over 40 frames of one input merges in per-input position order,
    as the heap merges it, in both packages."""
    def mk(pkg, schema, vbase, nframes, rows=7, key=5):
        Frame = pkg[1]
        out = [Frame([np.full(rows, key, np.int32),
                      np.arange(rows, dtype=np.int32) + vbase + i * rows],
                     schema) for i in range(nframes)]
        out.append(Frame([np.array([9], np.int32),
                          np.array([vbase + 999], np.int32)], schema))
        return out

    def case(pkg):
        schema = pkg[3]([np.int32, np.int32], prefix=1)
        sio = pkg[4]
        rows = _rows([f for f in sio._merge_reader_vector(
            [iter(mk(pkg, schema, 0, 40)), iter(mk(pkg, schema, 10000, 3))],
            schema)])
        heap = _rows([f for f in sio._merge_reader_heap(
            [iter(mk(pkg, schema, 0, 40)), iter(mk(pkg, schema, 10000, 3))],
            schema)])
        assert rows == heap
        return rows

    _both(case)


def _reduce_streams(pkg, schema, seed, keyfn, valfn, nstreams=3):
    Frame, obj_col = pkg[1], pkg[2]
    rng = np.random.RandomState(seed)
    streams = []
    for _ in range(nstreams):
        total = int(rng.randint(30, 300))
        ks = sorted(keyfn(rng, total))
        frames, i = [], 0
        while i < total:
            n = int(rng.randint(1, 17))
            chunk = ks[i:i + n]
            kcol = (obj_col(chunk) if schema.cols[0].is_host
                    else np.asarray(chunk, schema.cols[0].dtype))
            frames.append(Frame([kcol, valfn(rng, len(chunk))], schema))
            i += n
        streams.append(frames)
    return streams


def test_reduce_reader_vector_matches_scalar():
    """tests/test_sortio.py::test_reduce_reader_vector_matches_scalar:
    classified fns take the reduceat path. int keys with a float32 add
    (equal to the JAX package's bit for bit: the same blocked sums; and
    within 1e-5 of a per-row fold) and str keys with an int max (exact
    against the host oracle)."""
    def case(pkg):
        schema = pkg[3]([np.int32, np.float32], prefix=1)
        streams = _reduce_streams(
            pkg, schema, 31, lambda r, n: r.randint(0, 25, n).tolist(),
            lambda r, n: r.randn(n).astype(np.float32))
        got = _rows([f for f in pkg[5].reduce_reader(
            [iter(list(s)) for s in streams], schema, lambda a, b: a + b)])
        seq, order = {}, []
        for f in pkg[4].merge_reader([iter(list(s)) for s in streams],
                                     schema):
            for k, v in f.rows():
                k, v = _py(k), _py(v)
                if k in seq:
                    seq[k] = np.float32(np.float32(seq[k]) + np.float32(v))
                else:
                    seq[k] = np.float32(v)
                    order.append(k)
        assert [k for k, _ in got] == order
        for k, v in got:
            np.testing.assert_allclose(v, seq[k], rtol=1e-5, atol=1e-5)
        sschema = pkg[3]([str, np.int32], prefix=1)
        sstreams = _reduce_streams(
            pkg, sschema, 32,
            lambda r, n: [f"w{int(x)}" for x in r.randint(0, 12, n)],
            lambda r, n: r.randint(-50, 50, n).astype(np.int32))
        mx = np.maximum if pkg is REF else torch.maximum
        got2 = dict(_rows([f for f in pkg[5].reduce_reader(
            [iter(list(s)) for s in sstreams], sschema,
            lambda a, b: mx(a, b))]))
        oracle2 = {}
        for s in sstreams:
            for f in s:
                for k, v in f.rows():
                    oracle2[k] = max(oracle2.get(k, -10**9), _py(v))
        assert got2 == oracle2
        return [(k, np.float32(v).view(np.int32).item()) for k, v in got], \
            got2

    _both(case)
