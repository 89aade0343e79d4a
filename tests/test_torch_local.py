"""The port's local executor and host tier against the JAX package's.

Every test feeds the same seeded numpy inputs through the JAX package's
``Session()`` (its ``LocalExecutor``, on the CPU) and the port's
``Session(executor=LocalExecutor(device="cpu"))``, and compares each
output shard's rows (``result_shard_rows``): ints and strings exactly,
float sums within ``rtol=1e-6``. The same routing hash sends every key
to the same shard in both packages, so shards compare one by one.
"""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.exec.local import LocalExecutor as RefLocal  # noqa: E402
from bigslice_tpu.exec.session import Session as RefSession  # noqa: E402
from bigslice_tpu.exec.store import FileStore as RefFileStore  # noqa: E402
from bigslice_tpu.models import wordcount as ref_wordcount  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.exec import local as port_local  # noqa: E402
from bigslice_tpu_torch.exec.store import FileStore  # noqa: E402
from bigslice_tpu_torch.models import wordcount as port_wordcount  # noqa: E402

FLOAT_RTOL = 1e-6


def _port_session(**kw):
    return bst.Session(executor=bst.LocalExecutor(device="cpu", **kw))


def _cell(v):
    """A comparable Python value of one cell (lists of numpy scalars
    and vector cells as lists of Python numbers)."""
    if isinstance(v, (list, tuple, np.ndarray)):
        return [_cell(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def _canon(shard):
    """A shard's rows as sorted tuples of Python values (host cells such
    as strings and lists take part in the order)."""
    rows = [tuple(_cell(c[i]) for c in shard) for i in range(len(shard[0]))]
    return sorted(rows, key=repr)


def assert_same_shards(got, want, float_cols=()):
    """Per shard: the same dtypes and rows; ``float_cols`` within
    ``FLOAT_RTOL``, every other column exactly."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [c.dtype for c in g] == [c.dtype for c in w]
        gr, wr = _canon(g), _canon(w)
        assert len(gr) == len(wr)
        if not float_cols:
            assert gr == wr
            continue
        exact = [j for j in range(len(g)) if j not in float_cols]
        key = lambda r: repr([r[j] for j in exact])  # noqa: E731
        gr, wr = sorted(gr, key=key), sorted(wr, key=key)
        for a, b in zip(gr, wr):
            assert [a[j] for j in exact] == [b[j] for j in exact]
            for j in float_cols:
                np.testing.assert_allclose(a[j], b[j], rtol=FLOAT_RTOL)


def _run_both(ref_slice, port_slice, ref_sess=None, port_sess=None,
              float_cols=()):
    want = bst.result_shard_rows((ref_sess or RefSession()).run(ref_slice))
    got = bst.result_shard_rows((port_sess or _port_session()).run(
        port_slice))
    assert_same_shards(got, want, float_cols)
    return got


def _keys(n, seed, span=300):
    return np.random.RandomState(seed).randint(-50, span, n).astype(np.int32)


def _both(make):
    """``make(pkg)`` builds the same slice in either package."""
    return make(ref_bs), make(bst)


# -- the row-wise combinators ----------------------------------------------


@pytest.mark.parametrize("tier", ["device", "host"])
def test_map(tier):
    k = _keys(3000, 1)
    v = np.arange(3000, dtype=np.int32)
    if tier == "device":
        def make(bs):
            return bs.Map(bs.Const(4, k, v), lambda a, b: (a * 2, b + a))
    else:
        def make(bs):
            return bs.Map(bs.Const(4, k, v),
                          lambda a, b: (int(a) % 17, f"{b}"),
                          out=[np.int32, str])
    r, p = _both(make)
    assert p.mode == tier
    _run_both(r, p)


@pytest.mark.parametrize("tier", ["device", "host"])
def test_filter(tier):
    k = _keys(3000, 2)
    if tier == "device":
        def make(bs):
            return bs.Filter(bs.Const(3, k, k), lambda a, b: a % 3 == 0)
    else:
        def make(bs):
            return bs.Filter(bs.Const(3, k, k), lambda a, b: bool(a % 3))
    r, p = _both(make)
    assert p.mode == tier
    _run_both(r, p)


def test_flatmap_host():
    lines = [" ".join(f"w{j}" for j in range(i % 5)) for i in range(500)]

    def make(bs):
        return bs.Flatmap(bs.Const(3, np.array(lines, dtype=object)),
                          lambda l: [(w, len(w)) for w in l.split()],
                          out=[str, np.int32])

    _run_both(*_both(make))


def test_flatmap_fixed_fanout_feeds_reduce():
    import jax.numpy as jnp

    k = _keys(2000, 3, 50)
    v = np.ones(2000, np.int32)

    def dup(xp):
        def fn(a, b):
            mask = xp.stack([a >= a, a % 2 == 0])
            return mask, xp.stack([a, a + 1]), xp.stack([b, b * 2])
        return fn

    r = ref_bs.Reduce(ref_bs.Flatmap(ref_bs.Const(3, k, v), dup(jnp),
                                     out=[np.int32, np.int32], fanout=2),
                      lambda a, b: a + b)
    p = bst.Reduce(bst.Flatmap(bst.Const(3, k, v), dup(torch),
                               out=[np.int32, np.int32], fanout=2),
                   lambda a, b: a + b)
    _run_both(r, p)


def test_head():
    k = np.arange(1000, dtype=np.int32)

    def make(bs):
        return bs.Head(bs.Map(bs.Const(4, k, k), lambda a, b: (b, a + 1)),
                       37)

    got = _run_both(*_both(make))
    assert [len(s[0]) for s in got] == [37] * 4


# -- Reduce ---------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 4])
def test_reduce_device_keys(S):
    k = _keys(5000, S)
    v = np.random.RandomState(S).randint(-9, 9, 5000).astype(np.int32)

    def make(bs):
        return bs.Reduce(bs.Const(S, k, v), lambda a, b: a + b)

    _run_both(*_both(make))


def test_reduce_float_sums():
    k = _keys(6000, 7, 100)
    f = np.random.RandomState(7).randn(6000).astype(np.float32)

    def make(bs):
        return bs.Reduce(bs.Const(4, k, f), lambda a, b: a + b)

    _run_both(*_both(make), float_cols=(1,))


def test_reduce_two_values_max_min():
    k = _keys(4000, 8)
    rng = np.random.RandomState(8)
    a = rng.randn(4000).astype(np.float32)
    b = rng.randint(-1000, 1000, 4000).astype(np.int32)
    import jax.numpy as jnp

    r = ref_bs.Reduce(ref_bs.Const(4, k, a, b),
                      lambda x, y: (jnp.maximum(x[0], y[0]),
                                    jnp.minimum(x[1], y[1])))
    p = bst.Reduce(bst.Const(4, k, a, b),
                   lambda x, y: (torch.maximum(x[0], y[0]),
                                 torch.minimum(x[1], y[1])))
    _run_both(r, p)


def test_reduce_str_keys():
    words = np.array([f"k{i % 97}" for i in range(3000)], dtype=object)
    v = np.arange(3000, dtype=np.int32)

    def make(bs):
        return bs.Reduce(bs.Const(4, words, v), lambda a, b: a + b)

    _run_both(*_both(make))


def test_reduce_non_tensor_combine_fn():
    """A combine fn the meta trace cannot run (Python's max) is host
    tier in the port, as it is in the JAX package."""
    k = _keys(3000, 9, 60)
    v = np.random.RandomState(9).randint(0, 10**6, 3000).astype(np.int32)

    def make(bs):
        return bs.Reduce(bs.Const(3, k, v), lambda a, b: max(a, b))

    r, p = _both(make)
    assert not p.frame_combiner.device
    _run_both(r, p)


def test_reduce_incremental_precombine(monkeypatch):
    import bigslice_tpu.exec.local as ref_local

    monkeypatch.setattr(ref_local, "COMBINE_FLUSH_ROWS", 64)
    monkeypatch.setattr(port_local, "COMBINE_FLUSH_ROWS", 64)
    k = _keys(4000, 10, 40)

    def make(bs):
        return bs.Reduce(bs.Const(2, k, np.ones(4000, np.int32)),
                         lambda a, b: a + b)

    _run_both(*_both(make))


def test_mixed_host_map_feeds_device_reduce():
    k = _keys(4000, 11)

    def make(bs):
        m = bs.Map(bs.Const(4, k, k), lambda a, b: (int(a) % 23, 1),
                   out=[np.int32, np.int32])
        return bs.Reduce(m, lambda a, b: a + b)

    r, p = _both(make)
    assert p.dep_slice.mode == "host" and p.frame_combiner.device
    _run_both(r, p)


# -- shuffles -------------------------------------------------------------


def test_reshuffle():
    k = _keys(3000, 12)

    def make(bs):
        return bs.Reshuffle(bs.Const(4, k, np.arange(3000, dtype=np.int32)))

    _run_both(*_both(make))


def test_repartition_row_fn():
    k = np.arange(2000, dtype=np.int32)

    def make(bs):
        return bs.Repartition(bs.Const(3, k, k), lambda a, n: a % n)

    _run_both(*_both(make))


def test_repartition_frame_fn():
    k = np.arange(2000, dtype=np.int32)

    def part(frame, nparts):
        return ((np.asarray(frame.cols[0]) // 7) % nparts).astype(np.int32)

    def make(bs):
        return bs.Repartition(bs.Const(3, k, k), part)

    got = _run_both(*_both(make))
    assert all(np.all((s[0] // 7) % 3 == i) for i, s in enumerate(got))


def test_partition_frame_keeps_input_order():
    from bigslice_tpu_torch.frame.frame import Frame

    ids = torch.tensor([2, 0, 1, 0, 2, 2, 1, 0], dtype=torch.int32)
    f = Frame([torch.arange(8, dtype=torch.int32),
               np.array(list("abcdefgh"), dtype=object)])
    parts = port_local.partition_frame(f, ids, 3)
    assert [p.cols[0].tolist() for p in parts] == [[1, 3, 7], [2, 6],
                                                  [0, 4, 5]]
    assert [list(p.cols[1]) for p in parts] == [list("bdh"), list("cg"),
                                                list("aef")]
    with pytest.raises(ValueError, match="outside"):
        port_local.partition_frame(f, ids + 1, 3)


@pytest.mark.parametrize("kind", ["str", "mixed"])
def test_host_key_routing_equals_the_reference(kind):
    """Host and mixed keys hash on the host (the stable CRC) and route
    to the JAX package's partitions."""
    from bigslice_tpu.frame.frame import Frame as RefFrame
    from bigslice_tpu_torch.frame.frame import Frame

    words = np.array([f"w{i}" for i in range(500)], dtype=object)
    ints = np.arange(500, dtype=np.int32) * 7
    cols = [words] if kind == "str" else [ints, words]
    want = np.asarray(RefFrame(cols, prefix=len(cols)).partition_ids(13))
    got = Frame(cols, prefix=len(cols)).partition_ids(13)
    np.testing.assert_array_equal(got.numpy(), want)


# -- joins and groupings ----------------------------------------------------


def test_join_aggregate():
    ak, bk = _keys(3000, 13, 400), _keys(2000, 14, 400)
    av = np.ones(3000, np.int32)
    bv = np.random.RandomState(14).randint(0, 99, 2000).astype(np.int32)

    def make(bs):
        return bs.JoinAggregate(bs.Const(4, ak, av), bs.Const(3, bk, bv),
                                lambda a, b: a + b, lambda a, b: a ^ b)

    _run_both(*_both(make))


def test_join_aggregate_str_keys():
    ak = np.array([f"k{i % 50}" for i in range(600)], dtype=object)
    bk = np.array([f"k{i % 70}" for i in range(500)], dtype=object)

    def make(bs):
        return bs.JoinAggregate(
            bs.Const(2, ak, np.ones(600, np.int32)),
            bs.Const(3, bk, np.arange(500, dtype=np.int32)),
            lambda a, b: a + b, lambda a, b: a + b)

    _run_both(*_both(make))


def test_group_by_key():
    k = _keys(3000, 15, 200)
    v = np.arange(3000, dtype=np.int32)

    def make(bs):
        return bs.GroupByKey(bs.Const(4, k, v), capacity=16)

    _run_both(*_both(make))


def test_group_by_key_strict_overflow_raises():
    from bigslice_tpu_torch.exec.task import TaskError

    k = np.zeros(40, np.int32)
    with pytest.raises(TaskError) as ei:
        _port_session().run(bst.GroupByKey(bst.Const(2, k, k), 8,
                                           on_overflow="error"))
    assert isinstance(ei.value.cause, ValueError)


@pytest.mark.parametrize("keys", ["int", "str"])
def test_cogroup(keys):
    a = _keys(1500, 16, 120)
    b = _keys(900, 17, 120)
    if keys == "str":
        a = np.array([f"k{x}" for x in a], dtype=object)
        b = np.array([f"k{x}" for x in b], dtype=object)
    av = np.arange(1500, dtype=np.int32)
    bv = np.random.RandomState(17).randn(900).astype(np.float32)

    def make(bs):
        return bs.Cogroup(bs.Const(3, a, av), bs.Const(4, b, bv))

    _run_both(*_both(make))


def test_cogroup_sorts_runs_through_spill(monkeypatch):
    """Each input's partition sorted on bounded memory: runs spilled
    and merged back (``sortio.sort_reader``)."""
    from bigslice_tpu_torch import sortio

    monkeypatch.setattr(sortio, "DEFAULT_RUN_ROWS", 64)
    before = sortio.SPILLED_ROWS
    a = _keys(1500, 18, 90)

    def make(bs):
        return bs.Cogroup(bs.Const(2, a, np.arange(1500, dtype=np.int32)))

    _run_both(*_both(make))
    assert sortio.SPILLED_ROWS > before


# -- sources and sinks ----------------------------------------------------


def test_scan_reader(tmp_path):
    p = tmp_path / "lines.txt"
    p.write_text("".join(f"line {i}\r\n" if i % 3 else f"line {i}\n"
                         for i in range(300)))

    def make(bs):
        return bs.ScanReader(4, str(p))

    _run_both(*_both(make))


def test_reader_func_and_writer_func():
    def gen(shard):
        yield ([shard * 10 + 1, shard * 10 + 2],
               [f"s{shard}", f"t{shard}"])
        yield ([shard * 10 + 3], [f"u{shard}"])

    written = {"ref": [], "port": []}

    def writer(tag):
        def write(shard, frame):
            written[tag].extend(frame.rows())
        return write

    r = ref_bs.WriterFunc(ref_bs.ReaderFunc(3, gen, out=[np.int32, str]),
                          writer("ref"))
    p = bst.WriterFunc(bst.ReaderFunc(3, gen, out=[np.int32, str]),
                       writer("port"))
    _run_both(r, p)
    assert sorted(written["port"]) == sorted(written["ref"])
    assert len(written["port"]) == 9


def test_wordcount(tmp_path):
    rng = np.random.RandomState(19)
    vocab = [f"w{i}" for i in range(400)]
    path = tmp_path / "corpus.txt"
    path.write_text("".join(
        " ".join(vocab[j % 400] for j in rng.zipf(1.2, 8)) + "\n"
        for _ in range(3000)))
    got = _run_both(ref_wordcount.wordcount(3, str(path)),
                    port_wordcount.wordcount(3, str(path)))
    assert sum(len(s[0]) for s in got) > 100


@pytest.mark.parametrize("path", ["wordcount", "device_reduce",
                                  "host_map_device_reduce"])
def test_frames_move_only_before_device_consumers(tmp_path, path):
    """The task body places a frame on the executor's device only where
    a device stage, combine, group or router reads it: a host chain
    (wordcount) never places a frame; a device Reduce places its
    producers' outputs (the router) and its inputs (the combine)."""
    if path == "wordcount":
        corpus = tmp_path / "corpus.txt"
        corpus.write_text("a b c a\nb a d\n" * 50)
        s = port_wordcount.wordcount(2, str(corpus))
    else:
        k = _keys(2000, 23)
        src = bst.Const(2, k, k)
        if path == "host_map_device_reduce":
            src = bst.Map(src, lambda a, b: (int(a) % 7, 1),
                          out=[np.int32, np.int32])
        s = bst.Reduce(src, lambda a, b: a + b)
    ex = bst.LocalExecutor(device="cpu")
    placed = []
    real = ex._place

    def counting_place(frame):
        placed.append(len(frame))
        return real(frame)

    ex._place = counting_place
    rows = bst.Session(executor=ex).run(s).rows()
    assert rows
    if path == "wordcount":
        assert placed == []
    else:
        # Each producer's output meets the device router, and each
        # reduce shard's input the device combine.
        assert len(placed) >= 4


def test_wordcount_ids():
    ids = np.random.RandomState(20).randint(0, 1 << 10, 20000)
    _run_both(ref_wordcount.wordcount_ids(4, ids, 1 << 10),
              port_wordcount.wordcount_ids(4, ids, 1 << 10))


# -- sessions, stores and machine combiners -------------------------------


def test_result_reuse():
    calls = {"ref": 0, "port": 0}

    def gen(tag):
        def fn(shard):
            calls[tag] += 1
            yield ([shard, shard + 10, shard + 7],)
        return fn

    def reuse(bs, sess, tag):
        res1 = sess.run(bs.ReaderFunc(3, gen(tag), out=[np.int32]))
        res2 = sess.run(bs.Map(res1, lambda x: x * 2))
        res3 = sess.run(bs.Reduce(bs.Map(res1, lambda x: (x % 2, x)),
                                  lambda a, b: a + b))
        # A shuffle straight off a Result: _shuffle adapter tasks.
        kv = sess.run(bs.Map(res1, lambda x: (x % 3, x + 1)))
        res4 = sess.run(bs.Reduce(kv, lambda a, b: a + b))
        res5 = sess.run(bs.Reshuffle(kv))
        return [bst.result_shard_rows(r)
                for r in (res1, res2, res3, res4, res5)]

    want = reuse(ref_bs, RefSession(), "ref")
    got = reuse(bst, _port_session(), "port")
    for g, w in zip(got, want):
        assert_same_shards(g, w)
    assert calls["port"] == calls["ref"] == 3  # the source ran once


@pytest.mark.parametrize("host_keys", [False, True])
def test_machine_combiners(host_keys):
    k = _keys(1200, 21, 30)
    if host_keys:
        k = np.array([f"k{x}" for x in k], dtype=object)
    v = np.random.RandomState(21).randint(0, 5, 1200).astype(np.int32)

    def make(bs):
        return bs.Reduce(bs.Const(6, k, v), lambda a, b: a + b)

    port = bst.Session(executor=bst.LocalExecutor(device="cpu"),
                       machine_combiners=True)
    r, p = _both(make)
    _run_both(r, p, ref_sess=RefSession(machine_combiners=True),
              port_sess=port)
    assert port.executor._mc_committed


def test_machine_combiners_discard_recovers():
    k = np.arange(120, dtype=np.int32) % 7
    sess = bst.Session(executor=bst.LocalExecutor(device="cpu"),
                       machine_combiners=True)
    res = sess.run(bst.Reduce(bst.Const(6, k, np.ones(120, np.int32)),
                              lambda a, b: a + b))
    first = dict(res.rows())
    res.discard()
    assert dict(res.rows()) == first == {i: len(k[k == i]) for i in range(7)}


def test_filestore_backed_executor(tmp_path):
    k = _keys(2000, 22, 40)

    def make(bs):
        return bs.Reduce(bs.Const(4, k, np.ones(2000, np.int32)),
                         lambda a, b: a + b)

    r, p = _both(make)
    ref = RefSession(executor=RefLocal(
        procs=2, store=RefFileStore(str(tmp_path / "ref"))))
    port = bst.Session(executor=bst.LocalExecutor(
        procs=2, store=FileStore(str(tmp_path / "port")), device="cpu"))
    _run_both(r, p, ref_sess=ref, port_sess=port)
    assert glob.glob(str(tmp_path / "port" / "**" / "p*"), recursive=True)


def test_shuffle_spill_through_a_streaming_store(monkeypatch, tmp_path):
    import tempfile

    import bigslice_tpu.exec.local as ref_local
    from bigslice_tpu_torch import sortio

    monkeypatch.setattr(ref_local, "SHUFFLE_SPILL_ROWS", 256)
    monkeypatch.setattr(port_local, "SHUFFLE_SPILL_ROWS", 256)
    # Spill directories go under this test's own temp dir.
    spill_root = tmp_path / "spill"
    spill_root.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(spill_root))
    before = sortio.SPILLED_ROWS
    k = np.arange(5000, dtype=np.int32)

    def make(bs):
        return bs.Reshuffle(bs.Const(2, k, k * 3))

    r, p = _both(make)
    ref = RefSession(executor=RefLocal(
        store=RefFileStore(str(tmp_path / "ref"))))
    port = bst.Session(executor=bst.LocalExecutor(
        store=FileStore(str(tmp_path / "port")), device="cpu"))
    _run_both(r, p, ref_sess=ref, port_sess=port)
    assert sortio.SPILLED_ROWS > before
    # Every spill directory went with its task.
    assert not [d for d in os.listdir(spill_root)
                if d.startswith("bigslice-torch-spill-")]


@pytest.mark.parametrize("procs", [1, 8])
def test_procs(procs):
    k = _keys(8000, 23, 500)

    def make(bs):
        return bs.Reduce(bs.Map(bs.Const(8, k, k), lambda a, b: (a, b & 7)),
                         lambda a, b: a + b)

    _run_both(*_both(make), port_sess=_port_session(procs=procs))


def test_session_options():
    seen = []
    sess = bst.Session(executor=bst.LocalExecutor(device="cpu"),
                       monitor=lambda t, s: seen.append(s.name))
    sess.run(bst.Const(2, np.arange(4, dtype=np.int32)))
    assert "RUNNING" in seen and "OK" in seen
    assert isinstance(sess.executor, bst.LocalExecutor)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bst.Session(parallelism=3)


# -- the host half of sliceio and segment ---------------------------------


def test_merge_reader_heap_over_str_and_float_keys():
    from bigslice_tpu import sliceio as ref_sliceio
    from bigslice_tpu.frame.frame import Frame as RefFrame
    from bigslice_tpu_torch import sliceio
    from bigslice_tpu_torch.frame.frame import Frame

    rng = np.random.RandomState(25)
    for kind in ("str", "float"):
        runs = []
        for _ in range(3):
            k = np.sort(rng.randint(0, 60, 40))
            k = (np.array([f"k{x:03d}" for x in k], dtype=object)
                 if kind == "str" else k.astype(np.float32) / 4)
            runs.append((k, rng.randint(0, 9, 40).astype(np.int32)))

        def streams(F):
            return [iter([F([k[:15], v[:15]]), F([k[15:], v[15:]])])
                    for k, v in runs]

        got = sliceio.merge_reader(streams(Frame), Frame(list(runs[0])).schema)
        want = ref_sliceio.merge_reader(streams(RefFrame),
                                        RefFrame(list(runs[0])).schema)
        assert ([r for f in got for r in f.rows()]
                == [r for f in want for r in f.rows()])


def test_merge_reader_and_reduce_reader():
    from bigslice_tpu import sliceio as ref_sliceio
    from bigslice_tpu import sortio as ref_sortio
    from bigslice_tpu.frame.frame import Frame as RefFrame
    from bigslice_tpu_torch import sliceio, sortio
    from bigslice_tpu_torch.frame.frame import Frame

    rng = np.random.RandomState(24)
    runs = []
    for _ in range(4):
        k = np.unique(rng.randint(0, 300, 200)).astype(np.int32)
        runs.append((k, rng.randint(0, 9, len(k)).astype(np.int32)))
    schema = Frame(list(runs[0])).schema
    rschema = RefFrame(list(runs[0])).schema

    def streams(F):
        return [iter([F([k[:50], v[:50]]), F([k[50:], v[50:]])])
                for k, v in runs]

    for got, want in (
        (sliceio.merge_reader(streams(Frame), schema),
         ref_sliceio.merge_reader(streams(RefFrame), rschema)),
        (sortio.reduce_reader(streams(Frame), schema, lambda a, b: a + b),
         ref_sortio.reduce_reader(streams(RefFrame), rschema,
                                  lambda a, b: a + b)),
        (sortio.reduce_reader(streams(Frame), schema, lambda a, b: a - b + b
                              + b),
         ref_sortio.reduce_reader(streams(RefFrame), rschema,
                                  lambda a, b: a - b + b + b)),
    ):
        g = [r for f in got for r in f.rows()]
        w = [r for f in want for r in f.rows()]
        assert g == w


def test_host_reduce_by_key_paths():
    from bigslice_tpu.parallel import segment as ref_segment
    from bigslice_tpu_torch.parallel import segment

    words = np.array(["b", "a", "c", "a", "b", "a"], dtype=object)
    v = np.array([1, 2, 3, 4, 5, 6], np.int32)
    for fn in (lambda a, b: a + b, lambda a, b: a * b + 0):
        gk, gv = segment.host_reduce_by_key([words], [v], fn, 1)
        wk, wv = ref_segment.host_reduce_by_key([words], [v], fn, 1)
        assert list(gk[0]) == list(wk[0])
        np.testing.assert_array_equal(gv[0], wv[0])


def test_shared_state_under_thread_stress():
    """More task threads than cores, a short switch interval: the
    machine combiner's shared buffers and the kernel caches lose no
    contribution."""
    import sys
    import threading

    k = _keys(20000, 26, 700)
    v = np.random.RandomState(26).randint(0, 5, 20000).astype(np.int32)
    want = {}
    for a, b in zip(k.tolist(), v.tolist()):
        want[a] = want.get(a, 0) + b
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        sess = bst.Session(executor=bst.LocalExecutor(
            device="cpu", procs=4 * (os.cpu_count() or 4)),
            machine_combiners=True)
        out = {}

        def run():
            res = sess.run(bst.Reduce(bst.Const(32, k, v),
                                      lambda a, b: a + b))
            out["rows"] = dict(res.rows())

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert out["rows"] == want


def test_frame_host_half_and_reader_helpers():
    from bigslice_tpu.frame.frame import Frame as RefFrame
    from bigslice_tpu_torch import sliceio
    from bigslice_tpu_torch.frame.frame import Frame

    words = np.array(["b", "a", "c", "a", "b"], dtype=object)
    nums = np.array([5, 4, 3, 2, 1], np.int32)
    vecs = np.arange(10, dtype=np.int32).reshape(5, 2)
    f = Frame([words, nums, vecs])
    np.testing.assert_array_equal(
        f.sort_indices(), RefFrame([words, nums, vecs]).sort_indices())
    assert f.row(1)[:2] == ("a", 4) and list(f.row(1)[2]) == [2, 3]
    rows = f.rows()
    g = Frame.from_rows(rows, f.schema)
    assert [r[:2] for r in g.rows()] == [r[:2] for r in rows]
    np.testing.assert_array_equal(g.cols[2].numpy(), vecs)
    s = f.sorted_by_key()
    assert list(s.cols[0]) == ["a", "a", "b", "b", "c"]
    assert s.cols[1].tolist() == [4, 2, 5, 1, 3]
    parts = [f.slice(0, 2), f.slice(2, 5)]
    got = list(sliceio.multi_reader([iter(parts[:1]), iter(parts[1:])]))
    assert [len(x) for x in got] == [2, 3]
    assert [len(x) for x in sliceio.rebatch(iter(parts * 3), 4)] == [4, 4, 4, 3]


def test_pool_starts_a_worker_for_each_task_it_queues():
    """One worker idle in the pool (left by a one-task run) must not stand
    for every task queued before it wakes: the next run's four tasks all
    run at once on ``procs=4``. Each task waits, bounded, until all four
    are inside, which one worker alone can never reach."""
    import threading

    ex = bst.LocalExecutor(device="cpu", procs=4)
    sess = bst.Session(executor=ex)
    sess.run(bst.Const(1, np.arange(4, dtype=np.int32)))  # one worker
    cond = threading.Condition()
    state = {"now": 0, "peak": 0}

    def meet(x):
        with cond:
            state["now"] += 1
            state["peak"] = max(state["peak"], state["now"])
            cond.notify_all()
            cond.wait_for(lambda: state["peak"] >= 4, timeout=5.0)
            state["now"] -= 1
        return (x,)

    res = sess.run(bst.Map(bst.Const(4, np.arange(4, dtype=np.int32)), meet,
                           out=[np.int32], mode="host"))
    assert sorted(res.rows()) == [(i,) for i in range(4)]
    assert state["peak"] == 4
