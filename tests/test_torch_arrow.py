"""Arrow and Parquet interchange of the port (``frame/arrow.py``,
``ops/parquet.py`` and ``Result.to_arrow`` / ``to_pandas`` /
``write_parquet``) against the JAX package's, on the CPU.

The cases of tests/test_arrow.py, each feeding the same seeded numpy
inputs to both packages: Arrow tables compare with ``Table.equals``
(metadata included), frames and result shards exactly (ints and strings;
no float is summed). Result shards compare one by one, since both
packages route every key to the same shard; the port runs on its
``MeshExecutor(device="cpu")`` and its ``LocalExecutor(device="cpu")``,
the JAX package on its ``Session()``.
"""

import glob
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.exec.session import Session as RefSession  # noqa: E402
from bigslice_tpu.frame import arrow as ref_arrow  # noqa: E402
from bigslice_tpu.frame.frame import Frame as RefFrame  # noqa: E402
from bigslice_tpu.frame.frame import obj_col as ref_obj_col  # noqa: E402
from bigslice_tpu.slicetype import ColType as RefColType  # noqa: E402
from bigslice_tpu.slicetype import Schema as RefSchema  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.frame import arrow  # noqa: E402
from bigslice_tpu_torch.frame.frame import Frame, obj_col  # noqa: E402
from bigslice_tpu_torch.slicetype import ColType, Schema  # noqa: E402
from bigslice_tpu_torch.typecheck import TypecheckError  # noqa: E402

KINDS = ["mesh", "local"]


def _session(kind):
    if kind == "mesh":
        return bst.Session(executor=bst.MeshExecutor(device="cpu"))
    return bst.Session(executor=bst.LocalExecutor(device="cpu"))


def _add(a, b):
    return a + b


def _same_shards(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            assert gc.dtype == wc.dtype
            assert gc.tobytes() == wc.tobytes()


def _all_kinds(n, seed):
    """Columns of every kind both packages interchange, and the two
    packages' schemas of them (prefix 2)."""
    rng = np.random.RandomState(seed)
    cols = [rng.randint(0, 99, n).astype(np.int32),
            rng.rand(n).astype(np.float32),
            rng.rand(n, 3).astype(np.float32),
            [f"w{i % 5}" for i in range(n)],
            [list(range(i % 4)) for i in range(n)]]
    spec = [(np.int32, ""), (np.float32, ""), (np.float32, "", (3,)),
            (np.dtype(object), "str"), (np.dtype(object), "list")]
    port = Frame([cols[0], cols[1], cols[2], obj_col(cols[3]),
                  obj_col(cols[4])],
                 Schema([ColType(*s) for s in spec], prefix=2))
    ref = RefFrame([cols[0], cols[1], cols[2], ref_obj_col(cols[3]),
                    ref_obj_col(cols[4])],
                   RefSchema([RefColType(*s) for s in spec], prefix=2))
    return port, ref


def test_frame_arrow_roundtrip_all_column_kinds():
    f, ref = _all_kinds(20, 0)
    table = arrow.to_arrow(f)
    assert table.equals(ref_arrow.to_arrow(ref), check_metadata=True)
    back = arrow.from_arrow(table)
    assert back.prefix == 2  # the metadata round-trips
    assert back == f
    # Each package reads the other's table into equal columns.
    from_ref = arrow.from_arrow(ref_arrow.to_arrow(ref))
    assert from_ref == f
    assert [ct.tag for ct in from_ref.schema] == ["", "", "", "str", "list"]


def test_from_arrow_downcasts_64bit_to_device_tier():
    t = pa.table({"k": pa.array([1, 2, 3, 2**33 + 5, -2**40 - 1],
                                type=pa.int64()),
                  "v": pa.array([0.5, 1.5, 2.5, 1e300, -1e-300],
                                type=pa.float64())})
    f = arrow.from_arrow(t, prefix=1)
    ref = ref_arrow.from_arrow(t, prefix=1)
    assert f.cols[0].dtype == torch.int32
    assert f.cols[1].dtype == torch.float32
    assert f.schema == Schema([np.int32, np.float32])
    for got, want in zip(f.numpy_cols(), ref.cols):
        assert got.tobytes() == np.asarray(want).tobytes()  # wraps alike


def test_to_arrow_refuses_arbitrary_objects():
    col = np.empty(2, dtype=object)
    col[:] = [object(), object()]
    with pytest.raises(TypecheckError, match="non-string objects"):
        arrow.to_arrow(Frame([col], Schema([ColType(np.dtype(object))])))
    with pytest.raises(Exception):
        ref_arrow.to_arrow(RefFrame([col], RefSchema(
            [RefColType(np.dtype(object))])))


@pytest.mark.parametrize("kind", KINDS)
def test_parquet_reader_shards_row_groups(tmp_path, kind):
    """A file of many row groups reads round-robin across shards and
    feeds a device Reduce: the shards equal the JAX package's."""
    n = 300
    rng = np.random.RandomState(1)
    keys = rng.randint(0, 12, n).astype(np.int64)
    vals = rng.randint(0, 9, n).astype(np.int64)
    path = str(tmp_path / "in.parquet")
    pq.write_table(pa.table({"k": keys, "v": vals}), path,
                   row_group_size=32)
    assert arrow.parquet_row_group_count(path) == \
        ref_arrow.parquet_row_group_count(path) == 10
    src = bst.ParquetReader(3, path, out=[np.int32, np.int32])
    got = bst.result_shard_rows(_session(kind).run(bst.Reduce(src, _add)))
    want = bst.result_shard_rows(RefSession().run(ref_bs.Reduce(
        ref_bs.ParquetReader(3, path, out=[np.int32, np.int32]), _add)))
    _same_shards(got, want)
    assert src.stats()["row_groups"] == 10
    assert src.stats()["rows"] == n
    assert src.stats()["decode_s"] > 0


@pytest.mark.parametrize("kind", KINDS)
def test_result_to_arrow_pandas_and_write_parquet(tmp_path, kind):
    keys = np.arange(40, dtype=np.int32) % 5
    ones = np.ones(40, np.int32)
    res = _session(kind).run(bst.Reduce(bst.Const(4, keys, ones), _add))
    ref = RefSession().run(ref_bs.Reduce(ref_bs.Const(4, keys, ones), _add))
    names = ["key", "count"]
    table = res.to_arrow(names=names)
    want = ref.to_arrow(names=names)
    assert table.schema.equals(want.schema, check_metadata=True)
    assert sorted(zip(*table.to_pydict().values())) == \
        sorted(zip(*want.to_pydict().values()))
    df = res.to_pandas(names=names)
    assert dict(zip(df["key"], df["count"])) == {k: 8 for k in range(5)}
    res.write_parquet(str(tmp_path / "out"), names=names)
    ref.write_parquet(str(tmp_path / "ref"), names=names)
    files = sorted(glob.glob(str(tmp_path / "out-*.parquet")))
    ref_files = sorted(glob.glob(str(tmp_path / "ref-*.parquet")))
    assert [f.rsplit("out", 1)[1] for f in files] == \
        [f.rsplit("ref", 1)[1] for f in ref_files]
    assert len(files) == res.num_shards  # empty shards write empty files
    for p, rp in zip(files, ref_files):
        got, w = arrow.read_parquet(p), ref_arrow.read_parquet(rp)
        assert sorted(got.rows()) == sorted(w.rows())


@pytest.mark.parametrize("kind", KINDS)
def test_cogroup_result_to_arrow_ragged_lists(kind):
    keys = np.array([0, 1, 0, 2, 1, 0], np.int32)
    vals = np.arange(6, dtype=np.int32)
    table = _session(kind).run(bst.Cogroup(bst.Const(2, keys, vals))) \
        .to_arrow(names=["key", "vals"])
    want = RefSession().run(ref_bs.Cogroup(ref_bs.Const(2, keys, vals))) \
        .to_arrow(names=["key", "vals"])
    assert table.schema.equals(want.schema)

    def groups(t):
        return {int(k): sorted(v) for k, v in
                zip(t["key"].to_pylist(), t["vals"].to_pylist())}

    assert groups(table) == groups(want) == {0: [0, 2, 5], 1: [1, 4],
                                             2: [3]}


def test_empty_list_column_keeps_concrete_type():
    """A zero-row (or all-empty) list column is list<int32>, not null,
    and keeps its tag on the way back."""
    f = Frame([np.empty(0, np.int32), np.empty(0, dtype=object)],
              Schema([ColType(np.int32),
                      ColType(np.dtype(object), tag="list")]))
    t = arrow.to_arrow(f)
    ref = ref_arrow.to_arrow(RefFrame(
        [np.empty(0, np.int32), np.empty(0, dtype=object)],
        RefSchema([RefColType(np.int32),
                   RefColType(np.dtype(object), tag="list")])))
    assert t.schema.equals(ref.schema, check_metadata=True)
    assert pa.types.is_list(t.schema.field(1).type)
    assert arrow.from_arrow(t).schema.cols[1].tag == "list"
    empties = Frame([np.arange(3, dtype=np.int32), obj_col([[], [], []])],
                    f.schema)
    assert arrow.to_arrow(empties).schema.field(1).type == \
        pa.list_(pa.int32())


def test_from_arrow_downcasts_vector_columns_too():
    fsl = pa.FixedSizeListArray.from_arrays(
        pa.array(np.arange(6, dtype=np.float64)), 2)
    t = pa.Table.from_arrays([fsl], names=["m"])
    f = arrow.from_arrow(t, prefix=1)
    ref = ref_arrow.from_arrow(t, prefix=1)
    assert f.cols[0].dtype == torch.float32
    assert f.schema.cols[0] == ColType(np.float32, shape=(2,))
    assert repr(f.schema) == repr(ref.schema)
    assert f.numpy_cols()[0].tobytes() == np.asarray(ref.cols[0]).tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_parquet_reader_glob_multi_file(tmp_path, kind):
    """A glob hands whole files round-robin to the shards; the union
    covers every row once, shard for shard as the JAX package's."""
    rng = np.random.RandomState(2)
    for i in range(5):
        keys = rng.randint(0, 7, 60).astype(np.int32)
        pq.write_table(pa.table({"k": keys, "v": np.ones(60, np.int32)}),
                       str(tmp_path / f"part{i}.parquet"),
                       row_group_size=25)
    pattern = str(tmp_path / "part*.parquet")
    src = bst.ParquetReader(3, pattern, out=[np.int32, np.int32])
    assert src.urls == sorted(glob.glob(pattern))
    got = bst.result_shard_rows(_session(kind).run(bst.Reduce(src, _add)))
    want = bst.result_shard_rows(RefSession().run(ref_bs.Reduce(
        ref_bs.ParquetReader(3, pattern, out=[np.int32, np.int32]), _add)))
    _same_shards(got, want)
    with pytest.raises(TypecheckError, match="matched no files"):
        bst.ParquetReader(2, str(tmp_path / "nope*.parquet"),
                          out=[np.int32, np.int32])


@pytest.mark.parametrize("kind", KINDS)
def test_parquet_on_memory_urls(kind):
    """A memory:// glob and write_parquet to memory://, as the JAX
    package reads and writes them."""
    fsspec = pytest.importorskip("fsspec")
    base = f"memory://torch-arrow-{kind}"
    rng = np.random.RandomState(5)
    for i in range(3):
        with fsspec.open(f"{base}/in/p{i}.parquet", "wb") as fh:
            pq.write_table(pa.table({
                "k": rng.randint(0, 50, 500).astype(np.int64),
                "v": rng.randint(-2**40, 2**40, 500).astype(np.int64)}),
                fh, row_group_size=100)
    pattern = f"{base}/in/p*.parquet"
    src = bst.ParquetReader(2, pattern, out=[np.int32, np.int32])
    ref_src = ref_bs.ParquetReader(2, pattern, out=[np.int32, np.int32])
    assert src.urls == ref_src.urls and len(src.urls) == 3
    res = _session(kind).run(bst.Reduce(src, _add))
    ref = RefSession().run(ref_bs.Reduce(ref_src, _add))
    _same_shards(bst.result_shard_rows(res), bst.result_shard_rows(ref))
    res.write_parquet(f"{base}/out/sums")
    for s in range(2):
        got = arrow.read_parquet(f"{base}/out/sums-{s:04d}-of-0002.parquet")
        assert sorted(got.rows()) == sorted(
            tuple(int(x) for x in r) for r in zip(
                *bst.result_shard_rows(res)[s]))
    fsspec.filesystem("memory").rm(f"/torch-arrow-{kind}", recursive=True)


def test_parquet_reader_checks_the_declared_schema(tmp_path):
    path = str(tmp_path / "f.parquet")
    pq.write_table(pa.table({"k": np.arange(4, dtype=np.int32),
                             "s": ["a", "b", "c", "d"]}), path)
    with pytest.raises(Exception, match="do not match the declared"):
        _session("local").run(bst.ParquetReader(
            1, path, out=[np.int32, np.int32])).rows()
    src = bst.ParquetReader(1, path, out=[np.int32, str], columns=["k", "s"])
    assert _session("local").run(src).rows() == \
        [(0, "a"), (1, "b"), (2, "c"), (3, "d")]


def test_missing_pyarrow_raises_by_name(monkeypatch):
    f = Frame([np.arange(3, dtype=np.int32)])
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(arrow.ArrowMissing, match="pyarrow"):
        arrow.to_arrow(f)
