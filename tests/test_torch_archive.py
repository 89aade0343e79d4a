"""The port's TarSlice and slicetest against the JAX package's.

tests/test_aux.py::test_tarslice has its counterpart here, on the
port's ``MeshExecutor(device="cpu")`` (a host-tier source, run on its
inner local executor) and ``LocalExecutor(device="cpu")``; every
archive is built in ``tmp_path`` and read by both packages, with equal
rows.
"""

import io
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bigslice_tpu import slicetest as ref_slicetest  # noqa: E402
from bigslice_tpu.archive import TarSlice as RefTarSlice  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch import slicetest  # noqa: E402
from bigslice_tpu_torch.typecheck import TypecheckError  # noqa: E402

KINDS = ["mesh", "local"]


def _session(kind):
    if kind == "mesh":
        return bst.Session(executor=bst.MeshExecutor(device="cpu"))
    return bst.Session(executor=bst.LocalExecutor(device="cpu"))


def _write_tar(path, entries, mode="w", dirs=()):
    with tarfile.open(path, mode) as tf:
        for d in dirs:
            info = tarfile.TarInfo(d)
            info.type = tarfile.DIRTYPE
            tf.addfile(info)
        for name, data in entries:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize("kind", KINDS)
def test_tarslice(tmp_path, kind):
    tar_path = str(tmp_path / "a.tar")
    _write_tar(tar_path, [("x.txt", b"xx"), ("y.txt", b"yyy"),
                          ("z.txt", b"z")])
    rows = slicetest.sorted_rows(bst.TarSlice(2, tar_path),
                                 session=_session(kind))
    assert rows == [("x.txt", b"xx"), ("y.txt", b"yyy"), ("z.txt", b"z")]
    assert rows == ref_slicetest.sorted_rows(RefTarSlice(2, tar_path))


@pytest.mark.parametrize("kind", KINDS)
def test_tarslice_stripes_entries_like_jax(tmp_path, kind):
    """A gzipped archive of seeded payloads with directories between the
    files: each shard holds the JAX package's entries, in its order."""
    rng = np.random.RandomState(12)
    entries = [(f"d{i % 3}/f{i:03d}.bin",
                rng.randint(0, 256, rng.randint(0, 64)).astype(
                    np.uint8).tobytes())
               for i in range(50)]
    tar_path = str(tmp_path / "b.tar.gz")
    _write_tar(tar_path, entries, mode="w:gz", dirs=("d0", "d1", "d2"))
    ts, ref = bst.TarSlice(3, tar_path), RefTarSlice(3, tar_path)
    for shard in range(3):
        got = [r for f in ts.reader(shard, ()) for r in f.rows()]
        want = [r for f in ref.reader(shard, ()) for r in f.rows()]
        assert got == want == entries[shard::3]
    res = _session(kind).run(ts)
    assert sorted(res.rows()) == sorted(entries)


@pytest.mark.parametrize("kind", KINDS)
def test_tarslice_feeds_a_count(tmp_path, kind):
    """Payload lengths keyed by the entry's directory through a Map and
    a Reduce, equal to the JAX package's."""
    entries = [(f"d{i % 4}/f{i}", b"a" * i) for i in range(40)]
    tar_path = str(tmp_path / "c.tar")
    _write_tar(tar_path, entries)

    def build(bs, ts):
        m = bs.Map(ts, lambda name, data: (name.split("/")[0], len(data)),
                   out=[str, np.int32])
        return bs.Reduce(m, lambda a, b: a + b)

    import bigslice_tpu as ref_bs

    got = slicetest.sorted_rows(build(bst, bst.TarSlice(2, tar_path)),
                                session=_session(kind))
    want = ref_slicetest.sorted_rows(build(ref_bs, RefTarSlice(2, tar_path)))
    assert got == want
    assert dict(got) == {f"d{d}": sum(range(d, 40, 4)) for d in range(4)}


def test_tarslice_needs_a_shard():
    with pytest.raises(TypecheckError):
        bst.TarSlice(0, "none.tar")


def test_slicetest_helpers_order_rows():
    sess = _session("local")
    s = bst.Const(3, np.array([3, 1, 2], np.int32),
                  np.array(["c", "a", "b"], dtype=object))
    assert sorted(slicetest.scan_all(s, session=sess)) == [
        (1, "a"), (2, "b"), (3, "c")]
    assert slicetest.sorted_rows(s, session=sess) == [
        (1, "a"), (2, "b"), (3, "c")]
    res = slicetest.run(lambda: s, session=sess)
    assert res.num_shards == 3
    assert slicetest._row_key((1, [2, 3])) == \
        ref_slicetest._row_key((1, [2, 3]))
