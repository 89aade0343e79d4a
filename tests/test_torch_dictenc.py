"""The port's dictionary encoding against the JAX package's.

Each case of tests/test_dictenc.py has its counterpart here (its mesh
case on the port's one-device ``MeshExecutor(device="cpu")``, 8 shards
as 8 waves): the same seeded inputs go through the JAX package's
``dictenc`` and the port's, and codes, vocabularies and decoded rows are
equal, exactly. Beside them: ``GlobalVocab`` raced from threads, and
``decode_result_rows`` discarding its Result when a decode fails.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu import slicetest as ref_slicetest  # noqa: E402
from bigslice_tpu.exec.session import Session as RefSession  # noqa: E402
from bigslice_tpu.frame import dictenc as ref_dictenc  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch import slicetest  # noqa: E402
from bigslice_tpu_torch.frame import dictenc  # noqa: E402
from bigslice_tpu_torch.frame.frame import Frame  # noqa: E402


def _sessions():
    return {"mesh": bst.Session(executor=bst.MeshExecutor(device="cpu")),
            "local": bst.Session(executor=bst.LocalExecutor(device="cpu"))}


def test_encode_decode_roundtrip():
    col = ["b", "a", "b", "c", "a"]
    codes, vocab = dictenc.encode_column(col)
    assert codes.dtype == np.int32
    assert vocab == ["b", "a", "c"]
    assert list(dictenc.decode_column(codes, vocab)) == col
    ref_codes, ref_vocab = ref_dictenc.encode_column(col)
    np.testing.assert_array_equal(codes, ref_codes)
    assert vocab == ref_vocab
    assert list(dictenc.decode_column(torch.from_numpy(codes), vocab)) == col


def test_global_vocab():
    v = dictenc.GlobalVocab(["x", "y"])
    v.extend(["z", "x"])
    assert len(v) == 3
    codes = v.encode(["z", "x", "y"])
    assert list(v.decode(codes)) == ["z", "x", "y"]
    with pytest.raises(KeyError):
        v.encode(["nope"])
    rv = ref_dictenc.GlobalVocab(["x", "y"])
    rv.extend(["z", "x"])
    np.testing.assert_array_equal(codes, rv.encode(["z", "x", "y"]))


def test_encode_extending_matches_jax():
    rng = np.random.RandomState(4)
    cols = [[f"w{int(i)}" for i in rng.randint(0, 300, 1000)]
            for _ in range(3)]
    v, rv = dictenc.GlobalVocab(), ref_dictenc.GlobalVocab()
    for col in cols:
        np.testing.assert_array_equal(v.encode_extending(col),
                                      rv.encode_extending(col))
    assert len(v) == len(rv)
    assert v.decode(np.arange(len(v))).tolist() == \
        rv.decode(np.arange(len(rv))).tolist()


def test_encode_frame_column_roundtrip():
    v = dictenc.GlobalVocab(["a", "b"])
    f = Frame([np.array(["a", "b", "a"], dtype=object),
               np.arange(3, dtype=np.int32)])
    enc = dictenc.encode_frame_column(f, 0, v)
    assert enc.schema[0].is_device
    assert enc.cols[0].tolist() == [0, 1, 0]
    dec = dictenc.decode_frame_column(enc, 0, v)
    assert dec.rows() == f.rows()
    assert dec.schema[0].tag == "str"


@pytest.mark.parametrize("ex", ["mesh", "local"])
def test_mapbatches(ex):
    s = bst.Const(2, np.array(["aa", "b", "ccc"], dtype=object),
                  np.arange(3, dtype=np.int32))
    m = bst.MapBatches(
        s, lambda f: [np.asarray([len(x) for x in f.cols[0]], np.int32),
                      f.cols[1]],
        out=[np.int32, np.int32])
    got = slicetest.sorted_rows(m, session=_sessions()[ex])
    assert got == [(1, 1), (2, 0), (3, 2)]
    rs = ref_bs.Const(2, ["aa", "b", "ccc"], np.arange(3, dtype=np.int32))
    rm = ref_bs.MapBatches(
        rs, lambda f: [np.asarray([len(x) for x in f.cols[0]], np.int32),
                       f.cols[1]],
        out=[np.int32, np.int32])
    assert ref_slicetest.sorted_rows(rm) == got


def _words(seed, n, nvocab):
    rng = np.random.RandomState(seed)
    return np.array([f"w{int(i)}" for i in rng.randint(0, nvocab, n)],
                    dtype=object)


@pytest.mark.parametrize("ex", ["mesh", "local"])
@pytest.mark.parametrize("shards", [4, 8])
def test_dict_encoded_reduce_device_path(ex, shards):
    """The encoded Reduce on both executors equals the JAX package's on
    the same words, and the Counter; on the device executor the Reduce
    runs on the device path over the declared dense bound."""
    words = _words(shards, 3000, 64)
    vocab = dictenc.GlobalVocab(sorted(set(words)))
    sess = _sessions()[ex]
    s = bst.Const(shards, words, np.ones(len(words), dtype=np.int32))
    rows = dictenc.dict_encoded_reduce(sess, s, lambda a, b: a + b, vocab)
    want = {w: int(c) for w, c in zip(*np.unique(words, return_counts=True))}
    assert dict(rows) == want and len(rows) == len(want)
    rvocab = ref_dictenc.GlobalVocab(sorted(set(words)))
    ref_rows = ref_dictenc.dict_encoded_reduce(
        RefSession(), ref_bs.Const(shards, list(words),
                                   np.ones(len(words), dtype=np.int32)),
        lambda a, b: a + b, rvocab)
    assert sorted(rows) == sorted(ref_rows)
    if ex == "mesh":
        assert len(sess.executor._outputs) == 0  # discarded after decode


def test_dict_encoded_reduce_small_words():
    words = np.array(["the", "fox", "the", "dog", "fox", "the"] * 50,
                     dtype=object)
    vocab = dictenc.GlobalVocab(sorted(set(words)))
    s = bst.Const(4, words, np.ones(len(words), dtype=np.int32))
    rows = dictenc.dict_encoded_reduce(_sessions()["mesh"], s,
                                       lambda a, b: a + b, vocab)
    assert sorted(rows) == [("dog", 50), ("fox", 100), ("the", 150)]


def test_decode_result_rows_discards_on_failure():
    """A code outside the vocabulary fails the decode; the Result's
    outputs are discarded all the same."""
    sess = _sessions()["mesh"]
    res = sess.run(bst.Reduce(bst.Const(2, np.array([0, 1, 5], np.int32),
                                        np.ones(3, np.int32)),
                              lambda a, b: a + b))
    discarded = []
    orig = res.discard
    res.discard = lambda: (discarded.append(1), orig())
    with pytest.raises(IndexError):
        dictenc.decode_result_rows(res, dictenc.GlobalVocab(["a", "b"]))
    assert discarded == [1]


def test_global_vocab_under_racing_threads():
    """Threads extending one vocabulary at once never give one code to
    two values, nor two codes to one."""
    vocab = dictenc.GlobalVocab()
    words = [f"v{i}" for i in range(2000)]
    rng = np.random.RandomState(1)
    orders = [rng.permutation(len(words)) for _ in range(8)]
    out = [None] * len(orders)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            col = [words[j] for j in orders[i]]
            out[i] = dict(zip(col, vocab.encode_extending(col).tolist()))

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(orders))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(vocab) == len(words)
    assert all(o == out[0] for o in out)
    assert sorted(out[0].values()) == list(range(len(words)))
    assert vocab.decode([out[0][w] for w in words]).tolist() == words
