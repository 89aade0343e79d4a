"""tests/test_cogroup_device.py's six cases on the port.

Each case runs its Cogroup through the JAX package's ``MeshExecutor``
on the 8-device CPU mesh (the reference suite's own session) and the
port's ``MeshExecutor(device="cpu")`` on the same seeded numpy inputs:
the shards equal cell for cell (``test_torch_cogroup._same_shards``:
keys exact, each list element for element in arrival order), and then
the reference case's own assertions hold on the port's rows (the host
oracle, the device path engaged, the capacity ladder, the host tier for
object keys and a fused host consumer).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from test_torch_cogroup import _ref_session, _same_shards  # noqa: E402


@pytest.fixture(scope="module")
def ref8():
    return _ref_session(8)


@pytest.fixture(autouse=True)
def _no_shuffle_env(monkeypatch):
    monkeypatch.delenv("BIGSLICE_SHUFFLE", raising=False)
    monkeypatch.delenv("BIGSLICE_SPILL_BUDGET_BYTES", raising=False)


def _group_oracle(keys, vals):
    oracle = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        oracle.setdefault(k, []).append(v)
    return oracle


def _both(ref8, build):
    """``build(bs)`` through both packages: (port session, port rows),
    the shards compared first (a str key column value for value)."""
    sess = bst.Session(executor=bst.MeshExecutor(device="cpu"))
    res = sess.run(build(bst))
    got = bst.result_shard_rows(res)
    want = bst.result_shard_rows(ref8.run(build(ref_bs)))
    if got and got[0] and got[0][0].dtype == np.dtype(object):
        for g, w in zip(got, want):
            assert g[0].tolist() == w[0].tolist()
        got = [g[1:] for g in got]
        want = [w[1:] for w in want]
    _same_shards(got, want)
    return sess, list(res.rows())


def test_single_slice_cogroup_engages_mesh(ref8):
    """tests/test_cogroup_device.py::test_single_slice_cogroup_engages_mesh."""
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 40, 1600).astype(np.int32)
    vals = rng.randint(0, 100, 1600).astype(np.int32)
    sess, rows = _both(ref8, lambda bs: bs.Cogroup(bs.Const(8, keys, vals)))
    oracle = _group_oracle(keys, vals)
    assert len(rows) == len(oracle)
    for k, grouped in rows:
        assert sorted(int(v) for v in grouped) == sorted(oracle[int(k)])
    # The producer's shuffle group and the Cogroup's ran on the device.
    assert sess.executor.device_group_count() >= 2
    assert sess.executor.cogroup_caps


def test_two_slice_cogroup_matches_host_oracle(ref8):
    """tests/test_cogroup_device.py::test_two_slice_cogroup_matches_host_oracle:
    a full outer join of groups, an empty list for an absent side."""
    rng = np.random.RandomState(1)
    ak = rng.randint(0, 20, 900).astype(np.int32)
    av = rng.randint(0, 50, 900).astype(np.int32)
    bk = rng.randint(10, 30, 700).astype(np.int32)
    bv = rng.randint(0, 50, 700).astype(np.int32)
    sess, rows = _both(ref8, lambda bs: bs.Cogroup(bs.Const(8, ak, av),
                                                   bs.Const(8, bk, bv)))
    oa, ob = _group_oracle(ak, av), _group_oracle(bk, bv)
    assert {int(k) for k, _, _ in rows} == set(oa) | set(ob)
    for k, ga, gb in rows:
        assert sorted(int(v) for v in ga) == sorted(oa.get(int(k), []))
        assert sorted(int(v) for v in gb) == sorted(ob.get(int(k), []))
    assert sess.executor.cogroup_caps


def test_cogroup_hot_key_exercises_capacity_retry(ref8):
    """tests/test_cogroup_device.py::test_cogroup_hot_key_exercises_capacity_retry:
    a hot key of 700 rows grows the capacity past it, rows exact."""
    rng = np.random.RandomState(2)
    keys = np.concatenate([np.zeros(700, np.int32),
                           rng.randint(1, 10, 300).astype(np.int32)])
    vals = np.arange(1000, dtype=np.int32)
    perm = rng.permutation(1000)
    keys, vals = keys[perm], vals[perm]
    sess, rows = _both(ref8, lambda bs: bs.Cogroup(bs.Const(8, keys, vals)))
    got = {int(k): sorted(int(v) for v in g) for k, g in rows}
    assert got == {k: sorted(v)
                   for k, v in _group_oracle(keys, vals).items()}
    caps = sess.executor.cogroup_caps
    assert caps and max(caps.values()) >= 700, caps


def test_cogroup_multi_value_columns(ref8):
    """tests/test_cogroup_device.py::test_cogroup_multi_value_columns."""
    rng = np.random.RandomState(3)
    k = rng.randint(0, 15, 600).astype(np.int32)
    v1 = rng.randint(0, 99, 600).astype(np.int32)
    v2 = rng.rand(600).astype(np.float32)
    _, rows = _both(ref8, lambda bs: bs.Cogroup(bs.Const(8, k, v1, v2)))
    o1, o2 = _group_oracle(k, v1), _group_oracle(k, v2)
    assert len(rows) == len(o1)
    for kk, g1, g2 in rows:
        assert sorted(int(x) for x in g1) == sorted(o1[int(kk)])
        assert sorted(float(x) for x in g2) == pytest.approx(
            sorted(o2[int(kk)]))


def test_cogroup_object_keys_fall_back_to_host(ref8):
    """tests/test_cogroup_device.py::test_cogroup_object_keys_fall_back_to_host:
    str keys keep the host tier under the device executor."""
    words = np.array(["a", "b", "a", "c", "b", "a"], dtype=object)
    vals = np.arange(6, dtype=np.int32)
    sess, rows = _both(ref8, lambda bs: bs.Cogroup(bs.Const(2, words, vals)))
    assert {k: sorted(int(v) for v in g) for k, g in rows} == {
        "a": [0, 2, 5], "b": [1, 4], "c": [3]}
    assert sess.executor.device_group_count() == 0


def test_cogroup_fused_host_consumer_falls_back(ref8):
    """tests/test_cogroup_device.py::test_cogroup_fused_host_consumer_falls_back:
    a Cogroup feeding a host Map runs on the host tier."""
    rng = np.random.RandomState(4)
    keys = rng.randint(0, 12, 400).astype(np.int32)
    vals = rng.randint(0, 9, 400).astype(np.int32)

    def build(bs):
        return bs.Map(bs.Cogroup(bs.Const(4, keys, vals)),
                      lambda k, g: (int(k), len(g)),
                      out=[np.int32, np.int32])

    _, rows = _both(ref8, build)
    assert dict(rows) == {k: len(v)
                          for k, v in _group_oracle(keys, vals).items()}
