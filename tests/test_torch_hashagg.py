"""tests/test_hashagg.py's cases on the port.

The JAX package runs its per-device bodies on its 8-device CPU mesh
(``test_hashagg._shardmap_call``), each device over its own n rows.
The port runs the same bodies on one slot: each device's rows are one
call (a table each), and a shuffle to 8 devices is a shuffle into 8
partitions whose rows the port routes by subid (partition p is the
reference's device p). Tables match the reference slot for slot where
both build them the same way (the claim cascade), and by per-key rows
after an exchange; the executor cases run through ``Session`` in both.
The [n, d] vector case is in tests/test_torch_vector_values.py.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.parallel import hashagg as ref_hashagg  # noqa: E402
from bigslice_tpu.parallel import segment as ref_segment  # noqa: E402
from test_hashagg import _hash_session, _shardmap_call  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.parallel import hashagg  # noqa: E402
from bigslice_tpu_torch.parallel import segment  # noqa: E402
from bigslice_tpu_torch.parallel import shuffle  # noqa: E402


def _port_session(**kw):
    return bst.Session(executor=bst.MeshExecutor(
        device="cpu", auto_dense=False, hash_aggregate=True, **kw))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _chunks(a, n):
    return [a[d * n:(d + 1) * n] for d in range(8)]


def test_claim_cascade_exact_and_frozen_slots():
    """tests/test_hashagg.py::test_claim_cascade_exact_and_frozen_slots:
    hot keys beside a long distinct tail, one table a device; each
    device's table equals the reference's slot for slot (the same claim
    cascade), one slot a distinct key, the sums exact."""
    n = 1 << 12
    rng = np.random.RandomState(3)
    keys = np.where(rng.rand(8 * n) < 0.5, rng.randint(0, 4, 8 * n),
                    rng.randint(0, 1 << 20, 8 * n)).astype(np.int32)
    vals = rng.randint(0, 100, 8 * n).astype(np.int32)

    def body(k, v):
        present, ok, ov, over = ref_hashagg.hash_aggregate(
            jnp.ones(n, bool), (k,), (v,), ("add",), jnp.zeros(n, np.int32),
            1, n, backend="xla")
        return present, ok[0], ov[0], over.reshape(1)

    rpres, rko, rvo, rover = _shardmap_call(body, 4, keys, vals)
    assert int(rover.sum()) == 0
    for d, (k, v) in enumerate(zip(_chunks(keys, n), _chunks(vals, n))):
        present, ok, ovals, over = hashagg.hash_aggregate(
            torch.ones(n, dtype=torch.bool), [_t(k)], [_t(v)], ["add"],
            torch.zeros(n, dtype=torch.int32), 1, n)
        assert int(over) == 0
        sl = slice(d * n, (d + 1) * n)
        np.testing.assert_array_equal(present.numpy(), rpres[sl])
        p = present.numpy()
        np.testing.assert_array_equal(ok[0].numpy()[p], rko[sl][p])
        np.testing.assert_array_equal(ovals[0].numpy()[p], rvo[sl][p])
        got = dict(zip(ok[0].numpy()[p].tolist(),
                       ovals[0].numpy()[p].tolist()))
        assert len(got) == int(p.sum())
        want = collections.defaultdict(int)
        for kk, vv in zip(k.tolist(), v.tolist()):
            want[kk] += vv
        assert got == dict(want)


def test_claim_cascade_overflow_signal_at_full_load():
    """tests/test_hashagg.py::test_claim_cascade_overflow_signal_at_full_load:
    all-distinct keys at load 1.0 place or count every row, as many as
    the reference places and counts, device by device."""
    n = 1 << 10
    keys = np.arange(8 * n, dtype=np.int32)
    vals = np.ones(8 * n, np.int32)

    def body(k, v):
        present, ok, ov, over = ref_hashagg.hash_aggregate(
            jnp.ones(n, bool), (k,), (v,), ("add",), jnp.zeros(n, np.int32),
            1, n, backend="xla")
        return present, over.reshape(1)

    rpres, rover = _shardmap_call(body, 2, keys, vals)
    for d, (k, v) in enumerate(zip(_chunks(keys, n), _chunks(vals, n))):
        present, _, _, over = hashagg.hash_aggregate(
            torch.ones(n, dtype=torch.bool), [_t(k)], [_t(v)], ["add"],
            torch.zeros(n, dtype=torch.int32), 1, n)
        assert int(present.sum()) + int(over) == n
        assert int(present.sum()) == int(rpres[d * n:(d + 1) * n].sum())
        assert int(over) == int(rover[d])


def _port_exchange(keys, vals, n, nparts):
    """The port's fused combine-shuffle over the 8 sources' chunks into
    ``nparts`` partitions, then each partition's reduce-side combine:
    {partition: {key: sum}} and the overflow."""
    body = hashagg.make_hash_combine_shuffle(1, 1, 1, ("add",),
                                             nparts=nparts)
    combine = hashagg.make_hash_combine(1, 1, ("add",))
    parts = collections.defaultdict(list)
    over = 0
    for k, v in zip(_chunks(keys, n), _chunks(vals, n)):
        mask, ov, cols = body(torch.ones(n, dtype=torch.bool), _t(k), _t(v))
        over += int(ov)
        subid, ok, ovals = cols
        for p in range(nparts):
            sel = mask & (subid == p)
            parts[p].append((ok[sel], ovals[sel]))
    out = {}
    for p in range(nparts):
        k = torch.cat([a for a, _ in parts[p]])
        v = torch.cat([b for _, b in parts[p]])
        m2, k2, v2, ov2 = combine(torch.ones(k.shape[0], dtype=torch.bool),
                                  (k,), (v,))
        over += int(ov2)
        cnt, packed = segment.compact_by_mask(m2, list(k2) + list(v2))
        c = int(cnt)
        out[p] = dict(zip(packed[0][:c].tolist(), packed[1][:c].tolist()))
    return out, over


def test_hash_combine_shuffle_matches_sort_shuffle():
    """tests/test_hashagg.py::test_hash_combine_shuffle_matches_sort_shuffle:
    every key lands in the partition the routing contract names, with
    the reference's per-device sums, exactly."""
    n = 1 << 12
    rng = np.random.RandomState(5)
    keys = rng.randint(0, 1 << 10, 8 * n).astype(np.int32)
    vals = rng.randint(0, 50, 8 * n).astype(np.int32)
    fused = ref_hashagg.make_hash_combine_shuffle(8, 1, 1, ("add",),
                                                  "shards")
    recv = ref_hashagg.make_hash_combine(1, 1, ("add",))

    def body(k, v):
        rm, ov, bad, oc = fused.masked(jnp.ones(n, bool), k, v)
        m2, k2, v2, ov2 = recv(rm, (oc[0],), (oc[1],))
        cnt, packed = ref_segment.compact_by_mask(m2, tuple(k2) + tuple(v2))
        return cnt.reshape(1), (ov + ov2).reshape(1), packed[0], packed[1]

    cnt, over, ko, vo = _shardmap_call(body, 4, keys, vals)
    assert int(over.sum()) == 0
    size = len(ko) // 8
    want = {d: dict(zip(ko[d * size:d * size + int(cnt[d])].tolist(),
                        vo[d * size:d * size + int(cnt[d])].tolist()))
            for d in range(8)}
    got, gover = _port_exchange(keys, vals, n, 8)
    assert gover == 0
    assert got == want
    total = collections.defaultdict(int)
    for k, v in zip(keys.tolist(), vals.tolist()):
        total[k] += v
    assert {k: v for p in got.values() for k, v in p.items()} == dict(total)
    for p, kv in got.items():
        if kv:
            ids, _, _ = shuffle.partition_ids(
                (torch.tensor(sorted(kv), dtype=torch.int32),), 8, 0)
            assert bool((ids == p).all())


def test_hash_combine_shuffle_waved_partitions():
    """tests/test_hashagg.py::test_hash_combine_shuffle_waved_partitions:
    16 partitions (two waves of the reference's 8 devices; 16 subids on
    the port's one slot), per (partition, key) sums equal."""
    n = 1 << 11
    nparts = 16
    rng = np.random.RandomState(29)
    keys = rng.randint(0, 1 << 9, 8 * n).astype(np.int32)
    vals = rng.randint(0, 20, 8 * n).astype(np.int32)
    fused = ref_hashagg.make_hash_combine_shuffle(8, 1, 1, ("add",),
                                                  "shards", nparts=nparts)

    def body(k, v):
        rm, ov, bad, oc = fused.masked(jnp.ones(n, bool), k, v)
        return rm, ov.reshape(1), oc[0], oc[1], oc[2]

    rm, over, sub, ko, vo = _shardmap_call(body, 5, keys, vals)
    assert int(over.sum()) == 0
    size = len(ko) // 8
    want = collections.defaultdict(int)
    for dev in range(8):
        sl = slice(dev * size, (dev + 1) * size)
        for m, s_, k, v in zip(rm[sl], sub[sl], ko[sl], vo[sl]):
            if m:
                want[(int(s_) * 8 + dev, int(k))] += int(v)
    body = hashagg.make_hash_combine_shuffle(1, 1, 1, ("add",),
                                             nparts=nparts)
    got = collections.defaultdict(int)
    for k, v in zip(_chunks(keys, n), _chunks(vals, n)):
        mask, ov, (subid, ok, ovals) = body(torch.ones(n, dtype=torch.bool),
                                            _t(k), _t(v))
        assert int(ov) == 0
        for s_, kk, vv in zip(subid[mask].tolist(), ok[mask].tolist(),
                              ovals[mask].tolist()):
            got[(s_, kk)] += vv
    assert dict(got) == dict(want)


def test_hash_join_align_inner_join():
    """tests/test_hashagg.py::test_hash_join_align_inner_join: device by
    device, the aligned inner join equals the reference's."""
    n = 1 << 10
    rng = np.random.RandomState(7)
    ka = rng.randint(0, 64, 8 * n).astype(np.int32)
    kb = rng.randint(32, 96, 8 * n).astype(np.int32)
    align = ref_hashagg.make_hash_join_align(1, ("add",), ("add",))

    def body(a, b):
        m = jnp.ones(n, bool)
        mask, cols, ov = align(m, (a, jnp.ones(n, np.int32)), m,
                               (b, jnp.full(n, 2, np.int32)))
        cnt, packed = ref_segment.compact_by_mask(mask, cols)
        return cnt.reshape(1), ov.reshape(1), packed[0], packed[1], packed[2]

    cnt, over, ko, va_o, vb_o = _shardmap_call(body, 5, ka, kb)
    assert int(over.sum()) == 0
    size = len(ko) // 8
    palign = hashagg.make_hash_join_align(1, ("add",), ("add",))
    for d, (a, b) in enumerate(zip(_chunks(ka, n), _chunks(kb, n))):
        m = torch.ones(n, dtype=torch.bool)
        mask, cols, ov = palign(m, (_t(a), torch.ones(n, dtype=torch.int32)),
                                m, (_t(b), torch.full((n,), 2,
                                                      dtype=torch.int32)))
        assert int(ov) == 0
        c, packed = segment.compact_by_mask(mask, cols)
        c = int(c)
        got = {int(k): (int(x), int(y)) for k, x, y in zip(
            packed[0][:c], packed[1][:c], packed[2][:c])}
        sl = slice(d * size, d * size + int(cnt[d]))
        want = {int(k): (int(x), int(y))
                for k, x, y in zip(ko[sl], va_o[sl], vb_o[sl])}
        ca, cb = collections.Counter(a.tolist()), collections.Counter(
            b.tolist())
        assert got == want == {k: (ca[k], 2 * cb[k]) for k in ca if k in cb}


def _rows_by_key(res):
    got = {}
    for row in res.rows():
        assert int(row[0]) not in got
        got[int(row[0])] = tuple(int(x) for x in row[1:])
    return got


def test_e2e_reduce_hash_path_matches_local():
    """tests/test_hashagg.py::test_e2e_reduce_hash_path_matches_local:
    sparse keys through the hash lowering (near-distinct keys, whose
    one-slot waves may overflow onto the sort path), equal to the
    reference's hash session and the oracle."""
    rng = np.random.RandomState(11)
    keys = (rng.randint(0, 1 << 28, 1 << 14) | 1).astype(np.int32)
    vals = rng.randint(0, 100, 1 << 14).astype(np.int32)
    sess = _port_session()
    got = _rows_by_key(sess.run(bst.Reduce(bst.Const(8, keys, vals),
                                           lambda a, b: a + b)))
    want = _rows_by_key(_hash_session().run(ref_bs.Reduce(
        ref_bs.Const(8, keys, vals), lambda a, b: a + b)))
    ref = collections.defaultdict(int)
    for k, v in zip(keys.tolist(), vals.tolist()):
        ref[k] += v
    assert got == want == {k: (v,) for k, v in ref.items()}
    assert sess.executor.device_group_count() > 0


def test_e2e_overflow_falls_back_to_sort_path():
    """tests/test_hashagg.py::test_e2e_overflow_falls_back_to_sort_path
    (also test_torch_hash_aggregate.py's
    test_executor_falls_back_on_hash_overflow): all-distinct keys at load
    1.0, exact through the fallback, and again on a second run."""
    rng = np.random.RandomState(13)
    keys = rng.permutation(1 << 13).astype(np.int32) + (1 << 20)
    vals = np.ones(1 << 13, np.int32)
    sess = _port_session()
    for _ in range(2):
        res = sess.run(bst.Reduce(bst.Const(8, keys, vals),
                                  lambda a, b: a + b))
        assert sum(len(sh[0]) for sh in bst.result_shard_rows(res)) == \
            1 << 13


def test_hash_declines_general_combine_fn():
    """tests/test_hashagg.py::test_hash_declines_general_combine_fn
    (also test_torch_hash_aggregate.py's
    test_executor_runs_sort_lowering_cases[fn]): a fn that is not
    add/max/min takes the sort path, exact against the reference's
    fold of each key's values in order."""
    rng = np.random.RandomState(17)
    keys = rng.randint(0, 1 << 24, 1 << 12).astype(np.int32)
    vals = rng.randint(1, 10, 1 << 12).astype(np.int32)

    def weird(a, b):
        return a * b % 1000003

    r = bst.Reduce(bst.Const(8, keys, vals), weird)
    assert r.frame_combiner.hash_ops() is None
    got = {k: v[0] for k, v in _rows_by_key(_port_session().run(r)).items()}
    order = collections.defaultdict(list)
    for k, v in zip(keys.tolist(), vals.tolist()):
        order[k].append(v)
    ref = {}
    for k, vs in order.items():
        acc = vs[0]
        for v in vs[1:]:
            acc = acc * v % 1000003
        ref[k] = acc
    assert got == ref
    want = _rows_by_key(_hash_session().run(ref_bs.Reduce(
        ref_bs.Const(8, keys, vals), weird)))
    assert got == {k: v[0] for k, v in want.items()}


def test_e2e_join_hash_path_matches_local():
    """tests/test_hashagg.py::test_e2e_join_hash_path_matches_local."""
    n = 1 << 13
    rng = np.random.RandomState(19)
    ak = rng.randint(0, 1 << 24, n).astype(np.int32)
    bk = rng.randint(0, 1 << 24, n).astype(np.int32)
    bk[: n // 2] = ak[: n // 2]
    ones = np.ones(n, np.int32)

    def add(a, b):
        return a + b

    sess = _port_session()
    got = _rows_by_key(sess.run(bst.JoinAggregate(
        bst.Const(8, ak, ones), bst.Const(8, bk, ones), add, add)))
    want = _rows_by_key(_hash_session().run(ref_bs.JoinAggregate(
        ref_bs.Const(8, ak, ones), ref_bs.Const(8, bk, ones), add, add)))
    ca, cb = collections.Counter(ak.tolist()), collections.Counter(
        bk.tolist())
    assert got == want == {k: (ca[k], cb[k]) for k in ca if k in cb}


def test_float_keys_route_to_sort_lowering():
    """tests/test_hashagg.py::test_float_keys_route_to_sort_lowering:
    the gate refuses float keys, and the rows are the same with the
    hash lowering on and off (-0.0 and 0.0 one key), as the
    reference's."""
    from bigslice_tpu_torch.ops.reduce import FrameCombiner
    from bigslice_tpu_torch.slicetype import Schema

    fc = FrameCombiner(lambda a, b: a + b, Schema([np.float32, np.int32]))
    assert fc.hash_ops() is None
    assert _port_session().executor._hash_combine_ops("op", fc) is None
    rng = np.random.RandomState(23)
    keys = rng.randint(-8, 8, 1 << 12).astype(np.float32)
    zero = keys == 0.0
    keys[zero] = np.where(rng.rand(int(zero.sum())) < 0.5, -0.0,
                          0.0).astype(np.float32)
    vals = np.ones(1 << 12, np.int32)

    def run(hash_aggregate):
        sess = bst.Session(executor=bst.MeshExecutor(
            device="cpu", auto_dense=False, hash_aggregate=hash_aggregate))
        res = sess.run(bst.Reduce(bst.Const(8, keys, vals),
                                  lambda a, b: a + b))
        assert sess.executor.device_group_count() > 0
        return sorted((float(k), int(v)) for k, v in res.rows())

    hash_on, hash_off = run(True), run(False)
    assert hash_on == hash_off
    assert len([r for r in hash_on if r[0] == 0.0]) == 1
    ref = collections.defaultdict(int)
    for k in keys.tolist():
        ref[float(k)] += 1
    assert hash_on == sorted(ref.items())
