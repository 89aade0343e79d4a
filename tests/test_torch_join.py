"""JoinAggregate in the port against the JAX package.

The two alignment kernels, on the same masked inputs as the JAX
functions: the tagged-sort ``make_align`` (int, uint32, multi-column and
float keys with +-0.0 and NaN) equal to ``parallel/join.make_align``
row for row, and the hash join ``make_hash_join_align`` equal to
``parallel/hashagg.make_hash_join_align`` slot for slot (its claim
cascade is the JAX package's XLA lowering, slot for slot).

Whole joins through the port's device executor (on the CPU) against the
JAX package's MeshExecutor on 8 virtual devices, per output shard: the
rows of each shard sorted, then equal. Values are integers, so every
comparison is exact.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.exec import compile as ref_compile  # noqa: E402
from bigslice_tpu.parallel import hashagg as ref_hashagg  # noqa: E402
from bigslice_tpu.parallel import join as ref_join  # noqa: E402
import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.exec import compile as port_compile  # noqa: E402
from bigslice_tpu_torch.parallel import cuda_kernels  # noqa: E402
from bigslice_tpu_torch.parallel import hashagg  # noqa: E402
from bigslice_tpu_torch.parallel import join as port_join  # noqa: E402


def add(x, y):
    return x + y


def xor(x, y):
    return x ^ y


@pytest.fixture(scope="module")
def ref_session():
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    mesh = Mesh(np.array(jax.devices()[:8]), ("shards",))
    return Session(executor=MeshExecutor(mesh, auto_dense=False,
                                         hash_aggregate=True))


def _port_session():
    return bst.Session(executor=bst.MeshExecutor(device="cpu"))


def _same_shards(port_res, ref_res):
    got = bst.result_shard_rows(port_res)
    want = bst.result_shard_rows(ref_res)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [c.dtype for c in g] == [c.dtype for c in w]
        for gc, wc in zip(g, w):
            if gc.dtype.kind == "f":
                np.testing.assert_array_equal(gc.view(np.int32),
                                              wc.view(np.int32))
            else:
                np.testing.assert_array_equal(gc, wc)
    return got


def _oracle(ak, av, bk, bv, fa=add, fb=add):
    A, B = {}, {}
    for side, ks, vs, fn in ((A, ak, av, fa), (B, bk, bv, fb)):
        for k, v in zip(ks.tolist(), vs.tolist()):
            side[k] = fn(side[k], v) if k in side else v
    return {k: (A[k], B[k]) for k in A.keys() & B.keys()}


def _join(bs, S_a, ak, av, S_b, bk, bv, fa=add, fb=add):
    return bs.JoinAggregate(bs.Const(S_a, ak, av), bs.Const(S_b, bk, bv),
                            fa, fb)


def _run_both(ref_session, build, sess=None):
    sess = sess or _port_session()
    res = sess.run(build(bst))
    ref = ref_session.run(build(ref_bs))
    return sess, _same_shards(res, ref)


# -- the alignment kernels against the JAX functions ---------------------


def _align_case(case):
    rng = np.random.RandomState(sum(map(ord, case)))
    na, nb = 200, 150
    if case == "float":
        pool = np.array([0.0, -0.0, np.nan, 1.5, -2.25, np.inf, 7.0, 3.0],
                        np.float32)
        ka = [rng.permutation(np.concatenate(
            [pool, rng.randn(na - len(pool)).astype(np.float32)]))]
        kb = [np.concatenate([pool[[1, 0, 2, 3, 5]], ka[0][: nb - 5]])]
    else:
        ka = [rng.choice(1000, na, replace=False).astype(np.int32)]
        kb = [rng.choice(1000, nb, replace=False).astype(np.int32)]
        if case == "uint":
            ka = [(k.astype(np.int64) * 7919 + 2**31).astype(np.uint32)
                  for k in ka]
            kb = [(k.astype(np.int64) * 7919 + 2**31).astype(np.uint32)
                  for k in kb]
        elif case == "multikey":
            ka.append((ka[0] % 3).astype(np.int32))
            kb.append((kb[0] % 3).astype(np.int32))
            ka[0] = ka[0] // 3
            kb[0] = kb[0] // 3
    va = [rng.randint(-50, 50, na).astype(np.int32),
          rng.randn(na).astype(np.float32)]
    vb = [rng.randint(0, 9, nb).astype(np.int32)]
    keep_a = rng.rand(na) < 0.85
    keep_b = rng.rand(nb) < 0.85
    return keep_a, ka, va, keep_b, kb, vb


@pytest.mark.parametrize("case", ["int", "uint", "multikey", "float"])
def test_make_align_matches_reference(case):
    import jax.numpy as jnp

    keep_a, ka, va, keep_b, kb, vb = _align_case(case)
    nk = len(ka)
    rmatch, rcols = ref_join.make_align(nk, 2, 1)(
        jnp.asarray(keep_a), tuple(map(jnp.asarray, ka)),
        tuple(map(jnp.asarray, va)), jnp.asarray(keep_b),
        tuple(map(jnp.asarray, kb)), tuple(map(jnp.asarray, vb)))
    t = torch.from_numpy
    match, cols = port_join.make_align(nk, 2, 1)(
        t(keep_a), tuple(map(t, ka)), tuple(map(t, va)), t(keep_b),
        tuple(map(t, kb)), tuple(map(t, vb)))
    rmatch = np.asarray(rmatch)
    np.testing.assert_array_equal(match.numpy(), rmatch)
    assert rmatch.sum() > 0
    for c, rc in zip(cols, rcols):
        c, rc = c.numpy(), np.asarray(rc)
        # Rows outside the match are the sort's order of the unmatched
        # rows; the matched rows are the result.
        if c.dtype.kind == "f":
            c, rc = c.view(np.int32), rc.view(np.int32)
        np.testing.assert_array_equal(c[rmatch], rc[rmatch])
        np.testing.assert_array_equal(c, rc)


def test_make_align_empty_sides():
    t = torch.zeros(0, dtype=torch.int32)
    e = torch.zeros(0, dtype=torch.bool)
    match, cols = port_join.make_align(1, 1, 1)(e, (t,), (t,), e, (t,),
                                                (t,))
    assert match.shape == (0,) and all(c.shape == (0,) for c in cols)


@pytest.mark.parametrize("case", ["int", "multikey", "maxmin"])
def test_make_hash_join_align_matches_reference(case):
    import jax.numpy as jnp

    rng = np.random.RandomState(len(case))
    na, nb = 300, 200
    ka = [rng.randint(0, 120, na).astype(np.int32)]
    kb = [rng.randint(60, 200, nb).astype(np.int32)]
    ops_a, ops_b = ("add",), ("add",)
    va = [rng.randint(1, 9, na).astype(np.int32)]
    vb = [rng.randint(1, 9, nb).astype(np.int32)]
    if case == "multikey":
        ka.append((ka[0] % 4).astype(np.int32))
        kb.append((kb[0] % 5).astype(np.int32))
    elif case == "maxmin":
        va.append(rng.randn(na).astype(np.float32))
        ops_a = ("add", "max")
        vb = [rng.randint(-99, 99, nb).astype(np.int32)]
        ops_b = ("min",)
    mask_a = rng.rand(na) < 0.8
    mask_b = rng.rand(nb) < 0.8
    nk = len(ka)
    rmask, rcols, rov = ref_hashagg.make_hash_join_align(nk, ops_a, ops_b)(
        jnp.asarray(mask_a), [jnp.asarray(c) for c in ka + va],
        jnp.asarray(mask_b), [jnp.asarray(c) for c in kb + vb])
    t = torch.from_numpy
    mask, cols, ov = hashagg.make_hash_join_align(nk, ops_a, ops_b)(
        t(mask_a), [t(c) for c in ka + va], t(mask_b),
        [t(c) for c in kb + vb])
    assert int(ov) == int(rov) == 0
    rmask = np.asarray(rmask)
    np.testing.assert_array_equal(mask.numpy(), rmask)
    assert rmask.sum() > 0
    for c, rc in zip(cols, rcols):
        c, rc = c.numpy(), np.asarray(rc)
        if c.dtype.kind == "f":
            c, rc = c.view(np.int32), rc.view(np.int32)
        np.testing.assert_array_equal(c[rmask], rc[rmask])


def test_make_hash_join_align_reports_overflow_as_reference():
    """Every slot of the table claimed by a distinct key (load factor 1):
    the cascade cannot place every row, and the two report the same
    count."""
    import jax.numpy as jnp

    ka = np.arange(64, dtype=np.int32)
    kb = np.arange(64, 128, dtype=np.int32)
    ones = np.ones(64, np.int32)
    full = np.ones(64, bool)
    _, _, rov = ref_hashagg.make_hash_join_align(1, ("add",), ("add",))(
        jnp.asarray(full), [jnp.asarray(ka), jnp.asarray(ones)],
        jnp.asarray(full), [jnp.asarray(kb), jnp.asarray(ones)])
    t = torch.from_numpy
    _, _, ov = hashagg.make_hash_join_align(1, ("add",), ("add",))(
        t(full), [t(ka), t(ones)], t(full), [t(kb), t(ones)])
    assert int(ov) == int(rov) > 0


# -- whole joins through the executor -------------------------------------


@pytest.mark.parametrize("S", [4, 8])
def test_join_matches_oracle_and_reference(ref_session, S):
    rng = np.random.RandomState(5)
    ak = rng.randint(0, 60, 640).astype(np.int32)
    av = rng.randint(1, 5, 640).astype(np.int32)
    bk = rng.randint(0, 60, 480).astype(np.int32)
    bv = rng.randint(1, 5, 480).astype(np.int32)
    _, got = _run_both(ref_session,
                       lambda bs: _join(bs, S, ak, av, S, bk, bv))
    rows = {int(k): (int(a), int(b)) for sh in got
            for k, a, b in zip(*sh)}
    assert rows == _oracle(ak, av, bk, bv)


def test_map_after_join(ref_session):
    ak = np.arange(64, dtype=np.int32) % 8
    bk = np.arange(48, dtype=np.int32) % 6
    ones_a, ones_b = np.ones(64, np.int32), np.ones(48, np.int32)

    def build(bs):
        return bs.Map(_join(bs, 8, ak, ones_a, 8, bk, ones_b),
                      lambda k, a, b: (k, a * b))

    _, got = _run_both(ref_session, build)
    rows = {int(k): int(v) for sh in got for k, v in zip(*sh)}
    assert rows == {k: a * b for k, (a, b)
                    in _oracle(ak, ones_a, bk, ones_b).items()}


def test_reduce_after_join(ref_session):
    """An output shuffle after the join stage (join -> map -> reduce)."""
    ak = np.arange(128, dtype=np.int32) % 16
    bk = np.arange(96, dtype=np.int32) % 12
    ones_a, ones_b = np.ones(128, np.int32), np.ones(96, np.int32)

    def build(bs):
        m = bs.Map(_join(bs, 8, ak, ones_a, 8, bk, ones_b),
                   lambda k, a, b: (k % 3, a + b))
        return bs.Reduce(m, add)

    _, got = _run_both(ref_session, build)
    want = collections.Counter()
    for k, (a, b) in _oracle(ak, ones_a, bk, ones_b).items():
        want[k % 3] += a + b
    assert {int(k): int(v) for sh in got for k, v in zip(*sh)} == want


def test_join_disjoint_sides(ref_session):
    a = np.arange(0, 128, dtype=np.int32)
    b = np.arange(1000, 1128, dtype=np.int32)
    ones = np.ones(128, np.int32)
    _, got = _run_both(ref_session,
                       lambda bs: _join(bs, 4, a, ones, 4, b, ones))
    assert sum(len(sh[0]) for sh in got) == 0


@pytest.mark.parametrize("empty", ["a", "b"])
def test_join_one_empty_side(ref_session, empty):
    k = np.arange(50, dtype=np.int32) % 7
    v = np.ones(50, np.int32)
    e = np.zeros(0, np.int32)
    sides = {"a": (e, e, k, v), "b": (k, v, e, e)}[empty]

    def build(bs):
        return _join(bs, 4, sides[0], sides[1], 4, sides[2], sides[3])

    _, got = _run_both(ref_session, build)
    assert sum(len(sh[0]) for sh in got) == 0


@pytest.mark.parametrize("S_a,S_b", [(4, 2), (1, 1)])
def test_join_uneven_and_single_shard(ref_session, S_a, S_b):
    """num_shards is the larger side's; one shard has no shuffle and no
    map-side combine, and the join group reads each producer whole."""
    rng = np.random.RandomState(S_a + S_b)
    ak = rng.randint(0, 40, 300).astype(np.int32)
    bk = rng.randint(20, 70, 200).astype(np.int32)
    av = rng.randint(1, 9, 300).astype(np.int32)
    bv = rng.randint(1, 9, 200).astype(np.int32)
    _, got = _run_both(ref_session,
                       lambda bs: _join(bs, S_a, ak, av, S_b, bk, bv))
    assert len(got) == max(S_a, S_b)
    rows = {int(k): (int(a), int(b)) for sh in got
            for k, a, b in zip(*sh)}
    assert rows == _oracle(ak, av, bk, bv)


def test_xor_join_takes_the_sort_path(ref_session):
    """Side B's fn does not classify: side A's producers keep the hash
    combine, side B's run the sort combine, and the join group runs two
    segmented reduces and the tagged-sort alignment."""
    rng = np.random.RandomState(3)
    ak = rng.randint(0, 90, 700).astype(np.int32)
    bk = rng.randint(0, 90, 500).astype(np.int32)
    av = rng.randint(-1000, 1000, 700).astype(np.int32)
    bv = rng.randint(-(2**31), 2**31 - 1, 500).astype(np.int32)
    sess, got = _run_both(
        ref_session, lambda bs: _join(bs, 4, ak, av, 4, bk, bv, add, xor))
    rows = {int(k): (int(a), int(b)) for sh in got
            for k, a, b in zip(*sh)}
    assert rows == _oracle(ak, av, bk, bv, add, xor)
    assert sess.executor.hash_off == frozenset()


def test_join_over_float_keys(ref_session):
    """Float keys take the sort path on both sides and in the join: -0.0
    and +0.0 join, a NaN key matches nothing."""
    rng = np.random.RandomState(4)
    pool = np.array([0.0, -0.0, np.nan, 1.5, -2.5, 8.0], np.float32)
    ak = pool[rng.randint(0, len(pool), 200)]
    bk = pool[rng.randint(0, len(pool), 150)]
    av = np.ones(200, np.int32)
    bv = np.ones(150, np.int32)
    _, got = _run_both(ref_session,
                       lambda bs: _join(bs, 4, ak, av, 4, bk, bv))
    keys = np.concatenate([sh[0] for sh in got])
    assert not np.isnan(keys).any()
    assert (keys == 0).sum() == 1


def _one_region_keys(n):
    """n distinct int32 keys that all route to partition 0 of 2."""
    cand = torch.arange(200000, dtype=torch.int32)
    part, _ = cuda_kernels.hash_partition_plain([cand], 2, 0,
                                                with_counts=False)
    return cand[part == 0][:n].numpy()


def test_join_hash_overflow_falls_back(ref_session):
    """A join whose claim cascade overflows: one shard, so the producers
    run no shuffle and the join group reads both sides whole — 984
    distinct keys in its 1024-slot table (the cascade places every key
    up to about 950 of them). The wave reruns on the sort path, the
    join's site lands in ``hash_off`` (and no producer's), and the rows
    equal the JAX package's."""
    ka = np.arange(512, dtype=np.int32)
    kb = np.arange(512, 1024, dtype=np.int32)
    kb[:40] = ka[:40]
    ones = np.ones(512, np.int32)
    sess, got = _run_both(ref_session,
                          lambda bs: _join(bs, 1, ka, ones, 1, kb, ones))
    assert [op.split("@")[0] for op in sess.executor.hash_off] == ["join"]
    assert sum(len(sh[0]) for sh in got) == 40


def test_hash_fallback_of_one_side_leaves_the_other(ref_session):
    """Side A's keys all route to one partition of 2 and overflow its
    producers' hash tables; side B's do not. Only A's producer site
    moves to the sort path: the two Const sites are distinct."""
    ka = _one_region_keys(4096)
    kb = np.arange(64, dtype=np.int32) % 50
    sess, got = _run_both(
        ref_session, lambda bs: _join(bs, 2, ka, np.ones(4096, np.int32),
                                      2, kb, np.ones(64, np.int32)))
    off = sess.executor.hash_off
    assert len(off) == 1
    (site,) = off
    assert site.startswith("const@test_torch_join.py:")
    assert int(site.rsplit(":", 1)[1]) == _join.__code__.co_firstlineno + 1
    rows = {int(k) for sh in got for k in sh[0]}
    assert rows == set(np.intersect1d(ka, kb).tolist())


# -- what the host tier and the dense join run, and construction checks -----


def test_dense_keys_join_is_refused_by_name():
    """``dense_keys=`` on a join: at one shard (one shard a device) the
    dense join runs (a rank-indexed table a side), at two the sort join
    does; both equal the JAX package's one-device MeshExecutor, which
    takes the same lowerings, and both sides' combiners carry the
    declaration."""
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    ref = Session(executor=MeshExecutor(
        Mesh(np.array(jax.devices()[:1]), ("shards",))))
    rng = np.random.RandomState(5)
    ka = rng.randint(0, 64, 500).astype(np.int32)
    kb = rng.randint(0, 40, 300).astype(np.int32)
    va = rng.randint(-9, 9, 500).astype(np.int32)
    vb = rng.randint(-9, 9, 300).astype(np.int32)
    for shards in (1, 2):
        def build(bs):
            return bs.JoinAggregate(bs.Const(shards, ka, va),
                                    bs.Const(shards, kb, vb), add, xor,
                                    dense_keys=64)

        j = build(bst)
        assert [fc.dense_keys for fc in j.frame_combiners] == [64, None]
        _same_shards(_port_session().run(j), ref.run(build(ref_bs)))

        def build_add(bs):
            return bs.JoinAggregate(bs.Const(shards, ka, va),
                                    bs.Const(shards, kb, vb), add, add,
                                    dense_keys=64)

        assert build_add(bst).frame_combiners[1].dense_ops == ("add",)
        _same_shards(_port_session().run(build_add(bst)),
                     ref.run(build_add(ref_bs)))


@pytest.mark.parametrize("side", ["a", "b"])
def test_host_tier_fn_on_either_side_is_refused(side, ref_session):
    """A host-tier combine fn on either side sends the side's producers
    (whose map-side combine runs it) and the join to the device
    executor's host tier; the rows equal the JAX package's."""
    def host(x, y):
        return x if int(x.sum()) > 0 else y  # needs data: host tier

    k = np.arange(16, dtype=np.int32) % 5
    fa, fb = (host, add) if side == "a" else (add, host)

    def build(bs):
        return bs.JoinAggregate(bs.Const(2, k, k), bs.Const(2, k, k),
                                fa, fb)

    assert not build(bst).frame_combiners[0 if side == "a" else 1].device
    _same_shards(_port_session().run(build(bst)),
                 ref_session.run(build(ref_bs)))


def test_join_typechecks():
    from bigslice_tpu_torch.typecheck import TypecheckError

    a = bst.Const(2, np.arange(4, dtype=np.int32), np.ones(4, np.int32))
    b_badkey = bst.Const(2, np.arange(4, dtype=np.float32),
                         np.ones(4, np.int32))
    with pytest.raises(TypecheckError, match="key column types mismatch"):
        bst.JoinAggregate(a, b_badkey, lambda x, y: x, lambda x, y: x)
    no_vals = bst.Const(2, np.arange(4, dtype=np.int32))
    with pytest.raises(TypecheckError,
                       match="right input must have value columns"):
        bst.JoinAggregate(a, no_vals, lambda x, y: x, lambda x, y: x)
    with pytest.raises(TypecheckError,
                       match="left input must have value columns"):
        bst.JoinAggregate(no_vals, a, lambda x, y: x, lambda x, y: x)
    # A vector key column neither hashes nor compares.
    vec = bst.Const(2, np.zeros((4, 3), np.int32), np.ones(4, np.int32))
    with pytest.raises(TypecheckError, match="is not joinable"):
        bst.JoinAggregate(vec, vec, lambda x, y: x, lambda x, y: x)
    # Host keys hash and compare on the host tier, as in the JAX
    # package: the join typechecks and runs on the local executor
    # (tests/test_torch_local.py) and on the device executor's host
    # tier.
    host = bst.Const(2, np.array(list("abcd"), dtype=object),
                     np.ones(4, np.int32))
    j = bst.JoinAggregate(host, host, lambda x, y: x, lambda x, y: x)
    rows = bst.Session(executor=bst.MeshExecutor(device="cpu")).run(j).rows()
    assert sorted(rows) == [(c, 1, 1) for c in "abcd"]


def test_join_schema_and_shards():
    a = bst.Const(3, np.arange(6, dtype=np.int32), np.ones(6, np.float32))
    b = bst.Const(5, np.arange(6, dtype=np.int32), np.ones(6, np.int32),
                  np.ones(6, np.uint32))
    j = bst.JoinAggregate(a, b, add, lambda x, y: (x[0] + y[0],
                                                   x[1] + y[1]))
    assert j.num_shards == 5 and j.prefix == 1
    assert [str(ct) for ct in j.schema] == ["int32", "float32", "int32",
                                            "uint32"]
    assert all(d.shuffle and d.expand for d in j.deps())


def test_golden_join_aggregate_graph():
    """The port's task graph of tests/test_compile.py's join equals the
    golden file, and the JAX package's."""
    import os

    def build(bs):
        a = bs.Const(2, np.arange(4, dtype=np.int32),
                     np.ones(4, dtype=np.int32))
        b = bs.Const(2, np.arange(4, dtype=np.int32),
                     np.ones(4, dtype=np.int32))
        return bs.JoinAggregate(a, b, lambda x, y: x + y,
                                lambda x, y: x * y)

    got = port_compile.graph_string(
        port_compile.Compiler(1).compile(build(bst)), locations=False)
    want = ref_compile.graph_string(
        ref_compile.Compiler(1).compile(build(ref_bs)), locations=False)
    path = os.path.join(os.path.dirname(__file__), "testdata",
                        "join-aggregate.graph")
    with open(path) as fh:
        golden = fh.read()
    assert got == golden == want
