"""K2: the port's hash_aggregate (its plain version, on the CPU) against
the JAX package's table builds: slot for slot against
hashagg.hash_aggregate(backend="xla"), and by occupied rows plus the
region invariant against the Pallas kernel in interpret mode. Also the
executor's sort-path fallback for a table that overflows."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bigslice_tpu.frame import ops as ref_ops  # noqa: E402
from bigslice_tpu.parallel import hashagg as ref_hashagg  # noqa: E402
from bigslice_tpu.parallel import pallas_kernels as pk  # noqa: E402
import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.parallel import cuda_kernels  # noqa: E402

CASES = ["int1k", "uint", "f32vals", "multikey", "maxmin"]


def _case(case):
    """The five table cases of tests/test_pallas.py (key cardinality
    under T/4, so neither cascade overflows)."""
    rng = np.random.RandomState(sum(map(ord, case)))
    nparts, R = 4, 256
    n = 3000
    distinct = nparts * R // 4
    k1 = rng.randint(0, distinct, n).astype(np.int32)
    keys = [k1]
    ops = ["add"]
    vals = [rng.randint(1, 100, n).astype(np.int32)]
    if case == "uint":
        keys = [k1.view(np.uint32)]
        vals = [vals[0].view(np.uint32)]
    elif case == "f32vals":
        v = rng.randn(n).astype(np.float32)
        v[::53] = -0.0
        vals = [v]
        ops = ["max"]
    elif case == "multikey":
        keys = [k1, (k1 % 7).astype(np.int32)]
        vals = [vals[0], rng.randint(0, 9, n).astype(np.int32)]
        ops = ["add", "min"]
    elif case == "maxmin":
        vals = [vals[0], rng.randint(-50, 50, n).astype(np.int32)]
        ops = ["max", "min"]
    valid = rng.rand(n) < 0.9
    return keys, vals, ops, valid, nparts, R


def _part(keys, nparts):
    h = ref_ops.hash_device_column(keys[0], 0)
    for k in keys[1:]:
        h = ref_ops.combine_hashes(h, ref_ops.hash_device_column(k, 0))
    return (h % np.uint32(nparts)).astype(np.int32)


def _port(keys, vals, ops, valid, part, nparts, R, seed=0):
    present, okeys, ovals, ov = cuda_kernels.hash_aggregate(
        torch.from_numpy(valid), [torch.from_numpy(k) for k in keys],
        [torch.from_numpy(v) for v in vals], ops, torch.from_numpy(part),
        nparts, R, seed)
    return (present.numpy(), [k.numpy() for k in okeys],
            [v.numpy() for v in ovals], int(ov))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype.itemsize == 4 else a


def _rows(present, keys, vals):
    cols = [np.asarray(c)[present] for c in list(keys) + list(vals)]
    cols = [_bits(c) for c in cols]
    return sorted(zip(*[c.tolist() for c in cols]))


def _regions(present, keys, nparts, R):
    slots = np.nonzero(present)[0]
    want = _part([np.asarray(k)[present] for k in keys], nparts)
    np.testing.assert_array_equal(slots // R, want)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_xla_slot_for_slot(case):
    import jax.numpy as jnp

    keys, vals, ops, valid, nparts, R = _case(case)
    part = _part(keys, nparts)
    rp, rk, rv, rov = ref_hashagg.hash_aggregate(
        jnp.asarray(valid), [jnp.asarray(k) for k in keys],
        [jnp.asarray(v) for v in vals], ops, jnp.asarray(part),
        nparts, R, backend="xla")
    present, okeys, ovals, ov = _port(keys, vals, ops, valid, part,
                                      nparts, R)
    assert ov == int(rov) == 0
    np.testing.assert_array_equal(present, np.asarray(rp))
    for got, want in zip(okeys, rk):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    for got, want in zip(ovals, rv):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    _regions(present, okeys, nparts, R)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_rows(case):
    if not pk.interpret_capable():
        pytest.skip("pallas interpret mode cannot execute kernels on this "
                    "jax build (pk.interpret_capable() probe failed)")
    import jax.numpy as jnp

    keys, vals, ops, valid, nparts, R = _case(case)
    part = _part(keys, nparts)
    gp, gk, gv, gov = pk.hash_aggregate_pallas(
        jnp.asarray(valid), [jnp.asarray(k) for k in keys],
        [jnp.asarray(v) for v in vals], ops, jnp.asarray(part),
        nparts, R, interpret=True)
    present, okeys, ovals, ov = _port(keys, vals, ops, valid, part,
                                      nparts, R)
    assert ov == int(gov) == 0
    assert _rows(present, okeys, ovals) == _rows(np.asarray(gp), gk, gv)
    _regions(present, okeys, nparts, R)


@pytest.mark.parametrize("op", ["max", "min"])
def test_float_bits_exact(op):
    """float32 payloads keep their bits: -0.0 stays -0.0 and NaN its
    pattern; repeated keys combine as jnp.maximum / jnp.minimum do
    (NaN propagates, +0.0 beats -0.0 under max, -0.0 under min)."""
    import jax.numpy as jnp

    nparts, R = 2, 128
    keys = [np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 8, 9, 9, 10, 10],
                     np.int32)]
    v = np.array([0.0, -0.0, np.nan, 1.5, -2.5, np.inf, -np.inf, 3.0,
                  -0.0, 0.0, 0.0, -0.0, np.nan, 2.0], np.float32)
    valid = np.ones(len(v), bool)
    part = (keys[0] % nparts).astype(np.int32)
    rp, rk, rv, _ = ref_hashagg.hash_aggregate(
        jnp.asarray(valid), [jnp.asarray(keys[0])], [jnp.asarray(v)],
        [op], jnp.asarray(part), nparts, R, backend="xla")
    present, okeys, ovals, _ = _port(keys, [v], [op], valid, part,
                                     nparts, R)
    np.testing.assert_array_equal(present, np.asarray(rp))
    np.testing.assert_array_equal(_bits(ovals[0]), _bits(rv[0]))


def test_overflow_count_matches_xla():
    """More distinct keys than slots: both cascades place the same rows
    and report the same overflow."""
    import jax.numpy as jnp

    keys = [np.arange(100, dtype=np.int32)]
    vals = [np.ones(100, np.int32)]
    valid = np.ones(100, bool)
    part = np.zeros(100, np.int32)
    rp, _, _, rov = ref_hashagg.hash_aggregate(
        jnp.asarray(valid), [jnp.asarray(keys[0])], [jnp.asarray(vals[0])],
        ["add"], jnp.asarray(part), 1, 64, backend="xla")
    present, _, _, ov = _port(keys, vals, ["add"], valid, part, 1, 64)
    assert ov == int(rov) > 0
    np.testing.assert_array_equal(present, np.asarray(rp))


def _cpu_session():
    return bst.Session(executor=bst.MeshExecutor(device="cpu"))


@pytest.fixture(scope="module")
def ref_session():
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    mesh = Mesh(np.array(jax.devices()[:8]), ("shards",))
    return Session(executor=MeshExecutor(mesh, auto_dense=False,
                                         hash_aggregate=True))


def _same_rows(port_res, ref_res):
    got = bst.result_shard_rows(port_res)
    want = bst.result_shard_rows(ref_res)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            np.testing.assert_array_equal(gc, wc)


def test_executor_falls_back_on_hash_overflow(ref_session):
    """Distinct keys all routed to one partition overflow its region.
    The run no longer raises: the wave reruns on the sort path, the op
    stays there (``hash_off``), and the rows equal the JAX package's,
    which falls back the same way."""
    import bigslice_tpu as ref_bs

    cand = np.arange(200000, dtype=np.int32)
    keys = cand[_part([cand], 2) == 0][:4096]
    ones = np.ones(len(keys), np.int32)
    sess = _cpu_session()
    res = sess.run(bst.Reduce(bst.Const(2, keys, ones), lambda a, b: a + b))
    ref = ref_session.run(ref_bs.Reduce(ref_bs.Const(2, keys, ones),
                                        lambda a, b: a + b))
    _same_rows(res, ref)
    assert any(op.startswith("const") for op in sess.executor.hash_off)
    assert len(res.rows()) == len(keys)


@pytest.mark.parametrize("what", ["fn", "float_key"])
def test_executor_runs_sort_lowering_cases(what, ref_session):
    """A combine fn that does not classify as add/max/min, and float
    keys, were refused before the sort lowering was ported. Both run on
    it now, with the JAX package's rows (the fn is not associative, so
    this also pins the order in which the two combine)."""
    import bigslice_tpu as ref_bs

    keys = np.arange(64, dtype=np.int32) % 5
    if what == "float_key":
        keys = keys.astype(np.float32)
    fn = (lambda a, b: a * b + 1) if what == "fn" else (lambda a, b: a + b)
    ones = np.ones(64, np.int32)
    res = _cpu_session().run(bst.Reduce(bst.Const(2, keys, ones), fn))
    ref = ref_session.run(ref_bs.Reduce(ref_bs.Const(2, keys, ones), fn))
    _same_rows(res, ref)


def test_hash_fallback_is_per_site():
    """The sort-path fallback is remembered per pipeline site
    (file:line op), as in the JAX package: another Reduce site on the
    same executor keeps the hash lowering, and a re-run of the
    overflowing site (a new #N invocation) goes straight to the sort
    path."""
    cand = np.arange(200000, dtype=np.int32)
    keys = cand[_part([cand], 2) == 0][:4096]
    ones = np.ones(len(keys), np.int32)
    sess = _cpu_session()
    ex = sess.executor

    def overflowing():
        return bst.Reduce(bst.Const(2, keys, ones), lambda a, b: a + b)

    sess.run(overflowing())
    off = ex.hash_off
    assert isinstance(off, frozenset)
    assert off and all("@test_torch_hash_aggregate.py:" in op for op in off)
    few = np.arange(60, dtype=np.int32) % 7
    small = bst.Reduce(bst.Const(2, few, ones[:60]), lambda a, b: a + b)
    assert len(sess.run(small).rows()) == 7
    assert ex.hash_off == off
    res = sess.run(overflowing())
    assert ex.hash_off == off and len(res.rows()) == len(keys)
