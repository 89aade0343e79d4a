"""The sort shuffle's device functions (parallel/shuffle.py) against the
JAX package's, at ``nshards = 1`` — the one device slot the port runs
on. The reference bodies run under ``shard_map`` on a one-device CPU
mesh (their collectives need a mesh axis); the port's through the
kernels' plain versions on the CPU. Received buckets, validity masks
and the overflow and bad-partition counts must be equal, bucket slot
for bucket slot.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from bigslice_tpu.parallel import segment as ref_seg  # noqa: E402
from bigslice_tpu.parallel import shuffle as ref_shuffle  # noqa: E402
from bigslice_tpu.parallel.meshutil import get_shard_map  # noqa: E402
from bigslice_tpu_torch.parallel import segment as seg  # noqa: E402
from bigslice_tpu_torch.parallel import shuffle  # noqa: E402


def _run_ref(masked, valid, cols, nparts):
    """``masked(valid, *cols)`` under shard_map on one CPU device (its
    outputs: the columns, after a subid column when ``nparts > 1``)."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("shards",))
    spec = P("shards")
    nout = len(cols) + (nparts > 1)

    def body(valid, *cols):
        m, ov, nb, out = masked(valid, *cols)
        return (m, jnp.reshape(ov, (1,)), jnp.reshape(nb, (1,)),
                tuple(out))

    fn = jax.jit(get_shard_map()(
        body, mesh=mesh, in_specs=(spec,) * (1 + len(cols)),
        out_specs=(spec, spec, spec, (spec,) * nout), check_rep=False))
    m, ov, nb, out = fn(jnp.asarray(valid), *map(jnp.asarray, cols))
    return (np.asarray(m), int(ov[0]), int(nb[0]),
            [np.asarray(o) for o in out])


def _run_port(masked, valid, cols):
    m, ov, nb, out = masked(torch.from_numpy(valid),
                            *map(torch.from_numpy, cols))
    return m.numpy(), int(ov), int(nb), [o.numpy() for o in out]


def _assert_same(got, want):
    gm, gov, gnb, gout = got
    wm, wov, wnb, wout = want
    np.testing.assert_array_equal(gm, wm)
    assert (gov, gnb) == (wov, wnb)
    assert len(gout) == len(wout)
    for g, w in zip(gout, wout):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.int32) if g.dtype == np.float32
                                      else g,
                                      w.view(np.int32) if w.dtype == np.float32
                                      else w)


def _input(n, seed, span=50):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, span, n).astype(np.int32)
    vals = (rng.randn(n) * 10).astype(np.float32)
    vals[::7] = -0.0
    valid = rng.rand(n) < 0.9
    return valid, [keys, vals]


def _bad_part(mod):
    """A partitioner with ids -1..5 for 4 partitions (two out of
    range)."""
    return lambda k: k % 7 - 1


@pytest.mark.parametrize("sortless", [True, False])
@pytest.mark.parametrize("ndest", [1, 4])
def test_route_to_buckets_matches(ndest, sortless):
    rng = np.random.RandomState(ndest)
    n = 1000
    dest = rng.randint(0, ndest + 1, n).astype(np.int32)
    cols = [rng.randint(0, 100, n).astype(np.int32),
            rng.randn(n).astype(np.float32)]
    want = ref_shuffle.route_to_buckets(
        jnp.asarray(dest), [jnp.asarray(c) for c in cols], ndest, sortless)
    got = shuffle.route_to_buckets(
        torch.from_numpy(dest), [torch.from_numpy(c) for c in cols], ndest,
        sortless)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # Sentinel rows' offsets are don't-cares: compare the routable ones.
    live = np.asarray(want[0]) < ndest
    np.testing.assert_array_equal(got[2].numpy()[live],
                                  np.asarray(want[2])[live])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


CASES = {
    "waved4": dict(nparts=4),
    "waved4_sort": dict(nparts=4, sortless=False),
    "one_part": dict(nparts=1),
    "one_part_sort": dict(nparts=1, sortless=False),
    "bad_ids": dict(nparts=4, bad=True),
    "slack_quarter": dict(nparts=4, slack=0.25),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_shuffle_fn_matches(case):
    cfg = CASES[case]
    n = 512
    valid, cols = _input(n, len(case))
    kw = dict(nparts=cfg["nparts"], slack=cfg.get("slack", 2.0))
    if "sortless" in cfg:
        kw["sortless"] = cfg["sortless"]
    want = _run_ref(ref_shuffle.make_shuffle_fn(
        1, 1, n, "shards", partition_fn=_bad_part(jnp) if cfg.get("bad")
        else None, use_pallas=False, **kw).masked, valid, cols,
        cfg["nparts"])
    got = _run_port(shuffle.make_shuffle_fn(
        1, 1, n, partition_fn=_bad_part(torch) if cfg.get("bad") else None,
        **kw), valid, cols)
    _assert_same(got, want)
    if cfg.get("bad"):
        assert got[2] > 0
    if cfg.get("slack"):
        assert got[1] > 0


@pytest.mark.parametrize("case", ["waved4", "one_part", "bad_ids",
                                  "slack_quarter"])
def test_make_combine_shuffle_fn_matches(case):
    cfg = CASES[case]
    n = 512
    # Near-distinct keys, so the combine leaves more rows than the
    # quarter-slack bucket holds.
    valid, cols = _input(n, 3 + len(case),
                         span=10000 if cfg.get("slack") else 50)
    rfn = ref_seg.canonical_combine(lambda a, b: a + b, 1)
    pfn = seg.canonical_combine(lambda a, b: a + b, 1)
    kw = dict(nparts=cfg["nparts"], slack=cfg.get("slack", 2.0))
    want = _run_ref(ref_shuffle.make_combine_shuffle_fn(
        1, 1, 1, rfn, "shards",
        partition_fn=_bad_part(jnp) if cfg.get("bad") else None,
        use_pallas=False, **kw).masked, valid, cols, cfg["nparts"])
    got = _run_port(shuffle.make_combine_shuffle_fn(
        1, 1, 1, pfn,
        partition_fn=_bad_part(torch) if cfg.get("bad") else None,
        **kw), valid, cols)
    _assert_same(got, want)
    if cfg.get("bad"):
        assert got[2] > 0
    if cfg.get("slack"):
        assert got[1] > 0


def test_partition_ids_with_partition_fn_matches():
    rng = np.random.RandomState(2)
    keys = rng.randint(0, 100, 400).astype(np.int32)
    valid = rng.rand(400) < 0.8
    want = ref_shuffle.partition_ids(
        [jnp.asarray(keys)], 4, 0, valid=jnp.asarray(valid),
        partition_fn=_bad_part(jnp))
    got = shuffle.partition_ids(
        [torch.from_numpy(keys)], 4, 0, valid=torch.from_numpy(valid),
        partition_fn=_bad_part(torch))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] is None and want[2] is None


def test_executor_slack_ladder(monkeypatch):
    """A shuffle whose buckets overflow reruns with four times the slack,
    up to the slack that cannot overflow, and the op keeps the adapted
    slack. (On one card a bucket cannot overflow at slack >= 1, so the
    ladder is entered here by starting it at 1/16.)"""
    import bigslice_tpu_torch as bst
    from bigslice_tpu_torch.exec import meshexec

    def start_low(self, task0):
        return self._slack_memo.get(meshexec._op_base(task0.name.op), 1 / 16)

    monkeypatch.setattr(meshexec.MeshExecutor, "_wave_slack", start_low)
    keys = np.arange(4000, dtype=np.int32)
    ex = bst.MeshExecutor(device="cpu")
    res = bst.Session(executor=ex).run(bst.Reshuffle(bst.Const(4, keys)))
    assert sorted(r[0] for r in res.rows()) == keys.tolist()
    assert list(ex._slack_memo.values()) == [1.0]
