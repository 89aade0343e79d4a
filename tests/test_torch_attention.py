"""SelfAttend, ring attention and Ulysses in the port against the JAX
package.

The one-device counterparts of ``tests/test_attention_slice.py``,
``tests/test_ringattention.py`` and ``tests/test_ulysses.py``: the same
numpy inputs, made from a seed, go through the JAX package (its
8-device mesh, as its own tests run it, or its one-device mesh where
the lowering's choice is compared) and through the port on the CPU,
and both are held to the dense float64 oracle and to each other at the
reference tests' tolerances.

The port drives one device slot, so its device tier runs a SelfAttend
over S = 1 shard (the ring has one member; Ulysses' all_to_alls are the
identity), and a group of S > 1 shards runs on the host tier's
broadcast reader, as the JAX package's rule sends S > N there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.parallel import ringattention as ref_ra  # noqa: E402
from bigslice_tpu.parallel import ulysses as ref_ul  # noqa: E402
import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.exec import compile as port_compile  # noqa: E402
from bigslice_tpu_torch.ops.base import Dep, Slice, make_name  # noqa: E402
from bigslice_tpu_torch.parallel import ringattention as ra  # noqa: E402
from bigslice_tpu_torch.parallel import ulysses as ul  # noqa: E402


def _mesh(ndev):
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:ndev]), ("shards",))


@pytest.fixture(scope="module")
def mesh():
    return _mesh(8)


def _ref_session(ndev=8):
    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    return Session(executor=MeshExecutor(_mesh(ndev)))


def _port_session(local=False):
    ex = (bst.LocalExecutor(device="cpu") if local
          else bst.MeshExecutor(device="cpu"))
    return bst.Session(executor=ex)


def _global(mesh, x):
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(x, NamedSharding(mesh, P("shards")))


def qkv(seq, d, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(seq, d).astype(np.float32) * 0.3 for _ in "qkv")


def mha(seq, H, dh, seed):
    rng = np.random.RandomState(seed)
    q3, k3, v3 = (rng.randn(seq, H, dh).astype(np.float32) * 0.3
                  for _ in range(3))
    return (q3, k3, v3), [x.reshape(seq, H * dh) for x in (q3, k3, v3)]


def _out(res):
    return np.stack([np.asarray(o) for (o,) in res.rows()])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ran_on_device(sess):
    return any("attend" in t.op for t in sess.executor._task_index)


# -- the standalone forms (tests/test_attention_slice.py,
#    tests/test_ringattention.py, tests/test_ulysses.py) ------------------


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_block_tiled_matches_reference(mesh, causal):
    q, k, v = qkv(128, 16, seed=1)
    got = ra.make_ring_attention(16, causal=causal, block_q=4)(
        _t(q), _t(k), _t(v)).numpy()
    want = np.asarray(ref_ra.make_ring_attention(
        mesh, 16, causal=causal, block_q=4)(
        *(_global(mesh, x) for x in (q, k, v))))
    ref = ref_ra.dense_attention_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_ring_attention_bf16_close_to_reference(mesh):
    q, k, v = qkv(64, 8, seed=2)
    got = ra.make_ring_attention(8, dtype=torch.bfloat16, block_q=8)(
        _t(q), _t(k), _t(v))
    assert got.dtype == torch.float32  # fp32 statistics and result
    want = np.asarray(ref_ra.make_ring_attention(
        mesh, 8, dtype=jnp.bfloat16, block_q=8)(
        *(_global(mesh, x) for x in (q, k, v))))
    ref = ref_ra.dense_attention_reference(q, k, v)
    np.testing.assert_allclose(got.numpy(), ref, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-2, atol=3e-2)


def test_ring_attention_backward_matches_dense_grad(mesh):
    """d/dq, d/dk, d/dv through the port's checkpointed ring, by
    autograd, equal ``jax.grad`` through the JAX package's ring."""
    q, k, v = qkv(128, 4, seed=3)
    fn = ra.make_ring_attention(4, causal=True, block_q=4, remat=True)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    (fn(tq, tk, tv) ** 2).sum().backward()

    rfn = ref_ra.make_ring_attention(mesh, 4, causal=True, block_q=4,
                                     remat=True)

    def loss(q_, k_, v_):
        return jnp.sum(rfn(q_, k_, v_) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(_global(mesh, x) for x in (q, k, v)))
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_dense(mesh, causal):
    seq, d = 8 * 16, 8
    rng = np.random.RandomState(3 + causal)
    q = rng.randn(seq, d).astype(np.float32) * 0.3
    k = rng.randn(seq, d).astype(np.float32) * 0.3
    v = rng.randn(seq, d).astype(np.float32)
    got = ra.make_ring_attention(d, causal=causal)(_t(q), _t(k), _t(v))
    want = np.asarray(ref_ra.make_ring_attention(mesh, d=d, causal=causal)(
        *(_global(mesh, x) for x in (q, k, v))))
    ref = ref_ra.dense_attention_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_ring_attention_long_sequence_streams(mesh):
    seq, d = 8 * 64, 16
    rng = np.random.RandomState(11)
    q = rng.randn(seq, d).astype(np.float32) * 0.3
    k = rng.randn(seq, d).astype(np.float32) * 0.3
    v = rng.randn(seq, d).astype(np.float32)
    got = ra.make_ring_attention(d, causal=True)(_t(q), _t(k), _t(v))
    want = np.asarray(ref_ra.make_ring_attention(mesh, d=d, causal=True)(
        *(_global(mesh, x) for x in (q, k, v))))
    ref = ref_ra.dense_attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)


def _qkv3(seq, h, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(seq, h, d).astype(np.float32) * 0.3,
            rng.randn(seq, h, d).astype(np.float32) * 0.3,
            rng.randn(seq, h, d).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_dense(mesh, causal):
    seq, h, d = 8 * 16, 16, 8
    q, k, v = _qkv3(seq, h, d, seed=5 + causal)
    got = ul.make_ulysses_attention(nheads=h, d=d, causal=causal)(
        _t(q), _t(k), _t(v))
    want = np.asarray(ref_ul.make_ulysses_attention(
        mesh, nheads=h, d=d, causal=causal)(
        *(_global(mesh, x) for x in (q, k, v))))
    ref = ref_ul.dense_mha_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_ulysses_minimum_heads(mesh):
    seq, h, d = 8 * 8, 8, 16
    q, k, v = _qkv3(seq, h, d, seed=9)
    got = ul.make_ulysses_attention(nheads=h, d=d, causal=True)(
        _t(q), _t(k), _t(v))
    want = np.asarray(ref_ul.make_ulysses_attention(
        mesh, nheads=h, d=d, causal=True)(
        *(_global(mesh, x) for x in (q, k, v))))
    ref = ref_ul.dense_mha_reference(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)


def test_ulysses_rejects_indivisible_heads(mesh):
    """Heads that do not divide the device slots are refused with the
    JAX package's message; on the port's one slot, which every head
    count divides, the stage body is asked for a wider ``nmesh`` than
    it drives."""
    with pytest.raises(ValueError, match="ring attention"):
        ref_ul.make_ulysses_attention(mesh, nheads=6, d=8)
    with pytest.raises(ValueError, match="ring attention"):
        ul.masked_local_body(nmesh=4, nheads=6, d=8)


def test_ring_and_ulysses_agree(mesh):
    seq, h, d = 8 * 8, 8, 8
    q, k, v = _qkv3(seq, h, d, seed=21)
    u_out = ul.make_ulysses_attention(nheads=h, d=d, causal=True)(
        _t(q), _t(k), _t(v)).numpy()
    r_fn = ra.make_ring_attention(d=d, causal=True)
    ref_u = np.asarray(ref_ul.make_ulysses_attention(
        mesh, nheads=h, d=d, causal=True)(
        *(_global(mesh, x) for x in (q, k, v))))
    np.testing.assert_allclose(u_out, ref_u, rtol=3e-4, atol=3e-4)
    for i in range(h):
        r_out = r_fn(_t(q[:, i]), _t(k[:, i]), _t(v[:, i])).numpy()
        np.testing.assert_allclose(u_out[:, i], r_out, rtol=3e-4,
                                   atol=3e-4)
    # The ring's heads ride a leading batch axis: one call, every head.
    batched = r_fn(*(_t(x.transpose(1, 0, 2)) for x in (q, k, v)))
    np.testing.assert_allclose(batched.numpy().transpose(1, 0, 2), u_out,
                               rtol=3e-4, atol=3e-4)


def test_masked_bodies_mask_padding_and_take_one_device_slot():
    """The stage cores over capacity-padded columns: garbage beyond the
    count never reaches a valid row, for either body, tiled or not; a
    body built for a wider mesh refuses to run outside one, by name."""
    seq, cap, H, dh = 37, 64, 2, 8
    rng = np.random.RandomState(13)
    pad = [rng.randn(cap, H, dh).astype(np.float32) for _ in range(3)]
    (q3, k3, v3), _ = mha(seq, H, dh, 13)
    for x, y in zip(pad, (q3, k3, v3)):
        x[:seq] = y
    ref = ref_ul.dense_mha_reference(q3, k3, v3, causal=True)
    count = torch.tensor([seq], dtype=torch.int32)
    u = ul.masked_local_body(1, H, dh, causal=True)(
        count, *(_t(x) for x in pad))
    np.testing.assert_allclose(u.numpy()[:seq], ref, rtol=3e-4, atol=3e-4)
    for bq in (0, 16):
        r = ra.masked_local_body(1, dh, causal=True, block_q=bq)(
            count, *(_t(x.transpose(1, 0, 2)) for x in pad))
        np.testing.assert_allclose(r.numpy().transpose(1, 0, 2)[:seq], ref,
                                   rtol=3e-4, atol=3e-4)
    for body in (ra.masked_local_body(2, dh),
                 ul.masked_local_body(2, H, dh)):
        with pytest.raises(RuntimeError, match="built for 2 slots"):
            body(count, *(_t(x) for x in pad))


# -- SelfAttend (tests/test_attention_slice.py) ------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_selfattend_on_mesh_matches_reference(causal):
    seq, d = 128, 16
    q, k, v = qkv(seq, d, seed=4)
    sess = _port_session()
    got = _out(sess.run(bst.SelfAttend(bst.Const(1, q, k, v, prefix=1),
                                       causal=causal)))
    want = _out(_ref_session().run(ref_bs.SelfAttend(
        ref_bs.Const(8, q, k, v, prefix=1), causal=causal)))
    ref = ref_ra.dense_attention_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # The attend group ran on the device path.
    assert _ran_on_device(sess)


def test_selfattend_host_tier_matches_reference():
    """LocalExecutor: the broadcast dep gives shard 0 the whole
    sequence; its rows equal the JAX package's host tier and the dense
    oracle."""
    seq, d = 48, 8
    q, k, v = qkv(seq, d, seed=5)
    got = _out(_port_session(local=True).run(bst.SelfAttend(
        bst.Const(4, q, k, v, prefix=1), causal=True)))
    from bigslice_tpu.exec.session import Session

    want = _out(Session().run(ref_bs.SelfAttend(
        ref_bs.Const(4, q, k, v, prefix=1), causal=True)))
    ref = ref_ra.dense_attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_selfattend_uneven_shards_count_masking():
    """A sequence that fills no power-of-two capacity: the padded rows
    are masked by the count and causal positions stay logical, through
    the tiled ring."""
    seq, d = 100, 8
    q, k, v = qkv(seq, d, seed=6)
    sess = _port_session()
    got = _out(sess.run(bst.SelfAttend(bst.Const(1, q, k, v, prefix=1),
                                       causal=True, block_q=16)))
    want = _out(_ref_session().run(ref_bs.SelfAttend(
        ref_bs.Const(8, q, k, v, prefix=1), causal=True, block_q=16)))
    ref = ref_ra.dense_attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert set(sess.executor.attend_methods.values()) == {"ring"}


def test_selfattend_fused_outer_map():
    """A Map over SelfAttend fuses into the attend group and runs on the
    device path."""
    seq, d = 64, 8
    q, k, v = qkv(seq, d, seed=7)
    sess = _port_session()
    got = _out(sess.run(bst.Map(bst.SelfAttend(bst.Const(1, q, k, v)),
                                lambda o: o * 2.0)))
    want = _out(_ref_session().run(ref_bs.Map(
        ref_bs.SelfAttend(ref_bs.Const(8, q, k, v)), lambda o: o * 2.0)))
    ref = ref_ra.dense_attention_reference(q, k, v) * 2.0
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    ops = {t.op for t in sess.executor._task_index}
    assert any(op.startswith("attend_map") for op in ops), ops


def test_selfattend_typechecks():
    with pytest.raises(Exception):
        ref_bs.SelfAttend(ref_bs.Const(2, np.arange(8, dtype=np.int32)))
    with pytest.raises(Exception):
        bst.SelfAttend(bst.Const(2, np.arange(8, dtype=np.int32)))


@pytest.mark.parametrize("tier", ["device", "host"])
def test_selfattend_multi_head_both_tiers(tier):
    """heads > 1: each (H*dh,) vector is H stacked heads, on the device
    tier (S = 1) and the host tier (S = 4)."""
    seq, H, dh = 96, 4, 8
    (q3, k3, v3), flat = mha(seq, H, dh, 8)
    ref = ref_ul.dense_mha_reference(q3, k3, v3, causal=True).reshape(
        seq, H * dh)
    if tier == "device":
        sess = _port_session()
        got = _out(sess.run(bst.SelfAttend(bst.Const(1, *flat), causal=True,
                                           heads=H)))
        want = _out(_ref_session().run(ref_bs.SelfAttend(
            ref_bs.Const(8, *flat), causal=True, heads=H)))
        np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)
        assert _ran_on_device(sess)
    else:
        from bigslice_tpu.exec.session import Session

        got = _out(_port_session(local=True).run(bst.SelfAttend(
            bst.Const(4, *flat), causal=True, heads=H)))
        want = _out(Session().run(ref_bs.SelfAttend(
            ref_bs.Const(4, *flat), causal=True, heads=H)))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


def test_selfattend_heads_typecheck():
    q = np.zeros((8, 6), np.float32)
    with pytest.raises(Exception):
        ref_bs.SelfAttend(ref_bs.Const(2, q, q, q), heads=4)  # 6 % 4 != 0
    with pytest.raises(Exception):
        bst.SelfAttend(bst.Const(2, q, q, q), heads=4)
    with pytest.raises(Exception):
        bst.SelfAttend(bst.Const(2, q, q, q), method="flash")


def _methods_on_one_device(flat, **kw):
    """The lowering each package's device tier picks on one device slot,
    and the values: the port's and the JAX package's one-device mesh."""
    sess = _port_session()
    got = _out(sess.run(bst.SelfAttend(bst.Const(1, *flat), **kw)))
    rsess = _ref_session(1)
    want = _out(rsess.run(ref_bs.SelfAttend(ref_bs.Const(1, *flat), **kw)))
    assert _ran_on_device(sess)
    return (got, set(sess.executor.attend_methods.values()),
            want, set(rsess.executor.attend_methods.values()))


@pytest.mark.parametrize("method", ["auto", "ring", "ulysses"])
def test_selfattend_ulysses_lowering_matches_ring(method):
    """On one device heads always divide the slots: "auto" and
    "ulysses" pick Ulysses and "ring" the ring, as the JAX package does
    on its one-device mesh; all match the oracle."""
    seq, H, dh = 90, 8, 4
    (q3, k3, v3), flat = mha(seq, H, dh, 9)
    ref = ref_ul.dense_mha_reference(q3, k3, v3, causal=True).reshape(
        seq, H * dh)
    got, chosen, want, ref_chosen = _methods_on_one_device(
        flat, causal=True, heads=H, method=method)
    np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    assert chosen == ref_chosen == {"ring" if method == "ring"
                                    else "ulysses"}


def test_selfattend_ulysses_indivisible_heads_fall_back_to_ring():
    """The JAX package's 8-device case (3 heads) takes the ring there;
    on one slot 3 heads divide, so both packages take Ulysses, and the
    values match the oracle either way."""
    seq, H, dh = 64, 3, 8
    (q3, k3, v3), flat = mha(seq, H, dh, 10)
    ref = ref_ul.dense_mha_reference(q3, k3, v3).reshape(seq, H * dh)
    got, chosen, want, ref_chosen = _methods_on_one_device(
        flat, heads=H, method="ulysses")
    np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    assert chosen == ref_chosen == {"ulysses"}
    rsess = _ref_session(8)
    rsess.run(ref_bs.SelfAttend(ref_bs.Const(8, *flat), heads=H,
                                method="ulysses")).rows()
    assert set(rsess.executor.attend_methods.values()) == {"ring"}


def test_selfattend_auto_with_block_q_keeps_the_tiled_ring():
    """block_q bounds the score memory: "auto" keeps the tiled ring."""
    seq, H, dh = 64, 8, 4
    (q3, k3, v3), flat = mha(seq, H, dh, 12)
    got, chosen, want, ref_chosen = _methods_on_one_device(
        flat, heads=H, block_q=4)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    assert chosen == ref_chosen == {"ring"}


@pytest.mark.parametrize("method,block_q", [("auto", 0), ("ring", 16)])
def test_selfattend_bf16_matches_reference(method, block_q):
    """bf16 products (q, k, v and p rounded, fp32 accumulation and
    result) through the device stage, against the JAX package's bf16
    stage on its one-device mesh and the oracle."""
    seq, H, dh = 80, 2, 16
    (q3, k3, v3), flat = mha(seq, H, dh, 14)
    ref = ref_ul.dense_mha_reference(q3, k3, v3, causal=True).reshape(
        seq, H * dh)
    sess = _port_session()
    got = _out(sess.run(bst.SelfAttend(
        bst.Const(1, *flat), causal=True, heads=H, dtype=torch.bfloat16,
        method=method, block_q=block_q)))
    rsess = _ref_session(1)
    want = _out(rsess.run(ref_bs.SelfAttend(
        ref_bs.Const(1, *flat), causal=True, heads=H, dtype=jnp.bfloat16,
        method=method, block_q=block_q)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
    assert (set(sess.executor.attend_methods.values())
            == set(rsess.executor.attend_methods.values()))


@pytest.mark.parametrize("method", ["ulysses", "ring"])
def test_bf16_relative_limit_tells_attention_from_the_mean_of_v(method):
    """The bf16 check that ``chip_smoke.py`` and the GPU test add to the
    elementwise 3e-2: ||out - ref|| / ||ref|| <= 1e-2. At 0.3 * randn
    with heads of 128 the softmax is nearly uniform, so an output that
    ignored q k^T and returned the causal running mean of v would be
    close to the oracle elementwise; the relative limit passes the
    bf16 stage and refuses that output."""
    seq, H, dh = 1024, 2, 128
    rng = np.random.RandomState(31)
    q3, k3, v3 = ((rng.randn(seq, H, dh) * 0.3).astype(np.float32)
                  for _ in range(3))
    ref = ref_ul.dense_mha_reference(q3, k3, v3, causal=True)
    t = [torch.from_numpy(x) for x in (q3, k3, v3)]
    count = torch.tensor([seq], dtype=torch.int32)
    if method == "ulysses":
        got = ul.masked_local_body(nheads=H, d=dh, causal=True,
                                   dtype=torch.bfloat16)(count, *t)
    else:
        got = ra.masked_local_body(d=dh, causal=True, dtype=torch.bfloat16,
                                   block_q=128)(
            count, *(x.transpose(0, 1) for x in t)).transpose(0, 1)
    mean_v = (np.cumsum(v3.astype(np.float64), axis=0)
              / np.arange(1, seq + 1)[:, None, None])

    def rel(x):
        return np.linalg.norm(x - ref) / np.linalg.norm(ref)

    assert rel(got.numpy()) <= 1e-2 < rel(mean_v)


# -- the tiers on one device slot -------------------------------------------


def test_selfattend_over_more_shards_than_slots_runs_the_host_tier():
    """S = 4 > nmesh = 1: the device executor runs the group on its host
    tier (no attend lowering recorded, no device output), with the JAX
    package's values."""
    seq, H, dh = 72, 2, 8
    (q3, k3, v3), flat = mha(seq, H, dh, 15)
    ref = ref_ul.dense_mha_reference(q3, k3, v3, causal=True).reshape(
        seq, H * dh)
    sess = _port_session()
    got = _out(sess.run(bst.SelfAttend(bst.Const(4, *flat), causal=True,
                                       heads=H)))
    assert sess.executor.attend_methods == {}
    assert not _ran_on_device(sess)
    want = _out(_ref_session().run(ref_bs.SelfAttend(
        ref_bs.Const(4, *flat), causal=True, heads=H)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


def test_selfattend_after_a_host_tier_producer_falls_back():
    """S = 1, but the producer (a host Map) left no device output: the
    attend group runs the host tier's broadcast reader."""
    seq, d = 40, 8
    q, k, v = qkv(seq, d, seed=16)
    vec = [bst.ColType(np.float32, shape=(d,))] * 3
    m = bst.Map(bst.Const(1, q, k, v), lambda a, b, c: (a, b, c),
                out=vec, mode="host")
    sess = _port_session()
    got = _out(sess.run(bst.SelfAttend(m, causal=True)))
    np.testing.assert_allclose(
        got, ref_ra.dense_attention_reference(q, k, v, causal=True),
        rtol=1e-5, atol=1e-6)
    assert sess.executor.attend_methods == {}
    assert not _ran_on_device(sess)


class _Gather(Slice):
    """A broadcast consumer that hands shard 0 every producer row in the
    order it reads them, and the other shards nothing."""

    def __init__(self, slice_):
        super().__init__(slice_.schema, slice_.num_shards,
                         make_name("gather"))
        self.dep_slice = slice_

    def deps(self):
        return (Dep(self.dep_slice, broadcast=True),)

    def reader(self, shard, deps):
        from bigslice_tpu_torch import sliceio

        if shard != 0:
            return sliceio.empty_reader()
        return deps[0]()


def test_broadcast_dep_reads_producers_in_shard_order():
    """Every consumer shard's dep holds every producer task, in shard
    order, at partition 0 (the JAX package's task graph), and the local
    executor concatenates their frames in that order: the global
    sequence order the attention result depends on."""
    keys = np.arange(1000, dtype=np.int32)
    g = _Gather(bst.Const(5, keys))
    tasks = port_compile.Compiler(1).compile(g)
    for t in tasks:
        (dep,) = t.deps
        assert dep.partition == 0 and not dep.expand
        assert [p.name.shard for p in dep.tasks] == list(range(5))
    res = _port_session(local=True).run(g)
    assert [int(k) for (k,) in res.rows()] == keys.tolist()
    from bigslice_tpu.exec import compile as ref_compile

    q = qkv(20, 4)
    want = ref_compile.graph_string(ref_compile.Compiler(1).compile(
        ref_bs.SelfAttend(ref_bs.Const(4, *q))), locations=False)
    got = port_compile.graph_string(port_compile.Compiler(1).compile(
        bst.SelfAttend(bst.Const(4, *q))), locations=False)
    assert got == want


def test_attend_stage_struct_is_the_reference_tuple():
    """The program cache keys the attend stage on the JAX package's
    id-free tuple, so a re-run or a fresh Session's attend group hits
    the process-wide tier like any other group."""
    from bigslice_tpu_torch.exec.meshexec import MeshExecutor
    from bigslice_tpu_torch.serve import programcache

    q = qkv(32, 8)
    att = bst.SelfAttend(bst.Const(1, *q), causal=True, block_q=8, heads=2,
                         method="ring")
    assert MeshExecutor._stage_struct([("attend", att)]) == (
        ("attend", (8, True, "float32", 8, 2, "ring")),)
    programcache.reset_global_program_cache()
    builds = []
    for _ in range(2):
        sess = _port_session()
        sess.run(bst.SelfAttend(bst.Const(1, *q), causal=True)).rows()
        progs = sess.telemetry_summary()["device"]["programs"]
        builds.append({op: kinds["group"] for op, kinds in progs.items()
                       if op.startswith("attend")})
        sess.shutdown()
    (first,), (second,) = (b.values() for b in builds)
    assert first["built"] == 1 and first["cross_session_hits"] == 0
    assert second["cross_session_hits"] == 1
