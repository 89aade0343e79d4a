"""The port's wave staging (``bigslice_tpu_torch.exec.staging``): its
two-pass ``assemble`` against the JAX package's over the same frames
(equal padded columns and counts, exactly), the object-column
``StagingFallback``, ``map_shards``' order and errors, the arena's
recycle rule (a buffer is reused only after the event behind its copy
completes), and whole runs equal with the arena on and off, and equal
to the JAX package's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.exec import staging as ref_staging  # noqa: E402
from bigslice_tpu.frame.frame import Frame as RefFrame  # noqa: E402
from bigslice_tpu.slicetype import ColType as RefColType  # noqa: E402
from bigslice_tpu.slicetype import Schema as RefSchema  # noqa: E402
import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.exec import staging  # noqa: E402
from bigslice_tpu_torch.frame.frame import Frame, obj_col  # noqa: E402
from bigslice_tpu_torch.slicetype import ColType, Schema  # noqa: E402


def _shard_lists(seed, nmesh, empty_ok=True):
    rng = np.random.RandomState(seed)
    lists = []
    for _ in range(nmesh):
        fl = []
        for _ in range(int(rng.randint(0 if empty_ok else 1, 4))):
            n = int(rng.randint(0, 300))
            fl.append([rng.randint(0, 99, n).astype(np.int32),
                       rng.rand(n, 2).astype(np.float32),
                       rng.randint(0, 2**32 - 1, n,
                                   dtype=np.uint64).astype(np.uint32)])
        lists.append(fl)
    return lists


@pytest.mark.parametrize("seed,nmesh", [(11, 1), (12, 4), (13, 8)])
def test_assemble_matches_the_jax_packages(seed, nmesh):
    lists = _shard_lists(seed, nmesh)
    dims = [((), np.int32), ((2,), np.float32), ((), np.uint32)]
    ref_schema = RefSchema([RefColType(np.dtype(t), "", d)
                            for d, t in dims], 1)
    schema = Schema([ColType(np.dtype(t), "", d) for d, t in dims], 1)
    want_cols, want_counts, want_cap, _ = ref_staging.assemble(
        [[RefFrame(c) for c in fl] for fl in lists], ref_schema, nmesh,
        ref_staging.StagingArena(enabled=True, mode="recycle"))
    # Each rank assembles its own slot: slot d's buffers are the JAX
    # package's global buffers' rows [d * cap, (d + 1) * cap).
    arena = staging.StagingArena(enabled=True, mode="zerocopy")
    for d in range(nmesh):
        got_cols, count, cap, bufs = staging.assemble(
            [[Frame.from_numpy(c) for c in fl] for fl in lists], schema,
            nmesh, arena, slot=d)
        assert count == want_counts[d] and cap == want_cap
        assert len(bufs) == len(got_cols) == 3
        for g, w in zip(got_cols, want_cols):
            assert g.numpy().dtype == w.dtype
            assert g.numpy().tobytes() == np.asarray(
                w)[d * cap : (d + 1) * cap].tobytes()
    assert arena.stats()["misses"] == 3 * nmesh
    assert arena.stats()["hits"] == 0


def test_assemble_with_no_frames_uses_the_schema():
    schema = Schema([ColType(np.dtype(np.int32), "", ()),
                     ColType(np.dtype(np.float32), "", (4,))], 1)
    cols, count, cap, _ = staging.assemble(
        [[], []], schema, 2, staging.StagingArena(enabled=True), slot=1)
    assert count == 0 and cap == 8
    assert cols[0].shape == (8,) and cols[1].shape == (8, 4)
    assert not cols[0].any() and not cols[1].any()


def test_assemble_falls_back_on_object_columns():
    arena = staging.StagingArena(enabled=True)
    lists = [[Frame([obj_col(["a", "b"]), np.ones(2, np.int32)])]]
    with pytest.raises(staging.StagingFallback):
        staging.assemble(lists, None, 4, arena)


def test_assemble_falls_back_on_dtype_drift():
    arena = staging.StagingArena(enabled=True)
    lists = [[Frame([np.ones(3, np.int32)]),
              Frame([np.ones(3, np.float32)])]]
    with pytest.raises(staging.StagingFallback):
        staging.assemble(lists, None, 1, arena)


class _Event:
    """A stand-in for the CUDA event behind a copy."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_recycled_buffers_wait_for_their_copys_event(monkeypatch):
    arena = staging.StagingArena(enabled=True, mode="recycle")
    # Recycle mode pins its buffers; the bookkeeping is what is tested
    # here, so allocate plain host memory.
    monkeypatch.setattr(arena, "_alloc",
                        lambda dtype, shape: torch.empty(shape, dtype=dtype))
    a = arena.acquire(torch.int32, (64,))
    ev = _Event()
    arena.release([a], ev)
    b = arena.acquire(torch.int32, (64,))
    assert b is not a  # the copy may still be reading a
    assert arena.stats()["hits"] == 0 and arena.stats()["in_flight"] == 1
    ev.done = True
    c = arena.acquire(torch.int32, (64,))
    assert c is a and arena.hits == 1 and arena.recycled == 1
    arena.release([c], ev)
    assert arena.stats()["pinned"] is False  # plain host memory here
    # Another shape never takes it; the byte bound drops what exceeds it.
    small = staging.StagingArena(enabled=True, mode="recycle", max_bytes=100)
    monkeypatch.setattr(small, "_alloc",
                        lambda dtype, shape: torch.empty(shape, dtype=dtype))
    x = small.acquire(torch.int32, (64,))
    done = _Event()
    done.done = True
    small.release([x], done)
    assert small.acquire(torch.int32, (64,)) is not x
    assert small.recycled == 0


def test_zerocopy_arena_never_recycles():
    arena = staging.StagingArena(enabled=True, mode="zerocopy")
    a = arena.acquire(torch.int32, (8,))
    arena.release([a])
    assert arena.acquire(torch.int32, (8,)) is not a
    assert arena.stats()["recycled"] == 0
    assert arena.stats()["pinned"] is None  # it holds nothing


def test_map_shards_order_and_errors():
    assert staging.map_shards(lambda x: x * 2, [1, 2, 3], threads=4) \
        == [2, 4, 6]
    assert staging.map_shards(lambda x: x + 1, [5], threads=4) == [6]

    def boom(x):
        if x == 2:
            raise KeyError("x2")
        return x

    with pytest.raises(KeyError):
        staging.map_shards(boom, [1, 2, 3], threads=4)


@pytest.fixture(scope="module")
def ref_session():
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    mesh = Mesh(np.array(jax.devices()[:8]), ("shards",))
    return Session(executor=MeshExecutor(mesh, auto_dense=False,
                                         hash_aggregate=True))


def _port_rows(slice_fn, **ex):
    sess = bst.Session(executor=bst.MeshExecutor(device="cpu", **ex))
    return bst.result_shard_rows(sess.run(slice_fn())), sess.executor


def _assert_shards_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            assert gc.dtype == wc.dtype and gc.shape == wc.shape
            assert gc.tobytes() == wc.tobytes()


def test_arena_on_off_equal_and_equal_to_the_jax_package(ref_session):
    rng = np.random.RandomState(23)
    keys = rng.randint(0, 97, 16 * 64).astype(np.int32)
    vals = rng.randint(1, 9, 16 * 64).astype(np.int32)
    want = bst.result_shard_rows(ref_session.run(
        ref_bs.Reduce(ref_bs.Const(16, keys, vals), lambda a, b: a + b)))
    for arena in (True, False):
        got, ex = _port_rows(
            lambda: bst.Reduce(bst.Const(16, keys, vals),
                               lambda a, b: a + b), staging_arena=arena)
        _assert_shards_equal(got, want)
        st = ex.staging_arena.stats()
        assert st["mode"] == "zerocopy" and st["enabled"] is arena
        assert (st["misses"] > 0) is arena


def test_arena_on_off_bit_identical_float_vectors():
    """Float32 vector values (the hash lowering's row scatter); the
    arena changes no program, layout or padding, so the sums are
    bit-identical."""
    rng = np.random.RandomState(31)
    keys = rng.randint(0, 61, 16 * 96).astype(np.int32)
    vals = rng.rand(16 * 96, 4).astype(np.float32)

    def make():
        return bst.Reduce(bst.Const(16, keys, vals), lambda a, b: a + b)

    on, _ = _port_rows(make, staging_arena=True)
    off, _ = _port_rows(make, staging_arena=False)
    _assert_shards_equal(on, off)
