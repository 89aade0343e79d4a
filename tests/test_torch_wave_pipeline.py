"""The port's wave pipeline (``MeshExecutor`` on the CPU): the
prefetcher thread, the dispatch/settle split, donation, the device
budget's wave split and prefetch clip, and the subid split's decline.

Mirrors the JAX package's ``tests/test_wave_pipeline.py``: results at
prefetch depths 0, 1 and 2 equal each other and the JAX package's
(8 virtual CPU devices), per output shard and exactly (int sums; float
min is bit-equal); a waved GroupByKey and a waved join are held the
same way. Donation frees every owned staged input and never a chained
producer output.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.exec.meshexec import StagedInput  # noqa: E402
from bigslice_tpu_torch.exec.task import TaskError  # noqa: E402


@pytest.fixture(scope="module")
def ref_session():
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    mesh = Mesh(np.array(jax.devices()[:8]), ("shards",))
    return Session(executor=MeshExecutor(mesh, auto_dense=False,
                                         hash_aggregate=True))


def _ex(**kw):
    return bst.MeshExecutor(device="cpu", **kw)


def _rows(sess, s):
    return bst.result_shard_rows(sess.run(s))


def _assert_shards_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for gc, wc in zip(g, w):
            assert gc.dtype == wc.dtype and gc.shape == wc.shape
            assert gc.tobytes() == wc.tobytes()


def _keyed(seed, n, span):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, span, n).astype(np.int32),
            rng.randint(1, 9, n).astype(np.int32))


def test_prefetch_parity_waved_reduce(ref_session):
    keys, vals = _keyed(23, 16 * 64, 97)
    want = _rows(ref_session, ref_bs.Reduce(ref_bs.Const(16, keys, vals),
                                            lambda a, b: a + b))
    for depth in (0, 1, 2):
        ex = _ex(prefetch_depth=depth)
        got = _rows(bst.Session(executor=ex), bst.Reduce(
            bst.Const(16, keys, vals), lambda a, b: a + b))
        _assert_shards_equal(got, want)
        clock = ex.staging_seconds()
        # 16 map waves and 16 consumer waves staged; exposed <= staged.
        assert clock["waves"] == 32
        assert clock["exposed_s"] <= clock["staged_s"] + 1e-9


def test_prefetch_parity_float_min(ref_session):
    import jax.numpy as jnp

    rng = np.random.RandomState(11)
    keys = rng.randint(0, 60, 16 * 50).astype(np.int32)
    vals = rng.rand(16 * 50).astype(np.float32)
    want = _rows(ref_session, ref_bs.Reduce(
        ref_bs.Const(16, keys, vals), lambda a, b: jnp.minimum(a, b)))
    for depth in (0, 1, 2):
        got = _rows(bst.Session(executor=_ex(prefetch_depth=depth)),
                    bst.Reduce(bst.Const(16, keys, vals),
                               lambda a, b: torch.minimum(a, b)))
        _assert_shards_equal(got, want)


@pytest.mark.parametrize("fb", ["add", "xor"])
def test_prefetch_parity_waved_join(ref_session, fb):
    ak, av = _keyed(5, 16 * 40, 300)
    bk, bv = _keyed(6, 16 * 40, 200)
    fns = {"add": lambda a, b: a + b, "xor": lambda a, b: a ^ b}
    want = _rows(ref_session, ref_bs.JoinAggregate(
        ref_bs.Const(16, ak, av), ref_bs.Const(16, bk, bv),
        lambda a, b: a + b, fns[fb]))
    for depth in (0, 1, 2):
        got = _rows(bst.Session(executor=_ex(prefetch_depth=depth)),
                    bst.JoinAggregate(bst.Const(16, ak, av),
                                      bst.Const(16, bk, bv),
                                      lambda a, b: a + b, fns[fb]))
        _assert_shards_equal(got, want)


def test_prefetch_parity_groupby(ref_session):
    keys, vals = _keyed(19, 8 * 100, 40)
    want = _rows(ref_session, ref_bs.GroupByKey(ref_bs.Const(8, keys, vals),
                                                capacity=64))
    for depth in (0, 1, 2):
        got = _rows(bst.Session(executor=_ex(prefetch_depth=depth)),
                    bst.GroupByKey(bst.Const(8, keys, vals), capacity=64))
        _assert_shards_equal(got, want)
    # 16 waves: the depths agree with each other.
    runs = [_rows(bst.Session(executor=_ex(prefetch_depth=d)),
                  bst.GroupByKey(bst.Const(16, keys, vals), capacity=64))
            for d in (0, 1, 2)]
    _assert_shards_equal(runs[1], runs[0])
    _assert_shards_equal(runs[2], runs[0])


def _spy_staging(ex):
    """Record every StagedInput the executor builds, by origin."""
    staged, chained = [], []
    orig_stage, orig_dep = ex._stage_upload, ex._dep_input

    def stage(*a):
        out = orig_stage(*a)
        staged.append(out)
        return out

    def dep(*a):
        out = orig_dep(*a)
        if not out.owned:
            chained.append(out)
        return out

    ex._stage_upload, ex._dep_input = stage, dep
    return staged, chained


def _freed(inp):
    return all(t.untyped_storage().nbytes() == 0
               for t in list(inp.cols) + [inp.counts])


@pytest.mark.parametrize("depth", [0, 1])
def test_donation_frees_owned_inputs_never_chained_outputs(depth):
    keys, vals = _keyed(7, 16 * 200, 24)
    oracle = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        oracle[k] = oracle.get(k, 0) + v
    ex = _ex(prefetch_depth=depth, donate_buffers=True)
    staged, chained = _spy_staging(ex)
    res = bst.Session(executor=ex).run(bst.Reduce(
        bst.Const(16, keys, vals), lambda a, b: a + b))
    assert dict(res.rows()) == oracle
    assert len(staged) == 16 and all(i.owned for i in staged)
    assert all(_freed(i) for i in staged)
    # The consumer waves chained the map side's merged output (its subid
    # views) zero-copy: never owned, never freed, and the result reads
    # again.
    assert len(chained) == 16
    assert not any(_freed(i) for i in chained)
    assert dict(res.rows()) == oracle


def test_donation_off_keeps_staged_inputs():
    keys = np.arange(16 * 16, dtype=np.int32) % 19
    ex = _ex(prefetch_depth=1, donate_buffers=False)
    staged, _ = _spy_staging(ex)
    res = bst.Session(executor=ex).run(bst.Reduce(
        bst.Const(16, keys, np.ones(len(keys), np.int32)),
        lambda a, b: a + b))
    assert len(dict(res.rows())) == 19
    assert staged and not any(_freed(i) for i in staged)


def test_map_only_chain_keeps_the_counts_it_passes_through():
    """A map-only chain's output carries its input's counts: donation
    keeps that storage."""
    keys = np.arange(16 * 8, dtype=np.int32)
    res = bst.Session(executor=_ex(prefetch_depth=1)).run(
        bst.Map(bst.Const(16, keys), lambda k: k * 2))
    assert sorted(r[0] for r in res.rows()) == sorted((keys * 2).tolist())


def test_prefetch_depth_env_default(monkeypatch):
    monkeypatch.setenv("BIGSLICE_PREFETCH_DEPTH", "3")
    assert _ex().prefetch_depth == 3
    monkeypatch.setenv("BIGSLICE_PREFETCH_DEPTH", "0")
    assert _ex().prefetch_depth == 0
    monkeypatch.setenv("BIGSLICE_DONATE_BUFFERS", "0")
    monkeypatch.setenv("BIGSLICE_DEVICE_BUDGET_BYTES", "1234")
    ex = _ex()
    assert ex.donate_buffers is False and ex.device_budget_bytes == 1234


def _first_task(ex):
    with ex._lock:
        return next(iter(ex._task_index.values()))[1]


def test_budget_clamps_prefetch_depth():
    keys, vals = _keyed(3, 16 * 64, 29)
    oracle = {}
    for k in keys.tolist():
        oracle[k] = oracle.get(k, 0) + 1
    ex = _ex(prefetch_depth=2, device_budget_bytes=2_000)
    res = bst.Session(executor=ex).run(bst.Reduce(
        bst.Const(16, keys, np.ones(len(keys), np.int32)),
        lambda a, b: a + b))
    assert dict(res.rows()) == oracle
    assert ex.prefetch_depth == 2  # the knob stays; the group's depth clips
    t0 = _first_task(ex)
    fake = [StagedInput([torch.zeros(512, dtype=torch.int32)],
                        torch.zeros(1, dtype=torch.int32), 512, True, None)]
    assert ex._effective_prefetch_depth(t0, fake, 4) == 0
    roomy = _ex(prefetch_depth=2, device_budget_bytes=1 << 30)
    assert roomy._effective_prefetch_depth(t0, fake, 4) == 2
    assert roomy._effective_prefetch_depth(t0, fake, 2) == 1


@pytest.mark.parametrize("K", [2, 4, 8])
def test_budget_split_k_and_parity(ref_session, K):
    keys, vals = _keyed(41, 4 * 512, 300)
    want = _rows(ref_session, ref_bs.Reduce(ref_bs.Const(4, keys, vals),
                                            lambda a, b: a + b))
    ex = _ex(prefetch_depth=1)
    plain = _rows(bst.Session(executor=ex), bst.Reduce(
        bst.Const(4, keys, vals), lambda a, b: a + b))
    assert ex.split_runs == {}
    # Each map wave: capacity 512, 8 bytes a row, the hash combine's
    # table; a budget of est / K splits it into K slices.
    est = bst.MeshExecutor.wave_bytes_model(512, 8, hash_table=True)
    ex = _ex(prefetch_depth=1, device_budget_bytes=-(-est // K))
    got = _rows(bst.Session(executor=ex), bst.Reduce(
        bst.Const(4, keys, vals), lambda a, b: a + b))
    (k,) = ex.split_runs.values()
    assert k == K
    _assert_shards_equal(got, plain)
    _assert_shards_equal(got, want)


def test_split_wave_holds_one_unmerged_slice_output():
    """Each slice is folded into the running merge as it runs: when a
    slice starts, at most one earlier slice output is alive (the last,
    which IS the running merge), none after the wave; rows equal the
    unsplit run's."""
    import weakref

    keys, vals = _keyed(43, 4 * 512, 300)
    plain = _rows(bst.Session(executor=_ex(prefetch_depth=0)), bst.Reduce(
        bst.Const(4, keys, vals), lambda a, b: a + b))
    est = bst.MeshExecutor.wave_bytes_model(512, 8, hash_table=True)
    ex = _ex(prefetch_depth=0, device_budget_bytes=-(-est // 8))
    subs, alive_at_start, alive_after = None, [], []
    run_slice, run_sliced = ex._execute_wave_on, ex._execute_wave_sliced

    def execute_wave_on(tasks, wave, inputs, **kw):
        if subs is None:  # not a slice
            return run_slice(tasks, wave, inputs, **kw)
        alive_at_start.append(sum(r() is not None for r in subs))
        out = run_slice(tasks, wave, inputs, **kw)
        subs.append(weakref.ref(out))
        return out

    def execute_wave_sliced(tasks, wave, inputs, K):
        nonlocal subs
        subs = []
        try:
            out = run_sliced(tasks, wave, inputs, K)
            alive_after.append(sum(r() is not None and r() is not out
                                   for r in subs))
        finally:
            subs = None
        return out

    ex._execute_wave_on = execute_wave_on
    ex._execute_wave_sliced = execute_wave_sliced
    got = _rows(bst.Session(executor=ex), bst.Reduce(
        bst.Const(4, keys, vals), lambda a, b: a + b))
    assert list(ex.split_runs.values()) == [8]
    assert len(alive_after) == 4 and alive_after == [0] * 4
    assert len(alive_at_start) == 4 * 8 and max(alive_at_start) == 1
    _assert_shards_equal(got, plain)


@pytest.mark.parametrize("lowering", ["hash", "sort"])
def test_split_fold_holds_one_row_a_key(lowering):
    """Slices that combine nothing on their own (each key once a slice):
    the fold re-combines the running merge, so a split wave's output
    holds one row a key, as many as the unsplit wave's, by either
    lowering of the combine; rows equal the unsplit run's."""
    from bigslice_tpu_torch.exec.meshexec import DeviceGroupOutput

    keys = np.tile(np.arange(128, dtype=np.int32), 16)
    vals = np.arange(len(keys), dtype=np.int32) % 7

    def run(budget):
        ex = _ex(prefetch_depth=0, device_budget_bytes=budget)
        if lowering == "sort":
            ex._hash_combine_ops = lambda opbase, fc, decide=True: None
        rows = _rows(bst.Session(executor=ex), bst.Reduce(
            bst.Const(4, keys, vals), lambda a, b: a + b))
        (out,) = [o for o in ex._outputs.values()
                  if isinstance(o, DeviceGroupOutput) and o.partitioned]
        return rows, int(out.counts.sum()), ex

    plain, n_plain, _ = run(None)
    est = bst.MeshExecutor.wave_bytes_model(
        512, 8, hash_table=lowering == "hash", slack=1.0)
    got, n_split, ex = run(-(-est // 4))
    assert list(ex.split_runs.values()) == [4]
    assert n_split == n_plain == 4 * 128
    _assert_shards_equal(got, plain)


def test_split_declines_for_rank_sensitive_chains():
    keys = np.arange(4 * 64, dtype=np.int32) % 50
    ex = _ex(device_budget_bytes=64)
    res = bst.Session(executor=ex).run(bst.Reduce(
        bst.Head(bst.Const(4, keys, np.ones(len(keys), np.int32)), 10),
        lambda a, b: a + b))
    assert ex.split_runs == {}
    assert sum(v for _, v in res.rows()) == 40


def test_subid_split_declines_under_budget():
    keys, _ = _keyed(9, 16 * 64, 300)
    oracle = {}
    for k in keys.tolist():
        oracle[k] = oracle.get(k, 0) + 1
    for budget, declined in ((1_000, True), (None, False)):
        ex = _ex(prefetch_depth=0, device_budget_bytes=budget)
        res = bst.Session(executor=ex).run(bst.Reduce(
            bst.Const(16, keys, np.ones(len(keys), np.int32)),
            lambda a, b: a + b))
        assert dict(res.rows()) == oracle
        views = [getattr(o, "_wave_views", None)
                 for o in ex._outputs.values()]
        built = [v for v in views if v is not None]
        assert built, "no consumer asked for a subid split"
        assert all((v[1] is None) is declined for v in built)


def test_staging_error_reraises_in_wave_order():
    keys = np.arange(16 * 8, dtype=np.int32)
    ex = _ex(prefetch_depth=2)
    dispatched = []
    orig_group, orig_dispatch = ex._group_inputs, ex._dispatch_wave

    def group_inputs(tasks, wave=0):
        if wave == 5:
            raise OSError("staging failed at wave 5")
        return orig_group(tasks, wave)

    def dispatch(tasks, wave, inputs):
        dispatched.append(wave)
        return orig_dispatch(tasks, wave, inputs)

    ex._group_inputs, ex._dispatch_wave = group_inputs, dispatch
    with pytest.raises(TaskError, match="staging failed at wave 5"):
        bst.Session(executor=ex).run(bst.Reduce(
            bst.Const(16, keys, keys), lambda a, b: a + b))
    assert dispatched == [0, 1, 2, 3, 4]


def test_concurrent_pipelined_runs_on_one_executor():
    """Several runs share one executor (its arena, wave mutex and staging
    clock) from threads, with a short switch interval: every result is
    right."""
    ex = _ex(prefetch_depth=2)
    errors, results = [], {}

    def run(i):
        try:
            keys, vals = _keyed(100 + i, 16 * 32, 50)
            res = bst.Session(executor=ex).run(bst.Reduce(
                bst.Const(16, keys, vals), lambda a, b: a + b))
            oracle = {}
            for k, v in zip(keys.tolist(), vals.tolist()):
                oracle[k] = oracle.get(k, 0) + v
            results[i] = dict(res.rows()) == oracle
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert results == {i: True for i in range(6)}


def _combines(op):
    """The port's and the JAX package's combine function for ``op``."""
    import jax.numpy as jnp

    if op == "add":
        return (lambda a, b: a + b), (lambda a, b: a + b)
    return torch.maximum, jnp.maximum


@pytest.mark.parametrize("op", ["add", "max"])
def test_hash_aggregate_off_pins_the_sort_path(monkeypatch, ref_session,
                                                op):
    """hash_aggregate=False takes an add (or max) Reduce off the hash
    lowering: no K2 table is built, and the rows equal the default's
    and the JAX package's."""
    from bigslice_tpu_torch.parallel import hashagg

    calls = []
    real = hashagg.hash_aggregate

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(hashagg, "hash_aggregate", counting)
    n = 1 << 12
    keys = np.random.RandomState(5).randint(0, 300, n).astype(np.int32)
    vals = np.arange(n, dtype=np.int32)

    fn, ref_fn = _combines(op)

    def run(**kw):
        sess = bst.Session(executor=bst.MeshExecutor(
            device="cpu", auto_dense=False, **kw))
        return sorted(sess.run(bst.Reduce(bst.Const(8, keys, vals),
                                          fn)).rows())

    default = run()
    assert calls, "the default took the hash lowering"
    calls.clear()
    pinned = run(hash_aggregate=False)
    assert not calls
    want = sorted(tuple(int(x) for x in r) for r in ref_session.run(
        ref_bs.Reduce(ref_bs.Const(8, keys, vals), ref_fn)).rows())
    assert pinned == default == want


@pytest.mark.parametrize("shards", [8, 12])
def test_subid_split_off_masks_the_whole_output(ref_session, shards):
    """subid_split=False hands each consumer wave the whole
    wave-partitioned output, which its program masks by subid: no
    per-wave views are built, and the rows are the split's."""
    n = 1 << 12
    keys = np.random.RandomState(6).randint(0, 500, n).astype(np.int32)
    vals = np.arange(n, dtype=np.int32)

    def run(**kw):
        ex = bst.MeshExecutor(device="cpu", auto_dense=False, **kw)
        res = bst.Session(executor=ex).run(
            bst.Reduce(bst.Const(shards, keys, vals), lambda a, b: a + b))
        views = [o._wave_views for o in ex._outputs.values()
                 if getattr(o, "subid", False)]
        return sorted(res.rows()), views

    split, views = run()
    assert views and all(v is not None for v in views)
    whole, views = run(subid_split=False)
    assert views and all(v is None for v in views)
    want = sorted(tuple(int(x) for x in r) for r in ref_session.run(
        ref_bs.Reduce(ref_bs.Const(shards, keys, vals),
                      lambda a, b: a + b)).rows())
    assert whole == split == want
