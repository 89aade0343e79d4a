"""The port's out-of-core spill exchange (``exec/shuffleplan.py`` and
``MeshExecutor``'s spill path) on the CPU, mirroring the JAX package's
``tests/test_spill_shuffle.py`` (without mesh resize and the 2-D
hierarchy, which the port does not have).

``BIGSLICE_SHUFFLE`` unset plans nothing; ``spill`` spills every
shuffle boundary; ``auto`` spills exactly when the staged-input estimate
exceeds the spill budget. Spilled runs of a Reduce, a GroupByKey and a
join (both sides spilled) equal the in-program run and the JAX
package's, per output shard and exactly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.exec import shuffleplan  # noqa: E402
from bigslice_tpu_torch.exec import store as store_mod  # noqa: E402


def _add(a, b):
    return a + b


def _keyed(rows=4000, nkeys=251, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, nkeys, rows).astype(np.int32),
            rng.randint(0, 50, rows).astype(np.int32))


@pytest.fixture(autouse=True)
def _no_shuffle_env(monkeypatch):
    monkeypatch.delenv("BIGSLICE_SHUFFLE", raising=False)
    monkeypatch.delenv("BIGSLICE_SPILL_BUDGET_BYTES", raising=False)
    monkeypatch.delenv("BIGSLICE_SPILL_DIR", raising=False)


@pytest.fixture(scope="module")
def ref_session():
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    mesh = Mesh(np.array(jax.devices()[:8]), ("shards",))
    return Session(executor=MeshExecutor(mesh, auto_dense=False,
                                         hash_aggregate=True))


def _run(monkeypatch, make, mode=None, **ex):
    if mode is None:
        monkeypatch.delenv("BIGSLICE_SHUFFLE", raising=False)
    else:
        monkeypatch.setenv("BIGSLICE_SHUFFLE", mode)
    executor = bst.MeshExecutor(device="cpu", **ex)
    sess = bst.Session(executor=executor)
    rows = bst.result_shard_rows(sess.run(make(bst)))
    return rows, executor, sess


def _assert_shards_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            assert gc.dtype == wc.dtype and gc.shape == wc.shape
            assert gc.tobytes() == wc.tobytes()


def _spilled(ex):
    return [o for o in ex._outputs.values()
            if isinstance(o, shuffleplan.SpilledGroupOutput)]


# -- planner units --------------------------------------------------------


def test_plan_mode_parses_and_rejects(monkeypatch):
    assert shuffleplan.plan_mode() is None
    for m in shuffleplan.MODES:
        monkeypatch.setenv("BIGSLICE_SHUFFLE", m)
        assert shuffleplan.plan_mode() == m
    monkeypatch.setenv("BIGSLICE_SHUFFLE", "bogus")
    with pytest.raises(ValueError, match="BIGSLICE_SHUFFLE"):
        shuffleplan.plan_mode()
    assert shuffleplan.plan_mode(" spill ") == "spill"


def test_choose_knob_forcing():
    assert shuffleplan.choose(None, None, None) is None
    plan = shuffleplan.choose("spill", None, None)
    assert (plan.kind, plan.reason) == ("spill", "forced")
    assert shuffleplan.choose("in_program", 10, 1).kind == "in_program"
    plan = shuffleplan.choose("spill", None, None,
                              ineligible="machine-combiner buffer")
    assert plan.kind == "in_program" and "machine-combiner" in plan.reason


def test_choose_budget_thresholds():
    over = shuffleplan.choose("auto", est_bytes=200, budget_bytes=100)
    assert (over.kind, over.reason) == ("spill", "estimate")
    under = shuffleplan.choose("auto", est_bytes=50, budget_bytes=100)
    assert (under.kind, under.reason) == ("in_program", "estimate")
    assert shuffleplan.choose("auto", None, None).reason == "no-budget"
    assert shuffleplan.choose("auto", 1 << 40, None).kind == "in_program"


def test_spill_budget_sources(monkeypatch):
    monkeypatch.setenv("BIGSLICE_SPILL_BUDGET_BYTES", "12345")
    assert shuffleplan.spill_budget_bytes(100, 8) == 12345
    monkeypatch.delenv("BIGSLICE_SPILL_BUDGET_BYTES")
    assert shuffleplan.spill_budget_bytes() is None
    assert shuffleplan.spill_budget_bytes(100, nmesh=8) == 800


def test_spill_ineligible_reads_the_stamp_and_the_combiner():
    class P:
        combine_key = None

    class T:
        partitioner = P()
        spill_ineligible = None

    assert shuffleplan.spill_ineligible(T()) is None
    T.partitioner.combine_key = "k"
    assert "machine-combiner" in shuffleplan.spill_ineligible(T())
    T.spill_ineligible = "stamped"
    assert shuffleplan.spill_ineligible(T()) == "stamped"


def test_compiler_stamps_the_frozen_knob(monkeypatch):
    keys, vals = _keyed(400)
    monkeypatch.setenv("BIGSLICE_SHUFFLE", "spill")
    sess = bst.Session(executor=bst.MeshExecutor(device="cpu"))
    res = sess.run(bst.Reduce(bst.Const(4, keys, vals), _add))
    from bigslice_tpu_torch.exec.task import iter_tasks

    tasks = iter_tasks(res.tasks)
    assert {t.shuffle_mode for t in tasks} == {"spill"}
    assert {t.spill_ineligible for t in tasks} == {None}
    sess.shutdown()


# -- parity: spill vs in-program vs the JAX package -------------------------


def test_reduce_spill_parity_waved_subid(monkeypatch, ref_session):
    """16 shards on one device: every boundary is wave-partitioned
    (subid routing) over 16 map waves."""
    keys, vals = _keyed()
    want = bst.result_shard_rows(ref_session.run(
        ref_bs.Reduce(ref_bs.Const(16, keys, vals), _add)))

    def make(bs):
        return bs.Reduce(bs.Const(16, keys, vals), _add)

    mem, ex0, _ = _run(monkeypatch, make)
    assert ex0.shuffle_plans == {} and not _spilled(ex0)
    spill, ex, sess = _run(monkeypatch, make, mode="spill")
    _assert_shards_equal(spill, mem)
    _assert_shards_equal(spill, want)
    (out,) = _spilled(ex)
    assert out.map_waves == 16 and out.sub_waves == 16
    assert out.exchange.spill_bytes > 0
    assert out.exchange.spill_rows == sum(out.exchange.partition_rows())
    assert out.exchange.partitions_written() == 16
    assert {p.kind for p in ex.shuffle_plans.values()} == {"spill"}
    sess.shutdown()


@pytest.mark.parametrize("prefetch,arena", [(0, True), (2, False)])
def test_reduce_spill_parity_across_pipeline_knobs(monkeypatch, prefetch,
                                                   arena):
    keys, vals = _keyed(3000)

    def make(bs):
        return bs.Reduce(bs.Const(16, keys, vals), _add)

    mem, _, _ = _run(monkeypatch, make)
    spill, ex, sess = _run(monkeypatch, make, mode="spill",
                           prefetch_depth=prefetch, staging_arena=arena)
    _assert_shards_equal(spill, mem)
    sess.shutdown()


def test_groupby_spill_parity(monkeypatch, ref_session):
    keys, vals = _keyed(2000, nkeys=17)
    want = bst.result_shard_rows(ref_session.run(
        ref_bs.GroupByKey(ref_bs.Const(8, keys, vals), capacity=256)))

    def make(bs):
        return bs.GroupByKey(bs.Const(8, keys, vals), capacity=256)

    mem, _, _ = _run(monkeypatch, make)
    spill, ex, sess = _run(monkeypatch, make, mode="spill")
    _assert_shards_equal(spill, mem)
    _assert_shards_equal(spill, want)
    assert len(_spilled(ex)) == 1
    sess.shutdown()


def test_join_spill_parity_both_sides(monkeypatch, ref_session):
    ak, av = _keyed(3000)
    bk, bv = _keyed(3000, seed=11)
    want = bst.result_shard_rows(ref_session.run(ref_bs.JoinAggregate(
        ref_bs.Const(16, ak, av), ref_bs.Const(16, bk, bv), _add, _add)))

    def make(bs):
        return bs.JoinAggregate(bs.Const(16, ak, av), bs.Const(16, bk, bv),
                                _add, _add)

    mem, _, _ = _run(monkeypatch, make)
    spill, ex, sess = _run(monkeypatch, make, mode="spill")
    _assert_shards_equal(spill, mem)
    _assert_shards_equal(spill, want)
    assert len(_spilled(ex)) == 2  # both input boundaries spilled
    sess.shutdown()


def test_unset_knob_plans_nothing(monkeypatch):
    keys, vals = _keyed(2000)
    _, ex, sess = _run(monkeypatch,
                       lambda bs: bs.Reduce(bs.Const(16, keys, vals), _add))
    assert ex.shuffle_plans == {} and ex._spill is None
    sess.shutdown()


# -- auto: estimate against budget ------------------------------------------


def test_auto_spills_under_a_tight_budget(monkeypatch):
    keys, vals = _keyed()

    def make(bs):
        return bs.Reduce(bs.Const(16, keys, vals), _add)

    mem, _, _ = _run(monkeypatch, make)
    monkeypatch.setenv("BIGSLICE_SPILL_BUDGET_BYTES", "8000")
    spill, ex, sess = _run(monkeypatch, make, mode="auto")
    _assert_shards_equal(spill, mem)
    (out,) = _spilled(ex)
    assert out.plan.reason == "estimate"
    assert out.plan.est_bytes > out.plan.budget_bytes == 8000
    sess.shutdown()


def test_auto_stays_in_program_under_a_loose_budget(monkeypatch):
    keys, vals = _keyed(2000)

    def make(bs):
        return bs.Reduce(bs.Const(16, keys, vals), _add)

    mem, _, _ = _run(monkeypatch, make)
    monkeypatch.setenv("BIGSLICE_SPILL_BUDGET_BYTES", str(1 << 40))
    rows, ex, sess = _run(monkeypatch, make, mode="auto")
    _assert_shards_equal(rows, mem)
    assert not _spilled(ex)
    assert {p.kind for p in ex.shuffle_plans.values()} == {"in_program"}
    sess.shutdown()


def test_auto_budget_from_device_budget(monkeypatch):
    keys, vals = _keyed(2000)
    _, ex, sess = _run(monkeypatch,
                       lambda bs: bs.Reduce(bs.Const(16, keys, vals), _add),
                       mode="auto", device_budget_bytes=100)
    assert _spilled(ex)
    assert {p.budget_bytes for p in ex.shuffle_plans.values()} == {100}
    sess.shutdown()


# -- spill mechanics ------------------------------------------------------


def test_spill_prefetch_warms_partitions(monkeypatch):
    """The consumer's prefetcher hints the spilled partitions of the
    waves ahead into the spill store's warm cache."""
    keys, vals = _keyed()
    warmed = []
    orig = store_mod.FileStore.prefetch

    def spy(self, name, partition):
        warmed.append((name.op, partition))
        return orig(self, name, partition)

    monkeypatch.setattr(store_mod.FileStore, "prefetch", spy)
    rows, ex, sess = _run(monkeypatch,
                          lambda bs: bs.Reduce(bs.Const(16, keys, vals), _add),
                          mode="spill", prefetch_depth=1)
    assert rows
    assert [w for w in warmed if "~spill" in w[0]]
    sess.shutdown()


def test_spill_entries_discard_and_tmp_cleanup(monkeypatch):
    keys, vals = _keyed(2000)
    rows, ex, sess = _run(monkeypatch,
                          lambda bs: bs.Reduce(bs.Const(8, keys, vals), _add),
                          mode="spill")
    tmp = ex._spill_tmp
    assert tmp and os.path.isdir(tmp)
    assert [p for p, _, files in os.walk(tmp) if files]
    producer = next(t for (_, t) in ex._task_index.values()
                    if isinstance(ex._outputs.get(t.group_key),
                                  shuffleplan.SpilledGroupOutput))
    ex.discard(producer)
    assert not [p for p, _, files in os.walk(tmp) if files]
    sess.shutdown()
    assert not os.path.isdir(tmp)  # close() removes the temp dir


def test_named_spill_dir_is_kept(monkeypatch, tmp_path):
    monkeypatch.setenv("BIGSLICE_SPILL_DIR", str(tmp_path / "spill"))
    keys, vals = _keyed(1000)
    _, ex, sess = _run(monkeypatch,
                       lambda bs: bs.Reduce(bs.Const(4, keys, vals), _add),
                       mode="spill")
    assert ex._spill_tmp is None
    sess.shutdown()
    assert (tmp_path / "spill").is_dir()


def test_lost_spill_entry_reruns_the_group(monkeypatch):
    """A spilled partition lost between the map and the reduce side
    surfaces as Missing tagged spilled_group, and the producer group
    re-runs (rewriting its entries): the result is still right."""
    keys, vals = _keyed(2000)
    oracle = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        oracle[k] = oracle.get(k, 0) + v
    monkeypatch.setenv("BIGSLICE_SHUFFLE", "spill")
    ex = bst.MeshExecutor(device="cpu", prefetch_depth=0)
    orig = shuffleplan.SpillExchange.read_partition
    lost = []

    def lose_once(self, partition):
        if not lost:
            lost.append(partition)
            self.store.drop(self.names[0], partition)
        return orig(self, partition)

    monkeypatch.setattr(shuffleplan.SpillExchange, "read_partition",
                        lose_once)
    sess = bst.Session(executor=ex)
    res = sess.run(bst.Reduce(bst.Const(4, keys, vals), _add))
    assert dict(res.rows()) == oracle
    assert lost
    sess.shutdown()


def test_spill_exchange_on_a_memory_url_base(monkeypatch, ref_session):
    """BIGSLICE_SPILL_DIR=memory://...: the exchange spills through a
    FileStore on the URL, the shards equal the in-program run and the
    JAX package's, a discard retires the entries, and close() leaves the
    operator-named base alone (no private temp directory)."""
    fsspec = pytest.importorskip("fsspec")
    name = f"torch-spill-{os.getpid()}"
    monkeypatch.setenv("BIGSLICE_SPILL_DIR", f"memory://{name}")
    keys, vals = _keyed()
    want = bst.result_shard_rows(ref_session.run(
        ref_bs.Reduce(ref_bs.Const(8, keys, vals), _add)))

    def make(bs):
        return bs.Reduce(bs.Const(8, keys, vals), _add)

    mem, _, _ = _run(monkeypatch, make)
    spill, ex, sess = _run(monkeypatch, make, mode="spill")
    _assert_shards_equal(spill, mem)
    _assert_shards_equal(spill, want)
    (out,) = _spilled(ex)
    assert out.exchange.spill_bytes > 0
    assert ex._spill_tmp is None
    assert ex._spill_store().prefix == f"memory://{name}"
    fs = fsspec.filesystem("memory")
    assert fs.find(f"/{name}")
    producer = next(t for (_, t) in ex._task_index.values()
                    if isinstance(ex._outputs.get(t.group_key),
                                  shuffleplan.SpilledGroupOutput))
    ex.discard(producer)
    assert fs.find(f"/{name}") == []
    sess.shutdown()
    assert ex._spill_tmp is None
    if fs.exists(f"/{name}"):
        fs.rm(f"/{name}", recursive=True)


def test_lost_spill_entry_on_a_memory_url_reruns_the_group(monkeypatch):
    keys, vals = _keyed(2000)
    oracle = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        oracle[k] = oracle.get(k, 0) + v
    monkeypatch.setenv("BIGSLICE_SHUFFLE", "spill")
    monkeypatch.setenv("BIGSLICE_SPILL_DIR",
                       f"memory://torch-spill-lost-{os.getpid()}")
    orig = shuffleplan.SpillExchange.read_partition
    lost = []

    def lose_once(self, partition):
        if not lost:
            lost.append(partition)
            self.store.drop(self.names[0], partition)
        return orig(self, partition)

    monkeypatch.setattr(shuffleplan.SpillExchange, "read_partition",
                        lose_once)
    sess = bst.Session(executor=bst.MeshExecutor(device="cpu",
                                                 prefetch_depth=0))
    assert dict(sess.run(bst.Reduce(bst.Const(4, keys, vals),
                                    _add)).rows()) == oracle
    assert lost
    sess.shutdown()
