"""Elastic resize and the elastic session against the JAX package's.

The reference's eight cases of ``tests/test_elastic.py``, mapped onto
what one process of the port has: one-slot meshes
(``meshutil.Mesh(None, "cpu")``) and a lossy executor whose device
groups raise a gang loss. A resize salvages committed outputs to the
host and marks the unreachable ones LOST; an elastic ``Session``
recovers from a ``HostLostError`` or an injected ``peer.lost`` on the
provider's mesh. The rows equal the JAX package's for the same input.
(Over ranks, where the default provider gives None, the session
re-raises: ``tests/test_torch_hier.py``.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.exec.session import Session as RefSession  # noqa: E402

import bigslice_tpu_torch as bs  # noqa: E402
from bigslice_tpu_torch.exec.meshexec import (HostLostError,  # noqa: E402
                                              MeshExecutor)
from bigslice_tpu_torch.exec.session import Session  # noqa: E402
from bigslice_tpu_torch.exec.task import TaskState  # noqa: E402
from bigslice_tpu_torch.parallel import meshutil  # noqa: E402
from bigslice_tpu_torch.utils import faultinject  # noqa: E402


def one_slot():
    return meshutil.Mesh(None, device="cpu")


def keyed_input(n=800, nkeys=40, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, nkeys, n).astype(np.int32),
            rng.randint(0, 10, n).astype(np.int32))


def reference(keys, vals, shards=8):
    """The JAX package's rows of the same Reduce."""
    sess = RefSession()
    try:
        return dict(sess.run(ref_bs.Reduce(ref_bs.Const(shards, keys, vals),
                                           lambda a, b: a + b)).rows())
    finally:
        sess.shutdown()


def _reduce(keys, vals, shards=8):
    return bs.Reduce(bs.Const(shards, keys, vals), lambda a, b: a + b)


def test_resize_shrink_salvages_results_and_reengages_device():
    keys, vals = keyed_input()
    sess = Session(executor=MeshExecutor(device="cpu"))
    res1 = sess.run(_reduce(keys, vals))
    assert sess.executor.device_group_count() >= 1
    lost = sess.executor.resize(one_slot())
    assert lost == []  # every output reachable: salvaged, none LOST
    assert sess.executor.nmesh == 1
    assert dict(res1.rows()) == reference(keys, vals)
    before = sess.executor.device_group_count()
    keys2, vals2 = keyed_input(seed=1)
    res2 = sess.run(_reduce(keys2, vals2))
    assert dict(res2.rows()) == reference(keys2, vals2)
    assert sess.executor.device_group_count() > before


def test_resize_grow():
    """One process has one slot to grow to: a resize onto a fresh mesh
    keeps the results readable, and a graph of more shards than slots
    still runs in waves."""
    keys, vals = keyed_input()
    sess = Session(executor=MeshExecutor(device="cpu"))
    res1 = sess.run(_reduce(keys, vals, shards=2))
    mesh = one_slot()
    sess.executor.resize(mesh)
    assert sess.executor.mesh is mesh
    assert dict(res1.rows()) == reference(keys, vals, 2)
    keys2, vals2 = keyed_input(seed=2)
    res2 = sess.run(_reduce(keys2, vals2))
    assert dict(res2.rows()) == reference(keys2, vals2)
    with pytest.raises(ValueError, match="not this executor's"):
        sess.executor.resize(meshutil.Mesh(None, device="meta"))


def test_resize_unsalvageable_outputs_marked_lost_and_recomputed():
    keys, vals = keyed_input()
    sess = Session(executor=MeshExecutor(device="cpu"))
    res = sess.run(_reduce(keys, vals))
    ex = sess.executor
    with ex._lock:
        for out in ex._outputs.values():
            for w in getattr(out, "waves", None) or [out]:
                w._chunks = None

                def boom(self=w):
                    raise RuntimeError("device gone")

                w.host_chunks = boom
    lost = ex.resize(one_slot())
    assert lost and all(t.state == TaskState.LOST for t in lost)
    # Reading the old Result re-evaluates the lost producers.
    assert dict(res.rows()) == reference(keys, vals)


class _LossyExecutor(MeshExecutor):
    """Raises a gang loss from device group launches ``fail_from`` ..
    ``fail_from + fail_times - 1`` (0-based)."""

    def __init__(self, fail_times=1, fail_from=0):
        super().__init__(device="cpu")
        self.fail_times = fail_times
        self.fail_from = fail_from
        self.launches = 0
        self.resize_calls = []

    def _execute_group(self, key, tasks):
        i = self.launches
        self.launches += 1
        if self.fail_from <= i < self.fail_from + self.fail_times:
            raise HostLostError("peer process lost (simulated)")
        return super()._execute_group(key, tasks)

    def resize(self, mesh):
        self.resize_calls.append(mesh.size)
        return super().resize(mesh)


def test_elastic_session_recovers_from_gang_loss(monkeypatch):
    monkeypatch.setenv("BIGSLICE_ELASTIC_BACKOFF", "0.01")
    keys, vals = keyed_input()
    ex = _LossyExecutor(fail_times=1)
    events = []
    sess = Session(executor=ex, elastic=2, mesh_provider=one_slot,
                   eventer=lambda name, **f: events.append(name))
    res = sess.run(_reduce(keys, vals))
    assert dict(res.rows()) == reference(keys, vals)
    assert ex.resize_calls == [1]
    assert ex.device_group_count() >= 1
    assert "bigslice:elasticRetry" in events
    assert "bigslice:elasticBackoff" in events


def test_elastic_recovery_after_partial_completion(monkeypatch):
    """A loss after the first group completed: its salvaged output feeds
    the retry from the host, never zero-copy."""
    monkeypatch.setenv("BIGSLICE_ELASTIC_BACKOFF", "0")
    keys, vals = keyed_input()
    ex = _LossyExecutor(fail_times=1, fail_from=1)
    sess = Session(executor=ex, elastic=1, mesh_provider=one_slot)
    res = sess.run(_reduce(keys, vals))
    assert dict(res.rows()) == reference(keys, vals)
    assert ex.resize_calls == [1]
    assert ex.launches >= 2


def test_elastic_exhausted_reraises(monkeypatch):
    monkeypatch.setenv("BIGSLICE_ELASTIC_BACKOFF", "0")
    keys, vals = keyed_input()
    ex = _LossyExecutor(fail_times=10)
    sess = Session(executor=ex, elastic=2, mesh_provider=one_slot)
    with pytest.raises(Exception) as ei:
        sess.run(_reduce(keys, vals))
    assert "peer process lost" in repr(ei.value)
    assert len(ex.resize_calls) == 2  # exactly ``elastic`` retries


def test_non_gang_errors_do_not_trigger_elastic_retry():
    def bad(x):
        raise ValueError("app bug")

    ex = _LossyExecutor(fail_times=0)
    sess = Session(executor=ex, elastic=3, mesh_provider=one_slot)
    with pytest.raises(Exception) as ei:
        sess.run(bs.Map(bs.Const(4, np.arange(8, dtype=np.int32)), bad,
                        out=[np.int32]))
    assert "app bug" in repr(ei.value)
    assert ex.resize_calls == []


def test_elastic_default_mesh_provider_recovers(monkeypatch):
    """No provider given: the default probes this process's device and
    gives its one-slot mesh."""
    monkeypatch.setenv("BIGSLICE_ELASTIC_BACKOFF", "0")
    keys, vals = keyed_input()
    ex = _LossyExecutor(fail_times=1)
    sess = Session(executor=ex, elastic=2)
    res = sess.run(_reduce(keys, vals))
    assert dict(res.rows()) == reference(keys, vals)
    assert ex.resize_calls == [1]
    assert ex.mesh.device == torch.device("cpu")


class _CudaExecutor:
    """An executor on ``cuda`` with nothing to run: what the session
    hands its default provider."""

    device = torch.device("cuda")
    name = "cuda-stub"

    def resize(self, mesh):
        raise AssertionError("no mesh may be offered here")


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_default_provider_never_offers_a_cuda_executor_the_cpu(
        monkeypatch, device):
    """The default provider probes the executor's own device: for an
    executor on ``cuda`` with no card it gives None (the session then
    re-raises the loss), never a CPU mesh; an executor on the CPU still
    gets its CPU mesh."""
    from bigslice_tpu_torch.utils import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert distributed.default_mesh_provider(device=device)() is None
    cpu = distributed.default_mesh_provider(device="cpu")()
    assert cpu is not None and cpu.device == torch.device("cpu")
    ex = _CudaExecutor()
    ex.device = torch.device(device)
    sess = Session(executor=ex, elastic=1)
    assert sess.mesh_provider() is None
    # With no device given, the provider's default is the card, not the
    # CPU.
    assert distributed.default_mesh_provider()() is None


def test_injected_peer_lost_recovers_elastically(monkeypatch):
    """tests/test_chaos.py::test_mesh_injected_host_loss_elastic with the
    keepalive's site: ``peer.lost`` fires its ``PeerLostError`` before a
    group in one process (seed 0 at rate 0.5: the second group, the
    reduce side, once), and the elastic session re-runs the lost group
    over the map side's output salvaged to the host."""
    monkeypatch.setenv("BIGSLICE_ELASTIC_BACKOFF", "0")
    keys, vals = keyed_input()
    plan = faultinject.install(faultinject.parse_plan("0:peer.lost=0.5x1"))
    try:
        ex = MeshExecutor(device="cpu")
        sess = Session(executor=ex, elastic=1)
        res = sess.run(_reduce(keys, vals))
        assert dict(res.rows()) == reference(keys, vals)
    finally:
        faultinject.clear()
    snap = plan.snapshot()
    assert snap["injected"] == {"peer.lost": 1}
    assert snap["log"][0]["inv_id"] == 1
    # Three checks: the map group, the lost reduce group, its rerun; the
    # lost attempt never launched.
    assert snap["calls"]["peer.lost"] == 3
    assert ex.device_group_count() == 2
