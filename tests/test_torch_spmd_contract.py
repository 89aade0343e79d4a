"""The SPMD plane's contracts at N = 2 on the CPU, and its one-process
pieces.

- A rank whose Func registry differs makes ``initialize`` raise on
  every rank, naming the rank (``verify_registry_across_hosts``).
- A wedged rank (alive, no beats) makes its peer raise the keepalive's
  ``PeerLostError`` within the keepalive's bound, before its next
  collective.
- An infra error on one rank only is fatal on both ranks
  (``HostLostError``): the failing rank neither puts the op on
  probation nor reruns the group on its host tier alone.
- A rank that raises makes the launcher stop the gang and exit
  non-zero within its deadline; ``tools/run.py -launch`` runs a program
  on two ranks.
- A SelfAttend over 1 < S <= N shards runs on the host tier by name.
- The mesh's seams: the identity at one slot, integer wire views, the
  mesh-shape knob.
"""

import json
import os
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch import sliceconfig  # noqa: E402
from bigslice_tpu_torch.parallel import meshutil  # noqa: E402
from bigslice_tpu_torch.tools import multihost_smoke, run  # noqa: E402

DEADLINE_S = 90.0
#: The process group's timeout in the contract checks.
DIST_TIMEOUT_S = 60.0


def _smoke(mode: str, tmp_path) -> tuple:
    """multihost_smoke's ``mode`` on 2 CPU ranks: (launch result, the
    ranks' reports)."""
    out = str(tmp_path)
    cmd = [sys.executable, "-m", "bigslice_tpu_torch.tools.multihost_smoke",
           "--worker", "--out", out, "--mode", mode, "--device", "cpu"]
    env = {"BIGSLICE_KEEPALIVE_INTERVAL": "0.1",
           "BIGSLICE_KEEPALIVE_TIMEOUT": "1.0",
           "BIGSLICE_DIST_TIMEOUT": str(DIST_TIMEOUT_S)}
    res = multihost_smoke.launch(2, cmd, deadline_s=DEADLINE_S, env=env)
    reports = []
    for r in range(2):
        path = os.path.join(out, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as fh:
                reports.append(json.load(fh))
    return res, reports


def test_registry_drift_raises_on_every_rank_naming_the_rank(tmp_path):
    res, reports = _smoke("registry", tmp_path)
    assert res.rc == 0, res.stderr
    assert len(reports) == 2
    for r in reports:
        assert r["raised"] is not None
        assert "rank(s) 1 disagree with rank 0" in r["raised"]
        assert "only_on_rank_one  (only on rank 1)" in r["raised"]


def test_wedged_rank_raises_peer_lost_before_the_next_collective(tmp_path):
    res, reports = _smoke("wedge", tmp_path)
    assert res.rc == 0, res.stderr
    (r0,) = [r for r in reports if r["rank"] == 0]
    assert r0["ok"], r0
    assert "PeerLostError" in r0["raised"]
    assert "HostLostError" in r0["raised"]
    # Detected within the keepalive's bound: its timeout and a few beats.
    assert r0["detect_s"] <= 3 * r0["timeout_s"]


def test_an_infra_error_on_one_rank_is_fatal_on_both(tmp_path):
    res, reports = _smoke("infra", tmp_path)
    assert res.rc == 0, res.stderr
    r0, r1 = sorted(reports, key=lambda r: r["rank"])
    assert "HostLostError" in r1["raised"], r1
    assert "out of step" in r1["raised"]
    assert "InjectedInfraError" in r1["raised"]
    assert r1["probation"] == {} and r0["probation"] == {}
    # Rank 0 waited in the group's collectives for rank 1, which never
    # came: it fails once rank 1 has gone, well before the group's
    # timeout.
    assert "HostLostError" in r0["raised"], r0
    assert r0["seconds"] < 0.5 * DIST_TIMEOUT_S


def test_a_rank_that_raises_ends_the_gang_within_the_deadline(tmp_path):
    res, _ = _smoke("fail", tmp_path)
    assert res.rc != 0 and not res.timed_out
    assert res.seconds < DEADLINE_S
    assert "rank 1 fails on purpose" in res.stderr[1]
    # The surviving rank, parked in a collective, was stopped.
    assert res.rcs[0] != 0


def test_run_launch_runs_a_program_on_two_ranks(tmp_path, capfd):
    prog = tmp_path / "prog.py"
    prog.write_text(textwrap.dedent("""
        import numpy as np
        import bigslice_tpu_torch as bs
        from bigslice_tpu_torch import sliceconfig
        from bigslice_tpu_torch.exec import spmd
        sess = sliceconfig.current_session()
        keys = np.arange(4000, dtype=np.int32) % 37
        res = sess.run(bs.Reduce(bs.Const(4, keys, np.ones(4000, np.int32)),
                                 lambda a, b: a + b))
        rows = dict(res.rows())
        assert rows == {k: int((keys == k).sum()) for k in range(37)}
        assert sess.executor.nmesh == 2
        if spmd.is_coordinator():
            print("ROWS", len(rows))
    """))
    rc = run.main(["-launch", "2", "-deadline", str(DEADLINE_S),
                   "-device", "cpu", str(prog)])
    out = capfd.readouterr().out
    assert rc == 0
    assert out.count("ROWS 37") == 1
    bad = tmp_path / "bad.py"
    bad.write_text("raise SystemExit(3)\n")
    assert run.main(["-launch", "2", "-deadline", str(DEADLINE_S),
                     "-device", "cpu", str(bad)]) == 3


class _TwoSlots(meshutil.Mesh):
    """A two-slot mesh that issues nothing: enough for the executor's
    compile-time rules."""

    def __init__(self):
        super().__init__(None, "cpu")
        self.size, self.rank, self.backend = 2, 0, "gloo"


def test_selfattend_over_the_slots_runs_on_the_host_tier_by_name():
    """A SelfAttend over S <= N shards runs on the device over the ranks
    (the ring's rotation or Ulysses' all_to_alls), as on the JAX
    package's N-device mesh; S > N stays on the host tier by the JAX
    package's own rule (one program spans the whole sequence), at one
    slot as over two."""
    from bigslice_tpu_torch.exec import compile as compile_mod

    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(16, 4).astype(np.float32) for _ in "qkv")

    def attend_task(shards):
        tasks = compile_mod.Compiler(1).compile(
            bst.SelfAttend(bst.Const(shards, q, k, v), causal=True))
        return tasks[0]

    two = bst.MeshExecutor(mesh=_TwoSlots())
    assert two.multiprocess and two.ordered_dispatch
    assert two._eligible(attend_task(2)) and two._eligible(attend_task(1))
    assert not two._eligible(attend_task(3))
    one = bst.MeshExecutor(device="cpu")
    assert one._eligible(attend_task(1))
    assert not one._eligible(attend_task(2))


def test_one_slot_seams_are_the_identity_and_wire_views_keep_bits():
    mesh = meshutil.Mesh(None, "cpu")
    x = torch.arange(6, dtype=torch.int32).reshape(1, 6)
    assert mesh.all_to_all(x) is x
    assert mesh.psum(x) is x and mesh.pmax_host([3]) == [3]
    assert mesh.all_gather([1, 2]) == [[1, 2]]
    assert mesh.all_gather_object("a") == ["a"]
    assert meshutil.all_to_all(x, 1) is x
    assert mesh.collectives == {}
    with pytest.raises(RuntimeError, match="built for 2 slots"):
        meshutil.all_to_all(torch.zeros(2, 3), 2)
    u = torch.tensor([0, 2**32 - 1], dtype=torch.int64).to(torch.uint32)
    wire = meshutil._WIRE[u.dtype]
    assert torch.equal(u.view(wire).view(torch.uint32), u)
    b = torch.tensor([True, False])
    assert torch.equal(b.view(meshutil._WIRE[b.dtype]).view(torch.bool), b)


@pytest.mark.parametrize("spec", ["", "1x4", "4x1"])
def test_mesh_shape_knob_one_axis(monkeypatch, spec):
    """A 1-D shape (or none) passes the check: the mesh is every
    rank's."""
    monkeypatch.setenv("BIGSLICE_MESH_SHAPE", spec)
    shape = meshutil.mesh_shape_from_env()
    assert shape is None or 1 in shape


def test_mesh_shape_knob_refuses_two_axes_and_typos(monkeypatch):
    """A 2-D shape parses as the JAX package's parser reads it and
    builds the grid over the ranks (``tests/test_torch_hier.py``); one
    that does not cover them (2x4 over this one process) and a typo
    raise ``ValueError``."""
    from bigslice_tpu.parallel import meshutil as ref_meshutil
    from bigslice_tpu_torch.utils import distributed

    monkeypatch.setenv("BIGSLICE_MESH_SHAPE", "2x4")
    assert meshutil.mesh_shape_from_env() == \
        ref_meshutil.mesh_shape_from_env() == (2, 4)
    monkeypatch.setattr(distributed, "_mesh", None)
    with pytest.raises(ValueError, match="does not cover 1 rank"):
        distributed.global_mesh()
    monkeypatch.setenv("BIGSLICE_MESH_SHAPE", "2by4")
    with pytest.raises(ValueError, match="expected DxI"):
        meshutil.mesh_shape_from_env()


def test_sliceconfig_builds_the_configured_executor(monkeypatch, tmp_path):
    monkeypatch.setattr(sliceconfig, "CONFIG_PATH",
                        str(tmp_path / "config"))
    sess, rest = sliceconfig.parse(["-local", "-device", "cpu", "prog.py"])
    assert isinstance(sess.executor, bst.LocalExecutor) and rest == [
        "prog.py"]
    sess.shutdown()
    sliceconfig.write_profile({"device": "cpu", "parallelism": 2})
    sess, _ = sliceconfig.parse([])
    assert isinstance(sess.executor, bst.MeshExecutor)
    assert sess.executor.device.type == "cpu"
    sess.shutdown()
