"""The device executor over 2 ranks on the CPU, against the JAX package.

Two gloo ranks (``tools/multihost_smoke.launch``) run every scenario of
``torch_spmd_scenarios`` through ``spmd_session`` as registered Funcs;
the JAX package's ``MeshExecutor`` runs the same pipelines over a
2-device CPU mesh. Each scenario's per-shard rows must be equal, exact
for integers and within ``RTOL`` for float sums (``PERF.md`` §1), on
every rank. ``test_torch_spmd4.py`` runs the same at 4 ranks.
"""

import concurrent.futures
import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bigslice_tpu as ref_bs  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.tools import multihost_smoke  # noqa: E402

import torch_spmd_scenarios as scen  # noqa: E402

#: Float sums combine in another order on another mesh layout.
RTOL, ATOL = 1e-5, 1e-4
#: The deadline of a world's launch: no test can hang the suite.
DEADLINE_S = 150.0
NAMES = sorted(scen.SCENARIOS) + sorted(scen.ATTEND) + ["reuse"]
#: The issue's core scenarios, which ``test_torch_spmd4.py`` repeats at
#: 4 ranks (the rest mirror the JAX package's own multi-device cases of
#: tests/test_meshexec.py, at 2).
CORE = sorted(["reduce-k2", "reduce-sort", "reshuffle", "repartition",
               "reduce-padded", "reduce-dense", "join", "groupby", "fold",
               "cogroup", "host-to-mesh", "mesh-to-host", "hash-overflow",
               "reuse"])


def launch_world(n: int, tmp_path_factory, names) -> dict:
    """Run the scenarios ``names`` on ``n`` gloo ranks while this
    process computes the JAX package's rows for them: ``{"ranks": each
    rank's results, "want": name -> the reference's rows}``."""
    out = str(tmp_path_factory.mktemp(f"spmd{n}"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        launched = pool.submit(
            multihost_smoke.launch, n,
            [sys.executable, os.path.join(os.path.dirname(__file__),
                                          "torch_spmd_scenarios.py"), out,
             *names],
            deadline_s=DEADLINE_S,
            env={"PYTHONPATH": repo, "OMP_NUM_THREADS": "1"})
        want = {name: reference_rows(n, name) for name in names}
        res = launched.result()
    assert res.rc == 0, "\n".join(res.stderr)
    ranks = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            ranks.append(pickle.load(fh))
    return {"ranks": ranks, "want": want}


def reference_rows(n: int, name: str):
    """The JAX package's MeshExecutor over an n-device CPU mesh."""
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    sess = Session(executor=MeshExecutor(
        Mesh(np.array(jax.devices()[:n]), ("shards",))))
    try:
        if name == "reuse":
            res = scen.reuse(ref_bs, jnp, n, sess.run)
        elif name in scen.ATTEND:
            res = sess.run(scen.ATTEND[name](ref_bs, n))
        else:
            res = sess.run(scen.SCENARIOS[name](ref_bs, jnp, n))
        return bst.result_shard_rows(res)
    finally:
        sess.shutdown()


def assert_same_shards(got, want, float_tol=(RTOL, ATOL)):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [c.dtype for c in g] == [c.dtype for c in w]
        for gc, wc in zip(g, w):
            if gc.dtype == np.dtype(object):
                assert list(map(repr, gc)) == list(map(repr, wc))
            elif gc.dtype.kind == "f":
                np.testing.assert_allclose(gc, wc, rtol=float_tol[0],
                                           atol=float_tol[1])
            else:
                np.testing.assert_array_equal(gc, wc)


def check_parity(world: dict, name: str) -> None:
    """Every rank's rows equal the JAX package's at n devices. The
    attend stage runs on the device over the ranks (the ring's K/V
    rotation, or Ulysses' two all_to_alls): each shard's rows within the
    reference tests' 3e-4."""
    ranks, want = world["ranks"], world["want"][name]
    assert not ranks[0]["errors"], ranks[0]["errors"]
    for r in ranks:
        if name in scen.ATTEND:
            assert_same_shards(r["rows"][name], want, (3e-4, 3e-4))
        else:
            assert_same_shards(r["rows"][name], want)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return launch_world(2, tmp_path_factory, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_two_ranks_match_the_jax_packages_two_device_mesh(world, name):
    check_parity(world, name)


def test_ranks_agree_and_stay_free_of_jax(world):
    """Every rank saw the same overflow verdicts (the hash-overflow
    scenario's table overflowed on one slot only, and both ranks put
    the site on the sort path), built the same Cogroup width, ran
    collectives over gloo, imported neither JAX package, and ran the
    attend stage on the device both ways (the ring's rotation counted
    as ``ppermute``)."""
    r0, r1 = world["ranks"]
    assert r0["hash_off"] == r1["hash_off"]
    assert r0["hash_off"]["hash-overflow"]
    assert not any(v for k, v in r0["hash_off"].items()
                   if k != "hash-overflow")
    assert r0["cogroup_caps"] == r1["cogroup_caps"]
    for r in world["ranks"]:
        assert r["modules"] == []
        assert r["backend"] == "gloo" and r["nmesh"] == 2
        assert r["collectives"]["all_to_all"] > 0
        assert r["collectives"]["ppermute"] > 0
        assert set(r["attend_methods"].values()) == {"ring", "ulysses"}


def test_one_slot_issues_no_collective():
    """At N = 1 every seam is the identity: a Reduce with a shuffle
    through the default executor counts no collective."""
    ex = bst.MeshExecutor(device="cpu")
    keys, vals = scen._data(30)
    res = bst.Session(executor=ex).run(
        bst.Reduce(bst.Const(4, keys, vals), lambda a, b: a + b))
    assert len(res.rows()) == 300
    assert ex.nmesh == 1 and not ex.multiprocess
    assert ex.mesh.collectives == {} and ex.mesh.exchanged_bytes == 0
    assert ex.mesh.backend is None and ex.mesh.transport == "local"
