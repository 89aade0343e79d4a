"""The 2-D (DCN × ICI) mesh over 4 gloo ranks against the JAX package's.

Four ranks run ``torch_spmd_scenarios.py --hier`` with
``BIGSLICE_MESH_SHAPE=2x2``: the standalone two-stage shuffles
(``parallel/hier.py``, the reference's ``tests/test_hier.py``) on each
rank's slot, then every ``HIER_SCENARIOS`` pipeline through
``spmd_session`` on the 2-D mesh and on a flat mesh over the same ranks
(the reference's ``tests/test_hier_exec.py``), the waved path across
the prefetch × arena matrix, the spill plan (``tests/
test_spill_shuffle.py``'s (D, I) parity) and the elastic rules. This
process meanwhile runs the JAX package over a ``(2, 2)`` CPU mesh.
Every shard's rows must equal both, exact for integers and within
``RTOL`` for float sums.
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
from bigslice_tpu.parallel import hier as ref_hier  # noqa: E402
from bigslice_tpu.parallel import meshutil as ref_meshutil  # noqa: E402
from bigslice_tpu.parallel import shuffle as ref_shuffle  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.parallel import hier, meshutil  # noqa: E402
from bigslice_tpu_torch.tools import multihost_smoke  # noqa: E402

import torch_spmd_scenarios as scen  # noqa: E402
from test_torch_spmd import assert_same_shards  # noqa: E402

NDCN, NICI = 2, 2
N = NDCN * NICI


def _grid():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:N]).reshape(NDCN, NICI),
                ("dcn", "ici"))


def _flat():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:N]), ("shards",))


def _ref_rows(name):
    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    sess = Session(executor=MeshExecutor(_grid()))
    try:
        return bst.result_shard_rows(sess.run(
            scen.HIER_SCENARIOS[name](ref_bs, jnp, N)))
    finally:
        sess.shutdown()


def _shard_rows(cols, counts, capacity):
    chunks = ref_shuffle.unshard_columns(cols, counts, capacity)
    return [sorted(zip(*(np.asarray(c[s]).tolist() for c in chunks)))
            for s in range(N)]


def _ref_units():
    """The reference's standalone shuffles on the (2, 2) grid and the
    flat mesh, at the inputs ``torch_spmd_scenarios._unit_shuffles``
    gives each slot."""
    grid, flat = _grid(), _flat()
    rng = np.random.RandomState(7)
    kc = [rng.randint(0, 1000, 100).astype(np.int32) for _ in range(N)]
    vc = [np.arange(100, dtype=np.int32) + 1000 * s for s in range(N)]
    out = {}
    for name, mesh, cls in (("hier", grid, ref_hier.HierMeshShuffle),
                            ("flat", flat, ref_shuffle.MeshShuffle)):
        cols, counts = ref_shuffle.shard_columns(mesh, [kc, vc],
                                                 [100] * N, 256)
        sh = cls(mesh, ncols=2, nkeys=1, capacity=256)
        o, c, _ = sh(cols, counts)
        out[f"shuffle_{name}"] = _shard_rows(o, c, sh.out_capacity)
    rng = np.random.RandomState(12)
    kr = [rng.randint(0, 41, 150).astype(np.int32) for _ in range(N)]
    vr = [rng.randint(0, 10, 150).astype(np.int32) for _ in range(N)]
    cols, counts = ref_shuffle.shard_columns(grid, [kr, vr], [150] * N, 512)
    for fused in (True, False):
        red = ref_hier.HierMeshReduceByKey(grid, nkeys=1, nvals=1,
                                           capacity=512,
                                           combine_fn=lambda a, b: a + b,
                                           fused=fused)
        k, v, c, _ = red([cols[0]], [cols[1]], counts)
        out[f"reduce_{fused}"] = _shard_rows(k + v, c, red.out_capacity)
    oracle = {}
    for k, v in zip(np.concatenate(kr).tolist(), np.concatenate(vr).tolist()):
        oracle[k] = oracle.get(k, 0) + v
    out["oracle"] = oracle
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("hier"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        launched = pool.submit(
            multihost_smoke.launch, N,
            [sys.executable, os.path.join(os.path.dirname(__file__),
                                          "torch_spmd_scenarios.py"), out,
             "--hier"],
            deadline_s=240.0,
            env={"PYTHONPATH": repo, "OMP_NUM_THREADS": "1",
                 "BIGSLICE_MESH_SHAPE": f"{NDCN}x{NICI}"})
        want = {name: _ref_rows(name) for name in scen.HIER_SCENARIOS}
        units = _ref_units()
        res = launched.result()
    assert res.rc == 0, "\n".join(res.stderr)
    ranks = []
    for r in range(N):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            ranks.append(pickle.load(fh))
    return {"ranks": ranks, "want": want, "units": units}


# -- the standalone two-stage shuffles (tests/test_hier.py) -----------------


def test_hier_matches_flat_shuffle(world):
    """Each rank's slot holds the rows the JAX package's two-stage
    shuffle and its flat shuffle route to that shard."""
    for r, rank in enumerate(world["ranks"]):
        rows, overflow = rank["units"]["shuffle"]
        assert overflow == 0
        assert rows == world["units"]["shuffle_hier"][r]
        assert rows == world["units"]["shuffle_flat"][r]
    assert sum(len(r["units"]["shuffle"][0]) for r in world["ranks"]) \
        == N * 100


def test_hier_overflow_detected(world):
    assert all(r["units"]["overflow"] > 0 for r in world["ranks"])


def test_hier_custom_partitioner(world):
    counts = [r["units"]["custom"][0] for r in world["ranks"]]
    assert all(r["units"]["custom"][1] == 0 for r in world["ranks"])
    assert sum(counts[:3]) == N * 32 and counts[3] == 0


def test_hier_reduce_matches_oracle_and_flat(world):
    got = {}
    for r, rank in enumerate(world["ranks"]):
        rows, overflow = rank["units"]["reduce"]
        assert overflow == 0
        assert rows == world["units"]["reduce_True"][r]
        for k, v in rows:
            assert k not in got
            got[k] = v
    assert got == world["units"]["oracle"]


def test_hier_reduce_fused_matches_unfused_and_oracle(world):
    """The port's one two-stage reduce (the fused kernel over ICI) lands
    the rows of the JAX package's unfused path too."""
    for r, rank in enumerate(world["ranks"]):
        assert rank["units"]["reduce"][0] == world["units"]["reduce_False"][r]


@pytest.mark.parametrize("nparts", [1, 2, 3, 4, 5, 9, 16])
def test_exchange_plan_matches_the_jax_packages(nparts):
    """THE capacity plan both packages' bodies and exchange telemetry
    read (the reference's donation test has no counterpart: the port
    donates staged inputs at the wave's settle, not in the body)."""
    for d, i in ((2, 2), (2, 4), (4, 2), (3, 5)):
        for cap, slack in ((100, 2.0), (4096, 1.5), (7, 4.0)):
            assert hier.exchange_plan(d, i, nparts, cap, slack) == \
                ref_hier.exchange_plan(d, i, nparts, cap, slack)


# -- the executor on the 2-D mesh (tests/test_hier_exec.py) -----------------


@pytest.mark.parametrize("spec", ["", "2x4", "2×4", "1x8", "8x1", "2by4",
                                  "0x4", "x"])
def test_mesh_shape_env_knob(monkeypatch, spec):
    """The port parses ``BIGSLICE_MESH_SHAPE`` as the JAX package does,
    typos raising ``ValueError`` in both."""
    monkeypatch.setenv("BIGSLICE_MESH_SHAPE", spec)
    try:
        want = ref_meshutil.mesh_shape_from_env()
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            meshutil.mesh_shape_from_env()
        return
    assert meshutil.mesh_shape_from_env() == want


def test_mesh_axis_designators(world):
    """Every rank built the 2-D mesh (slot ``g * I + i``) whose
    signature is the JAX package's ``MeshTopology`` of a (2, 2) grid."""
    want = ref_meshutil.MeshTopology(_grid()).signature()
    for rank in world["ranks"]:
        assert rank["is_hier"]
        assert rank["topology"] == want
        assert "shape=2x2" in rank["mesh"]
    r0 = world["ranks"][0]
    assert r0["collectives"]["all_to_all_ici"] > 0
    assert r0["collectives"]["all_to_all_dcn"] > 0
    assert "all_to_all" not in r0["collectives"]


@pytest.mark.parametrize("name", sorted(scen.HIER_SCENARIOS))
def test_2d_rows_equal_the_jax_grid_and_the_flat_ranks(world, name):
    """Every shard's rows equal the JAX package's (2, 2) mesh and the
    port's flat 4-rank exchange, on every rank."""
    want = world["want"][name]
    for rank in world["ranks"]:
        assert_same_shards(rank["rows"][name], want)
        assert_same_shards(rank["rows"][name], rank["flat"][name])


def test_reduce_2d_bit_parity_and_dcn_reduction(world):
    """The DCN stage moves I times fewer, I times larger messages than
    one flat exchange over the same grid would send across DCN."""
    dev = world["ranks"][0]["fleet_device"]
    assert dev["totals"]["dcn_messages"] > 0
    assert dev["totals"]["ici_messages"] > 0
    for op, e in dev["exchange"].items():
        assert e["flat_dcn_messages"] == NICI * e["dcn_messages"]
        assert e["dcn_bytes"] <= e["flat_dcn_bytes"]


def test_reduce_1d_records_no_dcn_traffic(world):
    dev = world["ranks"][0]["flat_fleet_device"]
    assert dev["totals"]["dcn_messages"] == 0
    assert dev["totals"]["ici_messages"] > 0


@pytest.mark.parametrize("arena", [True, False], ids=["arena", "noarena"])
@pytest.mark.parametrize("prefetch", [0, 2], ids=["pf0", "pf2"])
def test_reduce_2d_waved_parity(world, prefetch, arena):
    for rank in world["ranks"]:
        assert_same_shards(rank["waved"][(prefetch, arena)],
                           world["want"]["reduce-waved"])


def test_reduce_spill_parity_hier_2x2(world):
    """Under ``BIGSLICE_SHUFFLE=spill`` the map waves still run the
    two-stage exchange; each map wave is gathered and every rank spills
    every partition to its own store: the rows are the in-memory ones."""
    for rank in world["ranks"]:
        assert_same_shards(rank["spill"], rank["rows"]["reduce-waved"])
        totals = rank["spill_plan"]["totals"]
        assert totals["spill_boundaries"] >= 1 and totals["spill_rows"] > 0


def test_2d_hostloss_reraises_without_a_coordinated_provider(world):
    """Over ranks the default mesh provider gives None (a mesh chosen by
    one rank alone would wedge the group: the JAX package's own scope),
    so an elastic session re-raises the injected gang loss by name."""
    for rank in world["ranks"]:
        assert rank["elastic_provider"] is None
        assert "HostLostError" in rank["elastic"]
        assert "hostloss" in rank["elastic"]


def test_2d_resize_to_flat_still_computes(world):
    """Resized onto its one-slot mesh, the grid's executor computes the
    whole reduce on each rank, equal to the JAX package's rows."""
    want = world["want"]["reduce"]
    for rank in world["ranks"]:
        nmesh, is_hier, rows = rank["resized"]
        assert (nmesh, is_hier) == (1, False)
        assert_same_shards(rows, want)
        assert rank["modules"] == []
