"""The device executor over 4 ranks on the CPU, against the JAX
package's 4-device CPU mesh: ``test_torch_spmd.py``'s scenarios and
core scenarios and checks at N = 4 (S = 4N shards in four waves a
rank, S = N - 1 padded, the dense combine-shuffle at S = N)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd import CORE, check_parity, launch_world  # noqa: E402


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return launch_world(4, tmp_path_factory, CORE)


@pytest.mark.parametrize("name", CORE)
def test_four_ranks_match_the_jax_packages_four_device_mesh(world, name):
    check_parity(world, name)


def test_four_ranks_agree(world):
    """The same overflow verdicts, Cogroup widths and state on every
    rank; no rank imported either JAX package."""
    ranks = world["ranks"]
    for r in ranks[1:]:
        assert r["hash_off"] == ranks[0]["hash_off"]
        assert r["cogroup_caps"] == ranks[0]["cogroup_caps"]
    for r in ranks:
        assert r["modules"] == [] and r["nmesh"] == 4
        assert r["attend_methods"] == {}
