"""K1: the port's hash_partition (its plain version, on the CPU) against
the JAX package's Pallas kernel in interpret mode and its stock XLA
routing path: ids and counts bit-equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bigslice_tpu.parallel import pallas_kernels as pk  # noqa: E402
from bigslice_tpu.parallel import shuffle as ref_shuffle  # noqa: E402
from bigslice_tpu_torch.parallel import cuda_kernels  # noqa: E402
from bigslice_tpu_torch.parallel import shuffle as port_shuffle  # noqa: E402


def _need_interpret():
    if not pk.interpret_capable():
        pytest.skip("pallas interpret mode cannot execute kernels on this "
                    "jax build (pk.interpret_capable() probe failed)")


def _keys(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32)


@pytest.mark.parametrize("nparts", [1, 7, 128, 300])
@pytest.mark.parametrize("n", [0, 1, 1000, 1031])
def test_hash_partition_matches_pallas(n, nparts):
    _need_interpret()
    keys = _keys(n, n + nparts)
    want_ids, want_counts = pk.hash_partition(keys, nparts, seed=0)
    ids, counts = cuda_kernels.hash_partition(
        [torch.from_numpy(keys)], nparts, seed=0)
    assert ids.dtype == torch.int32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))


def _mixed(n, seed):
    rng = np.random.RandomState(seed)
    f = (rng.randn(n) * 100).astype(np.float32)
    f[:4] = [0.0, -0.0, np.nan, np.inf]
    return [
        rng.randint(-1000, 1000, n).astype(np.int32),
        rng.randint(0, 2**32, n, dtype=np.int64).astype(np.uint32),
        f,
    ]


@pytest.mark.parametrize("seed", [0, 3])
def test_hash_partition_multikey_mask_matches_pallas(seed):
    _need_interpret()
    n, nparts = 1031, 300
    keys = _mixed(n, seed)
    valid = np.random.RandomState(seed + 10).rand(n) < 0.8
    want_ids, want_counts = pk.hash_partition(keys, nparts, seed=seed,
                                              valid=valid)
    ids, counts = cuda_kernels.hash_partition(
        [torch.from_numpy(k) for k in keys], nparts, seed=seed,
        valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert (ids.numpy()[~valid] == nparts).all()


@pytest.mark.parametrize("nparts", [1, 7, 128, 300])
def test_partition_ids_matches_xla_path(nparts):
    """The port's routing contract against the JAX package's stock XLA
    path (shuffle.partition_ids(use_pallas=False))."""
    n = 1000
    keys = _mixed(n, nparts)
    valid = np.random.RandomState(nparts).rand(n) < 0.9
    want, _, _ = ref_shuffle.partition_ids(keys, nparts, 5, valid=valid,
                                           use_pallas=False)
    got, bad, counts = port_shuffle.partition_ids(
        [torch.from_numpy(k) for k in keys], nparts, 5,
        valid=torch.from_numpy(valid), with_counts=True)
    assert bad is None
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(np.asarray(want)[valid],
                                    minlength=nparts)[:nparts])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hash_partition_without_counts():
    keys = torch.from_numpy(_keys(100, 1))
    ids, counts = cuda_kernels.hash_partition([keys], 9, with_counts=False)
    assert counts is None
    want, _ = cuda_kernels.hash_partition_plain([keys], 9)
    assert torch.equal(ids, want)
