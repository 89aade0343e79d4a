"""The port's k-means (``models/kmeans.py``) against the JAX package's,
on the CPU, at the sizes of tests/test_models.py.

``kmeans_step`` (float32 matmuls) against the JAX ``kmeans_step`` within
``rtol=1e-4``; ``kmeans`` through ``Session(executor=MeshExecutor(
device="cpu"))`` and its ``LocalExecutor`` against the JAX ``kmeans``
(its ``Session()``) from the same start within ``rtol=1e-5``, the same
assignments and so the same convergence.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from bigslice_tpu.exec.session import Session as RefSession  # noqa: E402
from bigslice_tpu.models import kmeans as ref_km  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.models import kmeans as km  # noqa: E402

STEP_RTOL = 1e-4
RUN_RTOL = 1e-5


def _blobs(seed=4):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.randn(50, 4).astype(np.float32) + 10 * i
                          for i in range(3)])
    rng.shuffle(pts)
    return pts


def _session(kind):
    if kind == "mesh":
        return bst.Session(executor=bst.MeshExecutor(device="cpu"))
    return bst.Session(executor=bst.LocalExecutor(device="cpu"))


@pytest.mark.parametrize("seed", [2, 5])
def test_kmeans_step_matches_the_jax_step(seed):
    rng = np.random.RandomState(seed)
    pts = rng.rand(256, 8).astype(np.float32)
    cents = pts[:4].copy()
    got = km.kmeans_step(torch.from_numpy(pts), torch.from_numpy(cents))
    want = np.asarray(jax.jit(ref_km.kmeans_step)(pts, cents))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=STEP_RTOL,
                               atol=STEP_RTOL)
    # One manual step (tests/test_models.py's oracle).
    d2 = ((pts[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
    assign = d2.argmin(1)
    for c in range(4):
        m = assign == c
        if m.any():
            np.testing.assert_allclose(got[c].numpy(), pts[m].mean(0),
                                       rtol=STEP_RTOL)


def test_kmeans_step_keeps_an_empty_centroid_at_zero():
    pts = np.zeros((8, 2), np.float32)
    cents = np.array([[0, 0], [100, 100]], np.float32)
    got = km.kmeans_step(torch.from_numpy(pts), torch.from_numpy(cents))
    want = np.asarray(ref_km.kmeans_step(pts, cents))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["mesh", "local"])
def test_kmeans_slice_api_matches_the_jax_package(kind):
    pts = _blobs()
    got = km.kmeans(_session(kind), pts, k=3, iters=5, num_shards=3)
    want = ref_km.kmeans(RefSession(), pts, k=3, iters=5, num_shards=3)
    np.testing.assert_allclose(got, want, rtol=RUN_RTOL, atol=RUN_RTOL)
    assert sorted(round(float(c[0]) / 10) for c in got) == [0, 1, 2]
    np.testing.assert_allclose(got, km.kmeans_oracle(pts, 3, 5),
                               rtol=RUN_RTOL, atol=RUN_RTOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_kmeans_wider_points_match_the_jax_package(seed):
    """256 points of d = 8, k = 4 (tests/test_models.py:56's shape), four
    iterations over four shards."""
    rng = np.random.RandomState(seed)
    pts = rng.rand(256, 8).astype(np.float32)
    got = km.kmeans(_session("mesh"), pts, k=4, iters=4, num_shards=4,
                    seed=seed)
    want = ref_km.kmeans(RefSession(), pts, k=4, iters=4, num_shards=4,
                         seed=seed)
    np.testing.assert_allclose(got, want, rtol=RUN_RTOL, atol=RUN_RTOL)


def test_kmeans_runs_a_device_map_and_a_dense_reduce():
    """Each iteration's Map is device tier (vmapped, the centroids an
    unbatched argument) and its Reduce a dense table of k rows;
    ``on_iter`` sees every iteration's centroids."""
    pts = _blobs()
    seen = []
    ex = bst.MeshExecutor(device="cpu")
    final = km.kmeans(bst.Session(executor=ex), pts, k=3, iters=3,
                      num_shards=3,
                      on_iter=lambda i, b, a: seen.append((i, b, a)))
    assert [i for i, _, _ in seen] == [0, 1, 2]
    np.testing.assert_array_equal(seen[-1][2], final)
    np.testing.assert_array_equal(seen[1][1], seen[0][2])
    base = bst.Session(executor=ex).run(bst.Const(3, pts))
    m = bst.Map(base, km._assign_vec, args=(seen[0][1],))
    assert m.mode == "device"
    assert [ct.dtype for ct in m.schema] == [np.int32, np.float32,
                                             np.float32]
    r = bst.Reduce(m, km._sum_combine, dense_keys=3)
    assert r.frame_combiner.dense_keys == 3
    assert r.frame_combiner.dense_ops == ("add", "add")


def test_kmeans_oracle_is_the_jax_packages():
    pts = _blobs(9)
    np.testing.assert_array_equal(km.kmeans_oracle(pts, 3, 4, seed=1),
                                  ref_km.kmeans_oracle(pts, 3, 4, seed=1))


def test_mesh_kmeans_step_raises_by_name():
    with pytest.raises(km.MeshKmeansNotPorted, match="not ported"):
        km.mesh_kmeans_step(None, k=4, d=8)
    assert issubclass(km.MeshKmeansNotPorted, NotImplementedError)


def test_models_package_names_kmeans():
    import bigslice_tpu_torch.models as models

    assert "kmeans" in models.__all__ and models.kmeans is km
