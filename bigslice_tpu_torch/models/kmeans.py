"""k-means — the iterative pattern: repeated ``Session.run`` calls, each
feeding the last run's centroids back into the next graph.

The points are materialized once as a ``Result`` of one [n, d] float32
vector column. Each iteration maps every point to its nearest centroid
(a device ``Map``, vmapped over the rows, with the [k, d] centroids an
unbatched argument: under vmap the c·x products batch into one
[n, d] x [d, k] matmul) and sums the points of each centroid in a dense
``Reduce`` over the centroid ids (a [k, d] table of accumulators).
"""

from __future__ import annotations

import numpy as np
import torch


def kmeans_step(points: torch.Tensor, centroids: torch.Tensor
                ) -> torch.Tensor:
    """One k-means iteration on one device.

    points: float[n, d]; centroids: float[k, d] -> new centroids
    float[k, d] (a centroid with no point keeps 0). Distances rank by the
    ||x - c||^2 = ||x||^2 - 2 x·c + ||c||^2 expansion, ||x||^2 dropped
    (the same for every centroid): x·cᵀ and the one-hot sums are the two
    matmuls.
    """
    dots = torch.matmul(points, centroids.T)  # [n, k]
    c2 = torch.sum(centroids * centroids, dim=1)  # [k]
    assign = torch.argmin(c2[None, :] - 2.0 * dots, dim=1)  # [n]
    onehot = torch.nn.functional.one_hot(
        assign, centroids.shape[0]).to(points.dtype)  # [n, k]
    sums = torch.matmul(onehot.T, points)  # [k, d]
    counts = torch.sum(onehot, dim=0)  # [k]
    return sums / torch.clamp(counts, min=1.0)[:, None]


class MeshKmeansNotPorted(NotImplementedError):
    """The data-parallel step over several devices waits for the
    multi-GPU exchange."""


def mesh_kmeans_step(mesh, k: int, d: int):
    """The k-means step sharded over a device mesh: not ported."""
    raise MeshKmeansNotPorted(
        "mesh_kmeans_step: the data-parallel step over several devices "
        "needs the multi-GPU exchange, which is not ported; use "
        "kmeans_step on one device or kmeans through a Session")


def kmeans(sess, points: np.ndarray, k: int, iters: int = 10,
           num_shards: int = 4, seed: int = 0, on_iter=None) -> np.ndarray:
    """k-means through the slice API: ``iters`` runs over one reused
    ``Result`` of the points; returns the float32 [k, d] centroids,
    starting from ``k`` points drawn by ``RandomState(seed)``.
    ``on_iter(i, before, after)``, where given, sees each iteration's
    centroids (copies) as it ends."""
    import bigslice_tpu_torch as bs

    n, _ = points.shape
    rng = np.random.RandomState(seed)
    centroids = points[rng.choice(n, size=k, replace=False)].astype(
        np.float32)
    base = sess.run(bs.Const(num_shards, points.astype(np.float32)))
    for i in range(iters):
        before = centroids.copy() if on_iter is not None else None
        # Module-level functions and the centroids as an argument (data,
        # not a constant of the function): every iteration builds the
        # same ops.
        assigned = bs.Map(base, _assign_vec, args=(centroids,))
        summed = bs.Reduce(assigned, _sum_combine, dense_keys=k)
        for cid, vec, cnt in sess.run(summed).rows():
            if cnt > 0:
                centroids[int(cid)] = np.asarray(vec, np.float32) / cnt
        if on_iter is not None:
            on_iter(i, before, centroids.copy())
    return centroids


def _assign_vec(x, c):
    """A row's nearest centroid: x is its [d] point, c the unbatched
    [k, d] centroids. Written as ||c||^2 - 2 c·x, as in ``kmeans_step``:
    under vmap c·x batches into the matmul, where ||c - x||^2 would make
    an [n, k, d] elementwise tensor."""
    c2 = torch.sum(c * c, dim=1)
    d2 = c2 - 2.0 * torch.matmul(c, x)
    return torch.argmin(d2).to(torch.int32), x, 1.0


def _sum_combine(a, b):
    return tuple(x + y for x, y in zip(a, b))


def kmeans_oracle(points: np.ndarray, k: int, iters: int, seed: int = 0
                  ) -> np.ndarray:
    """Plain numpy k-means from the same start, for tests."""
    n, _ = points.shape
    rng = np.random.RandomState(seed)
    centroids = points[rng.choice(n, size=k, replace=False)].copy()
    for _ in range(iters):
        d2 = ((points[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
        assign = d2.argmin(1)
        for c in range(k):
            m = assign == c
            if m.any():
                centroids[c] = points[m].mean(0)
    return centroids
