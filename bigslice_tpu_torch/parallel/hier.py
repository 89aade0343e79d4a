"""The two-stage shuffle over a 2-D (DCN × ICI) mesh of ranks.

The flat shuffle (``parallel/shuffle.py``) issues ONE exchange over every
slot, with no regard for which link each bucket crosses. Across hosts
the links are not flat: ranks of one host (or one NVLink domain) talk
fast, hosts talk over the network. This module (reference
parallel/hier.py) shuffles a 2-D mesh (``BIGSLICE_MESH_SHAPE=DxI``,
``meshutil.Mesh(shape=(D, I))``) in TWO stages:

1. **ICI stage**: every rank buckets its rows by destination ICI lane
   and exchanges within its row of the grid (``axis="ici"``). After it,
   rank (g, i) holds every row of row g bound for lane i of ANY row.
2. **DCN stage**: rows bucket by destination row and exchange within
   the rank's column (``axis="dcn"``): each (source row, destination
   row) pair moves, per lane, as ONE message, I times fewer and I times
   larger than the flat exchange's.

Routing, capacities, slack and overflow are the flat shuffle's:
fixed-capacity buckets, counts first, rows beyond a bucket reported as
overflow for the caller's retry with more slack. Both stages route with
``shuffle.partition_ids`` (the ``hash_partition`` kernel) and move rows
with ``shuffle.route_to_buckets`` and ``shuffle.bucket_exchange``, so
the two-stage path cannot drift from the flat one. Ranks are numbered
row-major, rank ``g * I + i`` at (g, i), so partition p lands on slot
``p % N`` with subid ``p // N`` exactly as in the flat shuffle, and the
rows of every shard are the flat shuffle's.

The bodies return this rank's overflow and bad-partition terms; the
executor sums them over the mesh with the wave's other signals, as it
does for the flat bodies (the JAX package psums them inside). The
spill plan (``exec/shuffleplan.py``) composes unchanged: each map wave
still runs the two-stage exchange, and only the cross-wave merge goes
through the store.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from bigslice_tpu_torch.parallel import meshutil, segment
from bigslice_tpu_torch.parallel.shuffle import (SORTLESS_MAX_LANES,
                                                 bucket_exchange,
                                                 make_combine_shuffle_fn,
                                                 partition_ids,
                                                 route_to_buckets,
                                                 send_capacity)

__all__ = ["HierMeshReduceByKey", "HierMeshShuffle", "dcn_stage",
           "exchange_plan", "make_hier_combine_shuffle_fn",
           "make_hier_shuffle_fn"]


def exchange_plan(ndcn: int, nici: int, nparts: int, capacity: int,
                  slack: float) -> dict:
    """THE capacity plan of the two-stage exchange, which the bodies and
    the executor's exchange telemetry both read (reference :68-106):
    ``waved`` (nparts > D·I: the subid column rides out), ``ndest1``
    (ICI lanes addressed), ``cap1`` (rows a stage-1 bucket),
    ``ngroups`` (DCN rows addressed), ``cap2`` (rows a stage-2
    bucket), and ``stage1_extra_cols``/``stage2_extra_cols`` (int32
    routing columns riding each stage: the quotient on ICI when nparts
    > I, the subid on DCN when waved)."""
    nshards = ndcn * nici
    waved = nparts > nshards
    ndest1 = max(1, min(nici, nparts))
    # Stage 2's share is capacity / rows used (a rank's valid rows after
    # stage 1 total about capacity under a uniform hash): basing it on
    # stage 1's receive buffer would compound the slack twice.
    ngroups = ndcn if waved else max(1, min(ndcn, -(-nparts // nici)))
    return {
        "waved": waved,
        "ndest1": ndest1,
        "cap1": send_capacity(capacity, ndest1, slack),
        "ngroups": ngroups,
        "cap2": send_capacity(capacity, ngroups, slack),
        "stage1_extra_cols": 1 if nparts > nici else 0,
        "stage2_extra_cols": 1 if waved else 0,
    }


def _sortless(nlanes: int) -> bool:
    return nlanes <= SORTLESS_MAX_LANES


def dcn_stage(mask1, dest_g, payload_cols, ndcn: int, cap2: int,
              sortless: Optional[bool] = None, waved: bool = False):
    """Stage 2, shared by the plain and the fused shuffle: received rows
    carry their destination row in ``dest_g``; bucket by it and exchange
    along DCN. With ``waved`` (nparts > D·I) ``dest_g`` is the quotient
    ``part // I = subid * D + row``: its row picks the lane and its
    subid rides out as the leading int32 column, the flat waved
    shuffle's contract. Returns (mask2, this rank's overflow,
    out_cols)."""
    if sortless is None:
        sortless = _sortless(ndcn)
    if waved:
        g2 = torch.where(mask1, dest_g % ndcn, ndcn).to(torch.int32)
        payload_cols = ((dest_g // ndcn).to(torch.int32),) + tuple(
            payload_cols)
    else:
        g2 = torch.where(mask1, dest_g, ndcn).to(torch.int32)
    d2, cols2, off2, counts2 = route_to_buckets(g2, tuple(payload_cols),
                                                ndcn, sortless)
    in2 = (d2 < ndcn) & (off2 < cap2)
    row2 = torch.where(in2, d2, ndcn)
    o2 = torch.where(in2, off2, 0)
    send2 = torch.clamp(counts2, max=cap2).to(torch.int32)
    mask2, out_cols = bucket_exchange(ndcn, cap2, row2, o2, send2, cols2,
                                      axis="dcn")
    ov2 = torch.clamp(counts2.max() - cap2, min=0).to(torch.int32)
    return mask2, ov2, out_cols


def make_hier_shuffle_fn(ndcn: int, nici: int, nkeys: int, capacity: int,
                         seed: int = 0,
                         partition_fn: Optional[Callable] = None,
                         slack: float = 2.0, nparts: Optional[int] = None):
    """The combinerless two-stage shuffle body (reference :152-258):
    ``masked(valid, *cols) -> (recv_valid_mask, overflow, bad,
    out_cols)``, ``make_shuffle_fn``'s contract, out_cols of ``ndcn *
    cap2`` rows in bucket position. ``nparts`` (default D·I) may be
    smaller than the mesh (trailing shards receive nothing) or larger
    (partition p on slot ``p % (D·I)``, subid ``p // (D·I)`` as the
    leading output column)."""
    if nparts is None:
        nparts = ndcn * nici
    plan = exchange_plan(ndcn, nici, nparts, capacity, slack)
    cap1, cap2, waved = plan["cap1"], plan["cap2"], plan["waved"]

    def masked(valid, *cols):
        device = valid.device
        keys = cols[:nkeys]
        part, bad, _ = partition_ids(keys, nparts, seed, valid=valid,
                                     partition_fn=partition_fn)
        n_bad = (torch.zeros((), dtype=torch.int32, device=device)
                 if bad is None else (bad & valid).sum().to(torch.int32))
        routable = part < nparts
        # The quotient: the destination row (or subid * D + row, when
        # waved); unroutable rows drop at stage 1.
        dest_g = torch.where(routable, part // nici, 0).to(torch.int32)
        dest_i = torch.where(routable, part % nici, nici).to(torch.int32)
        # Stage 1: bucket by ICI lane, exchange along the row; dest_g
        # rides as a payload column.
        d1, cols1, off1, counts1 = route_to_buckets(
            dest_i, (dest_g,) + tuple(cols), nici, _sortless(nici))
        in1 = (off1 < cap1) & (d1 < nici)
        row1 = torch.where(in1, d1, nici)
        o1 = torch.where(in1, off1, 0)
        send1 = torch.clamp(counts1, max=cap1).to(torch.int32)
        mask1, recv = bucket_exchange(nici, cap1, row1, o1, send1, cols1,
                                      axis="ici")
        ov1 = torch.clamp(counts1.max() - cap1, min=0).to(torch.int32)
        # Stage 2: by destination row, along the column.
        mask2, ov2, out_cols = dcn_stage(mask1, recv[0], recv[1:], ndcn,
                                         cap2, waved=waved)
        return mask2, ov1 + ov2, n_bad, out_cols

    return masked


def make_hier_combine_shuffle_fn(ndcn: int, nici: int, nkeys: int,
                                 nvals: int, cfn, seed: int = 0,
                                 slack: float = 2.0,
                                 nparts: Optional[int] = None,
                                 partition_fn: Optional[Callable] = None):
    """The fused two-stage combine + shuffle (reference :261-347), with
    ``make_combine_shuffle_fn``'s contract:

    1. stage 1 IS the flat fused kernel over the ICI axis, waved when
       nparts > I: its one sort segments the map-side combine and orders
       the ICI routing, and its leading subid column (``part // I``) is
       what stage 2 routes on;
    2. an ICI-stage combine merges the up to I partials per (destination
       shard, key) that stage 1 gathered on this rank, before anything
       crosses DCN (the quotient leads the keys, so rows bound for
       different shards never merge);
    3. the shared ``dcn_stage``.

    Received rows are per-source-row partials; the consumer's combine
    merges them as it does the flat kernel's per-source-slot ones."""
    if nparts is None:
        nparts = ndcn * nici
    stage1_waved = nparts > nici
    fused1 = make_combine_shuffle_fn(nici, nkeys, nvals, cfn, seed,
                                     partition_fn=partition_fn, slack=slack,
                                     nparts=nparts, axis="ici")
    recombine = segment.make_segmented_reduce_masked(1 + nkeys, nvals, cfn)

    def masked(valid, *cols):
        size = cols[0].shape[0]
        plan = exchange_plan(ndcn, nici, nparts, size, slack)
        mask1, ov1, bad1, s1 = fused1(valid, *cols)
        if stage1_waved:
            gq = s1[0]
            keys1, vals1 = tuple(s1[1:1 + nkeys]), tuple(s1[1 + nkeys:])
        else:
            # nparts <= I: every partition is in row 0, and stage 1
            # emitted no quotient column.
            gq = torch.zeros(s1[0].shape[0], dtype=torch.int32,
                             device=valid.device)
            keys1, vals1 = tuple(s1[:nkeys]), tuple(s1[nkeys:])
        mask_c, kc, vc = recombine(mask1, (gq,) + keys1, vals1)
        mask2, ov2, out_cols = dcn_stage(
            mask_c, kc[0], tuple(kc[1:]) + tuple(vc), ndcn, plan["cap2"],
            waved=plan["waved"])
        return mask2, ov1 + ov2, bad1, out_cols

    return masked


def _local_valid(cols, counts) -> torch.Tensor:
    n = torch.as_tensor(counts).reshape(-1)[0]
    return torch.arange(cols[0].shape[0], device=cols[0].device) < n


class HierMeshShuffle:
    """A standalone two-stage shuffle over a 2-D mesh of ranks
    (reference :463-512), each rank calling it with its own slot's
    columns: ``__call__(cols, counts) -> (out_cols, out_counts,
    overflow)``, the routed rows front-packed into ``out_capacity``
    rows, ``overflow`` summed over the mesh."""

    def __init__(self, mesh: meshutil.Mesh, ncols: int, nkeys: int,
                 capacity: int, seed: int = 0, partition_fn=None,
                 slack: float = 2.0):
        self.mesh = mesh
        self.nshards = mesh.size
        self.ncols = ncols
        self.capacity = capacity
        self.out_capacity = mesh.ndcn * send_capacity(capacity, mesh.ndcn,
                                                      slack)
        self._body = make_hier_shuffle_fn(mesh.ndcn, mesh.nici, nkeys,
                                          capacity, seed, partition_fn,
                                          slack)

    def __call__(self, cols: Sequence, counts):
        cols = [c.to(self.mesh.device) for c in cols]
        with meshutil.active(self.mesh):
            mask, ov, bad, out = self._body(_local_valid(cols, counts),
                                            *cols)
            overflow = self.mesh.psum((ov + bad).reshape(1))[0]
        n, packed = segment.compact_by_mask(mask, out)
        return list(packed), n.reshape(1), overflow


class HierMeshReduceByKey:
    """A standalone keyed reduction over a 2-D mesh of ranks (reference
    :350-460): the fused two-stage combine + shuffle, then the
    reduce-side segmented reduce, front-packed; the per-shard rows of
    the flat reduction. ``__call__(key_cols, val_cols, counts) ->
    (key_cols, val_cols, out_counts, overflow)``, each rank with its
    own slot's columns."""

    def __init__(self, mesh: meshutil.Mesh, nkeys: int, nvals: int,
                 capacity: int, combine_fn: Callable, seed: int = 0,
                 slack: float = 2.0):
        self.mesh = mesh
        self.nshards = mesh.size
        self.capacity = capacity
        self.out_capacity = mesh.ndcn * send_capacity(capacity, mesh.ndcn,
                                                      slack)
        self.nkeys = nkeys
        cfn = segment.canonical_combine(combine_fn, nvals)
        self._fused = make_hier_combine_shuffle_fn(
            mesh.ndcn, mesh.nici, nkeys, nvals, cfn, seed, slack=slack)
        self._final = segment.make_segmented_reduce_masked(nkeys, nvals, cfn)

    def __call__(self, key_cols: Sequence, val_cols: Sequence, counts):
        cols = [c.to(self.mesh.device)
                for c in list(key_cols) + list(val_cols)]
        nk = self.nkeys
        with meshutil.active(self.mesh):
            recv, ov, _bad, out = self._fused(_local_valid(cols, counts),
                                              *cols)
            overflow = self.mesh.psum(ov.reshape(1))[0]
        mask, k, v = self._final(recv, tuple(out[:nk]), tuple(out[nk:]))
        n, packed = segment.compact_by_mask(mask, list(k) + list(v))
        return list(packed[:nk]), list(packed[nk:]), n.reshape(1), overflow
