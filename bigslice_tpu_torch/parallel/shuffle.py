"""Shuffle: routing, fixed-capacity buckets and the exchange seam.

Every shuffle boundary routes rows by ``partition_ids`` — murmur
``hash % nparts`` over the key columns, bit-equal to the JAX package,
computed by the ``hash_partition`` kernel (parallel/cuda_kernels.py) on
the card and by its plain version on the CPU — or by a custom
``partition_fn`` (Repartition).

The sort shuffle (``make_shuffle_fn``, and ``make_combine_shuffle_fn``
with a map-side combine fused into its one sort) then

1. gives every row a slot in its destination's bucket
   (``route_to_buckets``: a one-hot running count, or a sort by
   destination),
2. scatters rows into fixed-capacity per-destination buckets and moves
   them through the ``all_to_all`` seam (``bucket_exchange``),
3. reports rows beyond a bucket's capacity as ``overflow`` (the caller
   retries with more slack) and out-of-range partitioner ids as
   ``bad``.

The bodies see one slot's rows (a rank's, ``parallel/meshutil.py``):
``all_to_all`` is the mesh's exchange over its process group, the
identity on one slot, and with more partitions than slots each row
carries its partition's subid as a leading column. The overflow and bad
signals are this slot's; the executor sums them over the mesh with the
wave's other signals before it reads any of them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from bigslice_tpu_torch.parallel import segment
from bigslice_tpu_torch.parallel.jitutil import kernel_device

#: Above this lane count the one-hot running count's O(n * lanes) work
#: overtakes the routing sort it replaces.
SORTLESS_MAX_LANES = 32


def send_capacity(capacity: int, nshards: int, slack: float = 2.0) -> int:
    """Per-(source, dest) bucket rows: a uniform hash sends about
    capacity/nshards rows to each destination; ``slack`` is the skew
    headroom. The receive buffer is nshards*send_cap ≈ slack ×
    capacity rows."""
    return max(1, int(np.ceil(capacity * slack / nshards)))


def partition_ids(keys: Sequence[torch.Tensor], nparts: int, seed: int,
                  valid: Optional[torch.Tensor] = None,
                  partition_fn: Optional[Callable] = None,
                  with_counts: bool = False):
    """Destination partition ids for rows keyed by ``keys`` — THE one
    implementation of the device tier's routing contract.

    Returns ``(part, bad, counts)``: ids int32[n] with invalid rows
    (``valid`` False) and out-of-range partitioner ids parked at the
    ``nparts`` sentinel; ``bad`` the bool mask of out-of-range ids
    (None under hash routing, which cannot produce them); ``counts``
    the int32[nparts] histogram of routable rows when ``with_counts``
    and hash routing, else None.
    """
    if partition_fn is not None:
        part = torch.as_tensor(partition_fn(*keys)).to(torch.int32)
        bad = (part < 0) | (part >= nparts)
        part = torch.where(bad, nparts, part).to(torch.int32)
        if valid is not None:
            part = torch.where(valid, part, nparts).to(torch.int32)
        return part, bad, None
    from bigslice_tpu_torch.parallel import cuda_kernels

    part, counts = cuda_kernels.hash_partition(
        list(keys), nparts, seed, with_counts=with_counts, valid=valid,
    )
    return part, None, counts


def _exclusive_cumsum(x):
    return torch.cumsum(x, 0, dtype=torch.int32) - x


def route_to_buckets(dest, cols, ndest: int, sortless: bool):
    """Each row's slot in its destination bucket, both ways:

    - SORTLESS (one-hot running count): a row's slot is its running
      count among same-destination rows — order-preserving, no sort;
    - SORT: rows reorder by destination (payload follows through the
      sort's permutation); slots are arange minus bucket starts.

    ``dest`` int32[size] with the value ``ndest`` parking at the drop
    sentinel. Returns (dest', cols', offsets, counts) where dest'/cols'
    are the (possibly permuted) rows the offsets refer to and counts
    int32[ndest] excludes sentinel rows."""
    size = dest.shape[0]
    device = dest.device
    lanes = torch.arange(ndest, dtype=torch.int32, device=device)
    if sortless:
        onehot = (dest[:, None] == lanes[None]).to(torch.int32)
        csum = torch.cumsum(onehot, 0, dtype=torch.int32)
        counts = (csum[-1] if size
                  else torch.zeros(ndest, dtype=torch.int32, device=device))
        lane = torch.clamp(dest, max=ndest - 1).to(torch.int64)
        offset = torch.gather(csum, 1, lane[:, None])[:, 0] - 1
        return dest, cols, offset, counts
    (s_dest,), s_cols = segment.sort_with_payload(
        (dest,), 1, cols, bits=(max(1, ndest.bit_length()),))
    counts = torch.bincount(s_dest.to(torch.int64),
                            minlength=ndest + 1)[:ndest].to(torch.int32)
    starts = _exclusive_cumsum(counts)
    offset = (torch.arange(size, dtype=torch.int32, device=device)
              - starts[torch.clamp(s_dest, max=ndest - 1).to(torch.int64)])
    return s_dest, s_cols, offset, counts


def bucket_exchange(nshards: int, send_cap: int, dest_row, dest_off,
                    send_counts, cols):
    """Scatter rows into per-destination send buckets and exchange them
    (counts, then data) through ``all_to_all``. ``dest_row`` is each
    row's destination device lane (``nshards`` = drop, with
    ``dest_off`` 0), ``dest_off`` its slot in that bucket,
    ``send_counts`` int32[nshards] the (clipped) rows per destination.
    Returns (recv_valid_mask, out_cols) with out_cols holding
    ``nshards * send_cap`` rows — a bucket from each source shard, row j
    of source bucket s valid iff j < recv_counts[s]."""
    device = dest_row.device
    # Only the rows that stay are scattered: millions of dropped rows
    # writing one drop slot would serialize on it.
    stay = torch.nonzero(dest_row < nshards).squeeze(1)
    slot = (dest_row[stay].to(torch.int64) * send_cap
            + dest_off[stay].to(torch.int64))
    # Counts first, then the data planes (reference :164-168).
    recv_counts = all_to_all(send_counts.reshape(nshards, 1),
                             nshards).reshape(nshards)
    out_cols = []
    for c in cols:
        lanes = segment.eq_lanes(c)
        buf = torch.zeros((nshards * send_cap,) + tuple(c.shape[1:]),
                          dtype=lanes.dtype, device=device)
        buf[slot] = lanes[stay]
        planes = buf.view(c.dtype).reshape(
            (nshards, send_cap) + tuple(c.shape[1:]))
        recv = all_to_all(planes, nshards)
        out_cols.append(recv.reshape((nshards * send_cap,)
                                     + tuple(c.shape[1:])))
    row_in_bucket = torch.arange(send_cap, dtype=torch.int32, device=device)
    valid_mask = (row_in_bucket[None, :]
                  < recv_counts[:, None]).reshape(-1)
    return valid_mask, out_cols


def make_shuffle_fn(nshards: int, nkeys: int, capacity: int, seed: int = 0,
                    partition_fn: Optional[Callable] = None,
                    slack: float = 2.0, nparts: Optional[int] = None,
                    sortless: Optional[bool] = None):
    """The combinerless shuffle body over ``cols`` of ``capacity`` rows:
    ``masked(valid, *cols) -> (recv_valid_mask, overflow, bad,
    out_cols)`` leaves received rows in bucket position. out_cols have
    ``nshards * send_capacity(...)`` rows.

    ``partition_fn(*key_cols) -> int32 ids`` overrides hash routing
    (Repartition); ids outside [0, nparts) are dropped and counted in
    ``bad``. ``nparts`` (default ``nshards``) may exceed the mesh
    (wave-partitioned outputs): partition p routes to device
    ``p % nshards`` carrying ``p // nshards`` as a leading int32 subid
    output column, which waved consumers filter on.

    ``sortless`` defaults to the one-hot running count up to
    ``SORTLESS_MAX_LANES`` destination lanes: the JAX package's default
    on every backend but the TPU, kept here. On one card the lanes are
    a single one, so the choice changes nothing until the exchange
    spans GPUs.
    """
    if nparts is None:
        nparts = nshards
    waved = nparts > nshards
    send_cap = send_capacity(capacity, nshards if waved else nparts, slack)
    ndest_static = nshards if waved else nparts
    if sortless is None:
        sortless = ndest_static <= SORTLESS_MAX_LANES

    def masked(valid, *cols):
        keys = cols[:nkeys]
        device = valid.device
        part, bad, _ = partition_ids(keys, nparts, seed, valid=valid,
                                     partition_fn=partition_fn)
        n_bad = (torch.zeros((), dtype=torch.int32, device=device)
                 if bad is None else (bad & valid).sum().to(torch.int32))
        if waved:
            routable = part < nparts
            dev = torch.where(routable, part % nshards, nshards)
            subid = torch.where(routable, part // nshards, 0)
            cols = (subid.to(torch.int32),) + tuple(cols)
            part = dev.to(torch.int32)
            ndest = nshards
        else:
            ndest = nparts
        s_part, s_cols, offset, counts = route_to_buckets(
            part, cols, ndest, sortless)
        # Rows beyond a bucket's capacity (or invalid) drop, reported
        # through the overflow signal.
        in_bounds = (offset < send_cap) & (s_part < ndest)
        dest_row = torch.where(in_bounds, s_part, nshards)
        dest_off = torch.where(in_bounds, offset, 0)
        send_counts = torch.clamp(counts, max=send_cap).to(torch.int32)
        if ndest < nshards:
            send_counts = torch.cat([send_counts, torch.zeros(
                nshards - ndest, dtype=torch.int32, device=device)])
        valid_mask, out_cols = bucket_exchange(
            nshards, send_cap, dest_row, dest_off, send_counts, s_cols)
        # This slot's term of the signals the JAX package psums here
        # (reference :321-324); the executor sums them at settle.
        overflow = torch.clamp(counts.max() - send_cap, min=0)
        return valid_mask, overflow.to(torch.int32), n_bad, out_cols

    return masked


def make_combine_shuffle_fn(nshards: int, nkeys: int, nvals: int, cfn,
                            seed: int = 0,
                            partition_fn: Optional[Callable] = None,
                            slack: float = 2.0,
                            nparts: Optional[int] = None):
    """Fused map-side combine + shuffle: ONE stable sort serves both.

    A row's destination is a function of its key prefix, so one sort by
    ``(validity, destination[, subid], keys)`` yields intact equal-key
    segments whose combined survivors come out destination-ordered;
    bucket slots then follow from running counts, with no second sort.

    Returns ``masked(valid, *cols) -> (recv_valid_mask, overflow, bad,
    out_cols)`` — the contract of ``make_shuffle_fn``'s function with
    the combine applied. ``cols`` =
    nkeys key columns then nvals value columns; with ``nparts >
    nshards`` the out_cols carry the int32 subid column first.
    """
    if nparts is None:
        nparts = nshards
    waved = nparts > nshards
    nsub = -(-nparts // nshards)
    route_bits = (2 * nshards + 2).bit_length()

    def masked(valid, *cols):
        size = cols[0].shape[0]
        device = valid.device
        cap_send = send_capacity(size, nshards if waved else nparts, slack)
        keys = cols[:nkeys]
        vals = cols[nkeys:]
        part, bad, _ = partition_ids(keys, nparts, seed, valid=valid,
                                     partition_fn=partition_fn)
        # Lane nshards parks bad-partitioner rows (valid, counted) and
        # invalid rows (masked); validity leads the sort so they stay
        # apart.
        routable = part < nparts
        if waved:
            dev = torch.where(routable, part % nshards, nshards)
            subid = torch.where(routable, part // nshards, 0)
        else:
            dev = torch.where(routable, part, nshards)
            subid = None
        # Validity and the device lane pack into one operand:
        # invalid * (nshards + 2) + dev keeps their order.
        invalid = (~valid).to(torch.int32)
        route = (invalid * (nshards + 2) + dev).to(torch.int32)
        sort_keys = ((route, subid.to(torch.int32), *keys) if waved
                     else (route, *keys))
        bits = ((route_bits,)
                + ((max(1, (nsub - 1).bit_length()),) if waved else ())
                + (None,) * nkeys)
        s, s_vals = segment.sort_with_payload(sort_keys, len(sort_keys),
                                              vals, bits=bits)
        s_route = s[0]
        s_invalid = (s_route >= nshards + 2).to(torch.int32)
        s_dev = s_route - s_invalid * (nshards + 2)
        s_subid = s[1] if waved else None
        s_keys = s[1 + waved:]

        # Any routing or key change starts a segment (equal keys share
        # their destination, so they never split).
        diff = segment.segment_starts(s, s_invalid == 1, size)
        is_last, red = segment.segmented_combine(diff, s_vals, cfn)
        keep = is_last & (s_invalid == 0)
        keep_i32 = keep.to(torch.int32)

        # Slots without a sort: rows are lane-ordered (the route leads
        # the sort), so a survivor's slot is its survivor rank minus the
        # survivors before its lane, and a lane's count is the survivors
        # between its bounds — no atomics on a few hot counters.
        ex_keep = _exclusive_cumsum(keep_i32)
        bounds = torch.searchsorted(s_route, torch.arange(
            nshards + 2, dtype=torch.int32, device=device))
        before = torch.cat([ex_keep, (ex_keep[-1:] + keep_i32[-1:])
                            if size else ex_keep.new_zeros(1)])[bounds]
        counts_all = before[1:] - before[:-1]
        counts = counts_all[:nshards]
        offset = ex_keep - before[s_dev.to(torch.int64)]
        n_bad = (torch.zeros((), dtype=torch.int32, device=device)
                 if bad is None
                 else (keep & (s_dev == nshards)).sum().to(torch.int32))

        in_bounds = keep & (offset < cap_send) & (s_dev < nshards)
        dest_row = torch.where(in_bounds, s_dev, nshards)
        dest_off = torch.where(in_bounds, offset, 0)
        # Survivor rows hold their segment's full reduction.
        payload = ((s_subid,) if waved else ()) + tuple(s_keys) + tuple(red)
        send_counts = torch.clamp(counts, max=cap_send).to(torch.int32)
        valid_mask, out_cols = bucket_exchange(
            nshards, cap_send, dest_row, dest_off, send_counts, payload)
        overflow = torch.clamp(counts.max() - cap_send, min=0)
        return valid_mask, overflow.to(torch.int32), n_bad, out_cols

    return masked


def all_to_all(planes: torch.Tensor, nmesh: int) -> torch.Tensor:
    """The exchange seam: ``planes[d]`` is what this slot sends to slot
    ``d``; returns what it receives, ``[s]`` from slot ``s``. The
    identity on one slot; else the active mesh's ``all_to_all_single``
    over its process group (``meshutil.all_to_all``)."""
    from bigslice_tpu_torch.parallel import meshutil

    return meshutil.all_to_all(planes, nmesh)


def partition_cols(chunks: Sequence[Sequence[torch.Tensor]],
                   partition: int, nmesh: int,
                   subid: bool) -> List[torch.Tensor]:
    """ONE partition's valid rows from a partitioned group output's
    host chunks ([ncols][ndevice]): partition p lives on device
    ``p % nmesh``; wave-partitioned outputs carry a leading int32 subid
    column selecting ``p // nmesh``."""
    dev_cols = [c[partition % nmesh] for c in chunks]
    if not subid:
        return dev_cols
    sel = torch.nonzero(dev_cols[0] == (partition // nmesh)).squeeze(1)
    return [segment.take(c, sel) for c in dev_cols[1:]]


def partition_chunks(chunks: Sequence[Sequence[torch.Tensor]], nparts: int,
                     nmesh: int, subid: bool) -> List[List[torch.Tensor]]:
    """Every partition's valid rows (``partition_cols``), in partition
    order: the spill exchange's map-side split."""
    return [partition_cols(chunks, p, nmesh, subid) for p in range(nparts)]


class MeshShuffle:
    """A standalone shuffle over the device slots (one here, so
    ``nshards`` is 1): ``__call__(cols, counts)`` with columns of
    ``capacity`` rows and ``counts`` int32[1] valid rows; returns
    ``(out_cols, out_counts, overflow)``, the routed rows front-packed
    into ``out_capacity`` rows. The shuffle body of the executor
    (``make_shuffle_fn``) at kernel granularity; ``device`` (default
    ``cuda``) replaces the JAX package's mesh."""

    def __init__(self, ncols: int, nkeys: int, capacity: int, seed: int = 0,
                 partition_fn=None, slack: float = 2.0, device=None):
        self.device = kernel_device(device, "MeshShuffle")
        self.nshards = 1
        self.ncols = ncols
        self.capacity = capacity
        self.out_capacity = self.nshards * send_capacity(
            capacity, self.nshards, slack)
        self._body = make_shuffle_fn(self.nshards, nkeys, capacity, seed,
                                     partition_fn, slack)

    def __call__(self, cols: Sequence, counts):
        cols = [c.to(self.device) for c in cols]
        counts = torch.as_tensor(counts).to(self.device)
        valid = torch.arange(cols[0].shape[0], device=self.device) < counts[0]
        mask, overflow, _bad, out_cols = self._body(valid, *cols)
        n, packed = segment.compact_by_mask(mask, out_cols)
        return list(packed), n.reshape(1), overflow


class MeshReduceByKey:
    """A standalone keyed reduction over the device slots: the fused
    sort combine + shuffle (``make_combine_shuffle_fn``), then the
    reduce-side segmented reduce, front-packed. ``__call__(key_cols,
    val_cols, counts)`` returns ``(key_cols, val_cols, out_counts,
    overflow)`` of ``out_capacity`` rows; ``device`` (default ``cuda``)
    replaces the JAX package's mesh."""

    def __init__(self, nkeys: int, nvals: int, capacity: int,
                 combine_fn: Callable, seed: int = 0, slack: float = 2.0,
                 device=None):
        self.device = kernel_device(device, "MeshReduceByKey")
        self.nshards = 1
        self.capacity = capacity
        self.out_capacity = self.nshards * send_capacity(
            capacity, self.nshards, slack)
        self.nkeys = nkeys
        cfn = segment.canonical_combine(combine_fn, nvals)
        self._fused = make_combine_shuffle_fn(self.nshards, nkeys, nvals,
                                              cfn, seed, slack=slack)
        self._final = segment.make_segmented_reduce_masked(nkeys, nvals, cfn)

    def __call__(self, key_cols: Sequence, val_cols: Sequence, counts):
        cols = [c.to(self.device) for c in list(key_cols) + list(val_cols)]
        counts = torch.as_tensor(counts).to(self.device)
        valid = torch.arange(cols[0].shape[0], device=self.device) < counts[0]
        recv, overflow, _bad, out = self._fused(valid, *cols)
        nk = self.nkeys
        mask, k, v = self._final(recv, tuple(out[:nk]), tuple(out[nk:]))
        n, packed = segment.compact_by_mask(mask, list(k) + list(v))
        return list(packed[:nk]), list(packed[nk:]), n.reshape(1), overflow
