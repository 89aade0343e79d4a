"""Open-addressed hash aggregation on the device: sortless keyed combine.

The device analog of a combining hash table that absorbs rows as they
arrive: each distinct key claims a slot of an open-addressed table,
probing by double hashing, and every row combines its values into its
key's slot by the classified op (add/max/min — parallel/dense.py).

    map side     hash_aggregate into a destination-contiguous table
    exchange     the table's regions ARE the partitions, so routing is
                 one all_to_all of table regions (parallel/shuffle.py)
    reduce side  hash_aggregate again over the received rows

Slot layout: ``slot = part * R + probe`` where ``part`` comes from THE
routing contract (shuffle.partition_ids), so region ``p`` holds exactly
the keys of partition ``p``. The table build is the ``hash_aggregate``
kernel on the card (parallel/cuda_kernels.py) and, on the CPU, its plain
version: ``claim_cascade`` below (batched scatter-min claim rounds, the
JAX package's XLA lowering, slot for slot) plus the identity-initialized
scatter-accumulate of ``dense._scatter_tables``.

A table that cannot place every row (load factor near 1, adversarial
collisions) reports it as ``overflow``: the executor discards the
result and reruns the wave on the sort lowering (parallel/segment.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bigslice_tpu_torch.parallel.jitutil import bucket_size, kernel_device

# Claim-cascade shape: FULL_ROUNDS full-width probe rounds, then the
# pending stragglers compact into a size/CASCADE_DIV buffer where up to
# CASCADE_MAX_ROUNDS more rounds probe; the rest count as overflow.
FULL_ROUNDS = 2
CASCADE_DIV = 4
CASCADE_MAX_ROUNDS = 48

#: Slot-hash seed stream, independent of the routing hash's, so a
#: partition's keys spread over its region instead of clustering on
#: their shared routing residue.
SLOT_SEED_XOR = 0x51ED2770

_BIG = 2**31 - 1

#: Rows that claim no slot in a round scatter the no-op value into one
#: of this many lanes past the table, spread by row index: aimed at one
#: drop slot, a million rows serialize on its atomic (on the card).
DROP_LANES = 1024


def _slot_hash(key_cols, seed: int) -> torch.Tensor:
    """Within-region slot hash (uint32 lanes carried in int64)."""
    from bigslice_tpu_torch.frame import ops as frame_ops

    h = None
    for k in key_cols:
        kh = frame_ops.hash_device_column(k, seed ^ SLOT_SEED_XOR)
        h = kh if h is None else frame_ops.combine_hashes(h, kh)
    return h


def _key_lanes(k: torch.Tensor) -> torch.Tensor:
    # uint32 has no CPU comparison kernels: compare its int32 bits.
    return k.view(torch.int32) if k.dtype == torch.uint32 else k


def claim_cascade(valid, key_cols, part, nparts: int, R: int,
                  seed: int = 0):
    """Assign one table slot per distinct key of the selected rows.

    ``part`` (int32[n], sentinel >= nparts excluded) picks the region;
    probing stays inside the region. ``R`` must be a power of two.

    Returns ``(winner, placed, overflow)``: ``winner`` int64[T+1]
    (T = nparts*R) holding the claiming row index per slot (or
    INT32_MAX), ``placed`` int64[n] each row's slot (-1 for excluded or
    unresolved rows), ``overflow`` the number of rows the cascade could
    not place.
    """
    dev = key_cols[0].device
    n = key_cols[0].shape[0]
    T = nparts * R
    mask_R = R - 1
    keys = [_key_lanes(k) for k in key_cols]
    h = _slot_hash(key_cols, seed)
    off = h & mask_R
    # Double hashing: an odd stride is coprime with the pow2 region, so
    # the probe sequence visits every slot.
    stride = ((h >> 9) | 1) & mask_R
    part = part.to(torch.int64)
    in_range = part < nparts
    base = torch.where(in_range, part, nparts) * R
    pending = valid & in_range
    iota = torch.arange(n, device=dev)
    big = torch.full((), _BIG, dtype=torch.int64, device=dev)
    # Slots [T, T + DROP_LANES) take the rows that claim nothing; only
    # the first T + 1 are returned (slot T is never claimed).
    winner = torch.full((T + DROP_LANES,), _BIG, dtype=torch.int64,
                        device=dev)
    drop = T + (iota & (DROP_LANES - 1))
    placed = torch.full((n,), -1, dtype=torch.int64, device=dev)

    for _ in range(FULL_ROUNDS):
        slot = base + off
        # Claim only EMPTY slots: a slot claimed in an earlier round is
        # frozen. Within-round races resolve by scatter-min; losers
        # re-probe.
        slot_c = slot.clamp(max=T - 1)
        empty = winner[slot_c] == _BIG
        cand = torch.where(pending & empty, slot, drop)
        winner = winner.scatter_reduce(
            0, cand, torch.where(pending, iota, big), "amin")
        win = winner[slot_c]
        eq = win < n
        winc = win.clamp(max=n - 1)
        for kc in keys:
            eq = eq & (kc[winc] == kc)
        matched = pending & eq
        placed = torch.where(matched, slot, placed)
        pending = pending & ~matched
        off = torch.where(pending, (off + stride) & mask_R, off)

    # Compact the stragglers' row ids into a quarter-width buffer.
    C = max(n // CASCADE_DIV, 1)
    pi = pending.to(torch.int64)
    rank = torch.cumsum(pi, 0) - pi
    overflow = (pi.sum() - C).clamp(min=0)
    dest = torch.where(pending & (rank < C), rank, C)
    ridx = torch.full((C + 1,), n, dtype=torch.int64, device=dev)
    ridx = ridx.scatter(0, dest, torch.where(pending, iota, n))[:C]

    def gat(x, fill):
        v = x[ridx.clamp(max=n - 1)]
        return torch.where(ridx < n, v, fill)

    offc = gat(off, 0)
    basec = gat(base, T)
    stridec = gat(stride, 1)
    dropc = T + (torch.arange(C, device=dev) & (DROP_LANES - 1))
    rounds = 0
    while rounds < CASCADE_MAX_ROUNDS and bool((ridx < n).any()):
        act = ridx < n
        slot = (basec + offc).clamp(max=T)
        slot_c = slot.clamp(max=T - 1)
        empty = winner[slot_c] == _BIG
        cand = torch.where(act & empty, slot, dropc)
        winner = winner.scatter_reduce(
            0, cand, torch.where(act, ridx, big), "amin")
        win = winner[slot_c]
        eq = win < n
        winc = win.clamp(max=n - 1)
        rc = ridx.clamp(max=n - 1)
        for kc in keys:
            eq = eq & (kc[winc] == kc[rc])
        matched = act & eq
        placed[rc[matched]] = slot[matched]
        ridx = torch.where(matched, n, ridx)
        offc = torch.where(act & ~matched, (offc + stridec) & mask_R, offc)
        rounds += 1
    overflow = overflow + (ridx < n).sum()
    return winner[:T + 1], placed, overflow.to(torch.int32)


def hash_aggregate(valid, key_cols, val_cols, ops: Sequence[str],
                   part, nparts: int, R: int, seed: int = 0):
    """Aggregate the selected rows by key into a [nparts*R] open table.

    Returns ``(present, out_keys, out_vals, overflow)`` — slot-resident
    results: ``present`` bool[T], key/value columns [T] (junk where not
    present), ``overflow`` an int32 0-d tensor counting unplaced rows.
    The ``hash_aggregate`` kernel builds the table on the card; its
    plain version on the CPU.
    """
    from bigslice_tpu_torch.parallel import cuda_kernels

    return cuda_kernels.hash_aggregate(valid, key_cols, val_cols, ops,
                                       part, nparts, R, seed)


def combine_region_size(size: int, nparts: int) -> int:
    """Power-of-two region size for an input of ``size`` rows split over
    ``nparts`` partitions: the table matches the input's row budget
    (load factor <= 1; far lower after map-side reduction)."""
    return bucket_size(max(1, -(-size // nparts)))


def make_hash_combine(nkeys: int, nvals: int, ops: Sequence[str],
                      seed: int = 0):
    """The reduce-side combine: ``core(valid, key_cols, val_cols) ->
    (mask, keys, vals, overflow)`` with results slot-resident in a
    bucket_size(n) table (hash-ordered, which no consumer observes)."""

    def core(valid, key_cols, val_cols):
        n = key_cols[0].shape[0]
        R = bucket_size(n)
        part = torch.zeros(n, dtype=torch.int32, device=valid.device)
        present, ok, ovs, ov = hash_aggregate(
            valid, tuple(key_cols), tuple(val_cols), ops, part, 1, R, seed,
        )
        return present, tuple(ok), tuple(ovs), ov

    return core


def make_hash_combine_shuffle(nmesh: int, nkeys: int, nvals: int,
                              ops: Sequence[str], seed: int = 0,
                              nparts: Optional[int] = None):
    """Fused map-side combine + shuffle with zero sorts.

    Returns ``masked(valid, *cols) -> (recv_mask, overflow, out_cols)``
    with out_cols = [subid?] + keys + vals of nmesh*W*R rows per device
    (W = wave count when partitions outnumber the devices; the subid
    column leads and says which of a device's W partitions a row
    belongs to). ``overflow`` > 0 means the table could not place every
    row: the caller must discard the result. It is this slot's term;
    the executor sums it over the mesh at settle (the JAX package's
    psum, reference :362-373). ``nparts`` need not divide the mesh.
    """
    from bigslice_tpu_torch.parallel import shuffle as shuffle_mod

    if nparts is None:
        nparts = nmesh
    # Partitions pad up to whole waves of the mesh (reference
    # :351-356): the padding regions are empty planes.
    W = -(-nparts // nmesh)

    def masked(valid, *cols):
        size = cols[0].shape[0]
        keys = cols[:nkeys]
        vals = cols[nkeys:]
        part, _, _ = shuffle_mod.partition_ids(keys, nparts, seed,
                                            valid=valid)
        R = combine_region_size(size, nparts)
        present, ok, ovs, ov = hash_aggregate(
            valid, keys, vals, ops, part, nparts, R, seed,
        )

        def route(x):
            # Region p -> slot p % nmesh carrying subid p // nmesh:
            # regroup regions slot-major so the exchange hands each
            # slot its own W regions from every source.
            rest = tuple(x.shape[1:])
            planes = x.reshape((nparts, R) + rest)
            if nparts < nmesh * W:
                planes = torch.cat([planes, planes.new_zeros(
                    (nmesh * W - nparts, R) + rest)])
            planes = planes.reshape((W, nmesh, R) + rest)
            planes = planes.transpose(0, 1).reshape((nmesh, W * R) + rest)
            recv = shuffle_mod.all_to_all(planes, nmesh)
            return recv.reshape((nmesh * W * R,) + rest)

        recv_mask = route(present)
        out_cols = [route(c) for c in list(ok) + list(ovs)]
        if W > 1:
            subid = torch.arange(W, dtype=torch.int32, device=valid.device)
            out_cols = [subid.repeat_interleave(R).repeat(nmesh)] + out_cols
        return recv_mask, ov, tuple(out_cols)

    return masked


def make_hash_join_align(nkeys: int, ops_a: Sequence[str],
                         ops_b: Sequence[str], seed: int = 0):
    """Sortless aggregating inner join: ONE claim cascade over the union
    of both sides' rows gives every distinct key a slot, each side
    scatter-accumulates into its own value tables, and the match is an
    elementwise AND of the two presence planes — in place of the two
    segmented reduces and the tagged alignment sort of the sort path
    (``parallel/join.make_align``).

    ``align(mask_a, cols_a, mask_b, cols_b) -> (mask, cols, overflow)``
    with cols = (keys..., vals_a..., vals_b...) of bucket_size(nA+nB)
    slot-resident rows. These are torch ops on the card as on the CPU:
    the JAX package runs this step as XLA, not as a Pallas kernel.
    """
    from bigslice_tpu_torch.parallel.dense import _scatter_tables
    from bigslice_tpu_torch.parallel.segment import take

    def align(mask_a, cols_a, mask_b, cols_b):
        ka, va = cols_a[:nkeys], cols_a[nkeys:]
        kb, vb = cols_b[:nkeys], cols_b[nkeys:]
        na = ka[0].shape[0]
        n = na + kb[0].shape[0]
        keys = tuple(torch.cat([a, b]) for a, b in zip(ka, kb))
        valid = torch.cat([mask_a, mask_b])
        R = bucket_size(n)
        part = torch.zeros(n, dtype=torch.int32, device=valid.device)
        winner, placed, ov = claim_cascade(valid, keys, part, 1, R, seed)

        def side(placed_side, vals, ops):
            # Unplaced rows land in the drop slot R.
            idx = torch.where(placed_side >= 0, placed_side, R)
            present, tables = _scatter_tables(idx, list(vals), list(ops),
                                              R + 1)
            return present[:R], [t[:R] for t in tables]

        pa, ta = side(placed[:na], va, ops_a)
        pb, tb = side(placed[na:], vb, ops_b)
        winc = torch.clamp(winner[:R], max=n - 1)
        out_keys = [take(kc, winc) for kc in keys]
        return pa & pb, out_keys + ta + tb, ov

    return align


class MeshHashReduceByKey:
    """A standalone keyed reduction with zero sorts over the device
    slots: the fused hash combine + exchange of table regions
    (``make_hash_combine_shuffle``: the ``hash_partition`` and
    ``hash_aggregate`` kernels on the card), the reduce-side hash
    re-combine (``hash_aggregate`` again), front-packed. The
    counterpart of ``shuffle.MeshReduceByKey`` for classified ops
    ('add'|'max'|'min' per value column). ``__call__(key_cols, val_cols,
    counts)`` returns ``(key_cols, val_cols, out_counts, overflow)`` of
    ``out_capacity`` rows; ``overflow`` > 0 means a table could not
    place every row: discard the result and use the sort reduction.
    ``device`` (default ``cuda``) replaces the JAX package's mesh."""

    def __init__(self, nkeys: int, nvals: int, capacity: int,
                 ops: Sequence[str], seed: int = 0, device=None):
        self.device = kernel_device(device, "MeshHashReduceByKey")
        self.nshards = 1
        self.capacity = capacity
        self.nkeys = nkeys
        self.out_capacity = bucket_size(
            self.nshards * combine_region_size(capacity, self.nshards))
        self._fused = make_hash_combine_shuffle(self.nshards, nkeys, nvals,
                                                tuple(ops), seed)
        self._final = make_hash_combine(nkeys, nvals, tuple(ops), seed)

    def __call__(self, key_cols: Sequence, val_cols: Sequence, counts):
        from bigslice_tpu_torch.parallel.segment import compact_by_mask

        cols = [c.to(self.device) for c in list(key_cols) + list(val_cols)]
        counts = torch.as_tensor(counts).to(self.device)
        valid = torch.arange(cols[0].shape[0], device=self.device) < counts[0]
        recv, ov1, out = self._fused(valid, *cols)
        nk = self.nkeys
        mask, k, v, ov2 = self._final(recv, tuple(out[:nk]),
                                      tuple(out[nk:]))
        n, packed = compact_by_mask(mask, list(k) + list(v))
        return (list(packed[:nk]), list(packed[nk:]), n.reshape(1),
                ov1 + ov2)
