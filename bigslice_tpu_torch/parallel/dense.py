"""Dense-keyed lowerings: the sort-free reduce, join and fold paths,
and the combine-op classification they share with the hash tables.

When a Reduce's keys are dense int32 codes in ``[0, K)`` —
dictionary encodings, categorical ids, bucketed features — its combine
becomes one scatter-accumulate pass into a ``[K]`` table of
accumulators (``make_dense_combine``), with no sort and no retry. The
same table pass serves the dense join (``make_dense_join``: each side's
table indexed by the key's rank within its partition, the match an
elementwise AND of the presence planes), the dense Fold of an
add/max/min fold fn (``make_dense_fold``) and the fused dense
combine-shuffle (``make_dense_combine_shuffle``: the tables gathered
through a static routing permutation and moved by one exchange).

The routing permutation (``routing_tables``, ``rank_tables``) comes
from the SAME ``partition_ids`` contract as the sorting shuffle — the
``hash_partition`` kernel over ``arange(K)`` on the caller's device —
so key k lands on the same partition under either lowering, bit-equal
to the JAX package's tables.

``classify_combine_ops`` decides whether a combine fn acts per value
column as add, max or min by probing it on random vectors of the actual
value dtypes and trailing shapes, with dtype extremes planted, exactly
as the JAX package probes it; the probe runs the fn under
``torch.func.vmap`` on CPU tensors. These are torch ops on the card as
on the CPU: the JAX package runs them as XLA, not as Pallas kernels.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from bigslice_tpu_torch.slicetype import numpy_dtype, torch_dtype

# Largest declared key space the dense path accepts: beyond this the
# per-shard tables (K rows x nvals columns) start competing with the
# data itself for memory and the sort pipeline wins anyway.
MAX_DENSE_KEYS = 1 << 22

_PROBE_N = 64


def classify_combine_ops(cfn, val_dtypes: Sequence,
                         val_shapes: Optional[Sequence] = None
                         ) -> Optional[Tuple[str, ...]]:
    """Per-column 'add' | 'max' | 'min' of a canonical combine fn, or
    None when any column matches none of them (or the fn cannot run on
    tensors at all). Vector value columns (``val_shapes``) classify
    too: the fn sees one row's [G] vectors."""
    rng = np.random.RandomState(0)
    if val_shapes is None:
        val_shapes = [() for _ in val_dtypes]
    a = [_probe_sample(rng, dt, sh, slot=0)
         for dt, sh in zip(val_dtypes, val_shapes)]
    b = [_probe_sample(rng, dt, sh, slot=1)
         for dt, sh in zip(val_dtypes, val_shapes)]
    if any(x is None for x in a):
        return None
    try:
        out = torch.func.vmap(lambda xs, ys: tuple(cfn(xs, ys)))(
            tuple(torch.from_numpy(x) for x in a),
            tuple(torch.from_numpy(y) for y in b),
        )
        out = [o.numpy() for o in out]
    except Exception:
        return None
    if len(out) != len(a):
        return None
    ops = []
    for x, y, o in zip(a, b, out):
        op = _match_op(o, x, y)
        if op is None:
            return None
        ops.append(op)
    return tuple(ops)


def _probe_sample(rng, dt, shape=(), slot=0):
    """Random sample with dtype extremes planted at disjoint positions
    per operand slot, so range-dependent fns (saturating add, clipped
    add) fail classification."""
    dt = np.dtype(dt)
    full = (_PROBE_N,) + tuple(shape)
    if dt.kind == "f":
        out = (rng.randn(*full) * 8).astype(dt)
        extremes = [np.inf, -np.inf, 0.0, 1e30, -1e30]
    elif dt.kind in "iu":
        lo, hi = (-(1 << 15), 1 << 15) if dt.kind == "i" else (0, 1 << 16)
        out = rng.randint(lo, hi, full).astype(dt)
        info = np.iinfo(dt)
        extremes = [info.min, info.max, 0]
    else:
        return None
    base = slot * len(extremes)
    for i, v in enumerate(extremes):
        out[base + i] = dt.type(v)
    return out


def _match_op(out, x, y):
    """Which of add/max/min does ``out`` equal on this probe pair?"""
    if out.dtype != x.dtype or out.shape != x.shape:
        return None
    with np.errstate(over="ignore", invalid="ignore"):
        if np.array_equal(out, x + y):
            return "add"
    if np.array_equal(out, np.maximum(x, y)):
        return "max"
    if np.array_equal(out, np.minimum(x, y)):
        return "min"
    return None


@functools.lru_cache(maxsize=256)
def classified_ops_cached(fn, nvals: int, val_dtypes: tuple,
                          val_shapes: Optional[tuple] = None
                          ) -> Optional[Tuple[str, ...]]:
    """Memoized classify_combine_ops keyed on the fn object + value
    dtypes and shapes (the cache pins fn)."""
    from bigslice_tpu_torch.parallel import segment

    return classify_combine_ops(
        segment.canonical_combine(fn, nvals), list(val_dtypes),
        list(val_shapes) if val_shapes is not None else None)


def _identity(op: str, dtype) -> np.generic:
    """The identity of ``op`` in numpy ``dtype``: the value a table slot
    holds before any row combines into it."""
    dt = np.dtype(dtype)
    if op == "add":
        return dt.type(0)
    if op == "max":
        return dt.type(-np.inf) if dt.kind == "f" else np.iinfo(dt).min
    if op == "min":
        return dt.type(np.inf) if dt.kind == "f" else np.iinfo(dt).max
    raise ValueError(op)


def identity_table(op: str, dtype: torch.dtype, size: int, device,
                   shape: tuple = ()) -> torch.Tensor:
    """A ``size``-slot table (each slot of trailing ``shape``) of
    ``op``'s identity in ``dtype``."""
    ident = _identity(op, numpy_dtype(dtype))
    host = np.full(1, ident, dtype=numpy_dtype(dtype))
    return torch.from_numpy(host).to(device).expand(
        (size,) + tuple(shape)).contiguous()


def _f32_order_key(bits: torch.Tensor) -> torch.Tensor:
    """int32 key whose signed order is float32 order (-0.0 just below
    +0.0); the map is its own inverse."""
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _scatter_tables(idx, vals, ops, size: int):
    """The plain table pass: per-op identity-initialized [size] tables
    ([size, G...] for a vector value column, whose rows scatter whole),
    one scatter-accumulate per value column (idx == size-1 may serve as
    the caller's drop lane). Returns (present bool[size], tables).

    Semantics are the JAX package's scatter (XLA's sequential
    accumulate): int add wraps mod 2**32; float max/min order -0.0
    below +0.0 and propagate NaN, the last NaN row in index order
    winning a slot. On the card int add/max/min are exact whatever the
    order of the atomics; a float add comes out in the atomics' order
    (within rounding)."""
    device = idx.device
    idx = idx.to(torch.int64)
    # index_fill_ takes the scalar on the host side: no copy, no sync.
    present = torch.zeros(size, dtype=torch.bool,
                          device=device).index_fill_(0, idx, True)
    tables = []
    for v, op in zip(vals, ops):
        tail = tuple(v.shape[1:])
        if tail:
            # A vector column scatters whole rows into a [size, G] table:
            # one row index a row, broadcast over its G lanes, so no
            # [n * G] index is built.
            G = int(np.prod(tail))
            t = _scatter_column(idx, v.reshape(-1, G), op, size)
            tables.append(t.reshape((size,) + tail))
        else:
            tables.append(_scatter_column(idx, v, op, size))
    return present, tables


def _lane_index(idx, v):
    """The row index ``idx`` broadcast over a 2-D ``v``'s lanes (a
    view): scatter_reduce takes one index an element."""
    return idx if v.dim() == 1 else idx[:, None].expand(v.shape)


def _scatter_column(idx, v, op: str, size: int):
    """One column's identity-initialized [size] table, or [size, G] for
    [n, G] rows (each lane combines on its own, as the scalar columns
    do)."""
    t = identity_table(op, v.dtype, size, idx.device, tuple(v.shape[1:]))
    if v.dtype == torch.float32 and op != "add":
        return _scatter_extreme_f32(t, idx, v, op)
    red = "amax" if op == "max" else "amin"
    if v.dtype == torch.uint32:
        # uint32 lanes ride int32 bits: add wraps identically; the sign
        # flip makes signed max/min order unsigned values.
        ti = t.view(torch.int32)
        vi = v.view(torch.int32)
        if op == "add":
            ti = ti.index_add(0, idx, vi)
        else:
            flip = -(2 ** 31)
            ti = (ti ^ flip).scatter_reduce(
                0, _lane_index(idx, vi), vi ^ flip, red) ^ flip
        return ti.view(torch.uint32)
    if op == "add":
        return t.index_add(0, idx, v)
    return t.scatter_reduce(0, _lane_index(idx, v), v, red)


def _pair_extreme(a, b, op: str):
    """``op`` ('max'|'min') of ``a`` and ``b`` elementwise with XLA's
    float semantics, which torch's maximum/minimum do not keep bit for
    bit: -0.0 orders below +0.0 and a NaN operand propagates with its
    own bits (the first operand's first)."""
    if a.dtype != torch.float32:
        return torch.maximum(a, b) if op == "max" else torch.minimum(a, b)
    ka = _f32_order_key(a.view(torch.int32))
    kb = _f32_order_key(b.view(torch.int32))
    k = torch.maximum(ka, kb) if op == "max" else torch.minimum(ka, kb)
    out = _f32_order_key(k).view(torch.float32)
    out = torch.where(torch.isnan(b), b, out)
    return torch.where(torch.isnan(a), a, out)


def _scatter_extreme_f32(t, idx, v, op):
    bits = v.view(torch.int32)
    nan = torch.isnan(v)
    tk = _f32_order_key(t.view(torch.int32))
    red = "amax" if op == "max" else "amin"
    if v.dim() == 1:
        ok = ~nan
        tk = tk.scatter_reduce(0, idx[ok], _f32_order_key(bits[ok]), red)
    else:
        # A NaN lane scatters the identity's key, which moves nothing.
        src = torch.where(nan, tk[:1].expand(v.shape), _f32_order_key(bits))
        tk = tk.scatter_reduce(0, _lane_index(idx, v), src, red)
    out = _f32_order_key(tk)
    if bool(nan.any()):
        rows = torch.arange(v.shape[0], device=v.device)
        if v.dim() == 1:
            rows = rows[nan]
            last = torch.full_like(out, -1, dtype=torch.int64).scatter_reduce(
                0, idx[rows], rows, "amax"
            )
            hit = last >= 0
            out = torch.where(hit, bits[last.clamp(min=0)], out)
        else:
            rows = torch.where(nan, rows[:, None], -1)
            last = torch.full_like(out, -1, dtype=torch.int64).scatter_reduce(
                0, _lane_index(idx, v), rows, "amax")
            hit = last >= 0
            out = torch.where(hit, torch.gather(bits, 0, last.clamp(min=0)),
                              out)
    return out.view(torch.float32)


# -- the static routing tables -----------------------------------------------


def _device_key(device) -> str:
    return str(torch.device(device))


@functools.lru_cache(maxsize=32)
def _routing_tables(K: int, nparts: int, seed: int, device: str):
    from bigslice_tpu_torch.parallel import shuffle as shuffle_mod

    keys = torch.arange(K, dtype=torch.int32, device=device)
    part, _, _ = shuffle_mod.partition_ids((keys,), nparts, seed)
    part = part.cpu().numpy()  # the one readback
    order = np.argsort(part, kind="stable")
    counts = np.bincount(part, minlength=nparts)[:nparts]
    maxc = max(int(counts.max()) if K else 0, 1)
    slot_table = np.full((nparts, maxc), K, dtype=np.int32)
    start = 0
    for p in range(nparts):
        c = int(counts[p])
        slot_table[p, :c] = order[start : start + c]
        start += c
    slot_table.setflags(write=False)
    return slot_table, maxc


def routing_tables(K: int, nparts: int, seed: int, device="cpu"
                   ) -> Tuple[np.ndarray, int]:
    """Static slot routing: ``slot_table[p]`` lists the keys owned by
    partition p in key order (padded with the ``K`` sentinel), under the
    SAME hash-routing contract as the sorting shuffle: ``partition_ids``
    over ``arange(K)`` on ``device`` (the ``hash_partition`` kernel on
    the card), read back once. Cached per (K, nparts, seed, device).
    Returns (slot_table int32[nparts, maxc], maxc)."""
    return _routing_tables(int(K), int(nparts), int(seed),
                           _device_key(device))


@functools.lru_cache(maxsize=32)
def _rank_tables(K: int, nparts: int, seed: int, device: str):
    slot_table, maxc = _routing_tables(K, nparts, seed, device)
    pid = np.empty(K, dtype=np.int32)
    rank = np.empty(K, dtype=np.int32)
    for p in range(nparts):
        slots = slot_table[p]
        valid = slots != K
        pid[slots[valid]] = p
        rank[slots[valid]] = np.flatnonzero(valid).astype(np.int32)
    pid.setflags(write=False)
    rank.setflags(write=False)
    return pid, rank, maxc


def rank_tables(K: int, nparts: int, seed: int, device="cpu"):
    """Static inverse routing: for key k, ``pid[k]`` is its owning
    partition and ``rank[k]`` its slot position within that partition's
    ``slot_table`` row. Returns (pid int32[K], rank int32[K], maxc)."""
    return _rank_tables(int(K), int(nparts), int(seed), _device_key(device))


@functools.lru_cache(maxsize=32)
def _tables_on(K: int, nparts: int, seed: int, device: str):
    """The routing and rank tables as tensors on ``device``."""
    slot_table, maxc = _routing_tables(K, nparts, seed, device)
    pid, rank, _ = _rank_tables(K, nparts, seed, device)
    return (torch.from_numpy(slot_table.copy()).to(device),
            torch.from_numpy(pid.copy()).to(device),
            torch.from_numpy(rank.copy()).to(device), maxc)


# -- the dense lowerings ----------------------------------------------------


def make_dense_combine(K: int, ops: Tuple[str, ...]):
    """Shuffle-free dense combine (a single partition, or the reduce
    side): one scatter-accumulate pass into a [K] table, unpacked to
    (key, vals) rows under a presence mask. ``masked(valid, keys,
    vals) -> (mask, (key,), vals)`` — ``make_segmented_reduce_masked``'s
    contract, with K output rows instead of the input's."""

    def masked(valid, keys, vals):
        (key,) = keys
        in_range = (key >= 0) & (key < K)
        # Out-of-range keys route to the drop lane; the CALLER counts
        # them into the pipeline's bad signal, so that declared-range
        # violations fail the run instead of dropping rows.
        idx = torch.where(valid & in_range, key, K)
        present, tables = _scatter_tables(idx, vals, ops, K + 1)
        out_key = torch.arange(K, dtype=torch.int32, device=key.device)
        return present[:K], (out_key,), tuple(t[:K] for t in tables)

    return masked


def make_dense_join(K: int, ops_a: Tuple[str, ...], ops_b: Tuple[str, ...],
                    nparts: int, seed: int = 0, me: Optional[int] = None):
    """Sort-free aggregating inner join for dense-coded keys: each side
    scatter-accumulates into a [maxc] table indexed by the static
    within-partition rank of its keys (partition ``me`` holds exactly
    its keys, by the shared routing contract), and the match is an
    elementwise AND of the presence planes — no segmented reduces, no
    alignment sort.

    Returns ``join(mask_a, cols_a, mask_b, cols_b) -> (mask, cols,
    bad)`` with cols = (key, *vals_a, *vals_b), each of maxc
    (``routing_tables(K, nparts, seed)[1]``) rows; ``bad`` counts rows
    whose key is outside [0, K) or owned by another partition (either
    violates the declared contract). The tables are built on the
    inputs' device at the first call. ``me`` is this partition (default
    the active mesh's slot, reference :289); ``bad`` is this slot's
    term, summed over the mesh by the executor (reference :297)."""
    from bigslice_tpu_torch.parallel import meshutil

    def side(mask, key, vals, ops, pid, rank, maxc, me):
        in_range = (key >= 0) & (key < K)
        safe_key = torch.where(in_range, key, 0).to(torch.int64)
        owned = in_range & (pid[safe_key] == me)
        bad = (mask & ~owned).sum().to(torch.int32)
        idx = torch.where(mask & owned, rank[safe_key], maxc)
        present, tables = _scatter_tables(idx, vals, ops, maxc + 1)
        return present[:maxc], [t[:maxc] for t in tables], bad

    def join(mask_a, cols_a, mask_b, cols_b):
        slot_table, pid, rank, maxc = _tables_on(
            K, nparts, seed, _device_key(mask_a.device))
        mine = meshutil.axis_index() if me is None else me
        pa, ta, bad_a = side(mask_a, cols_a[0], cols_a[1:], ops_a, pid,
                             rank, maxc, mine)
        pb, tb, bad_b = side(mask_b, cols_b[0], cols_b[1:], ops_b, pid,
                             rank, maxc, mine)
        my_slots = slot_table[mine]
        mask = pa & pb & (my_slots != K)
        return mask, [my_slots, *ta, *tb], bad_a + bad_b

    return join


@functools.lru_cache(maxsize=256)
def classified_fold_op_cached(fn, acc_dtype, val_dtype) -> Optional[str]:
    """Classify a fold fn ``fn(acc, v) -> acc`` as 'add'|'max'|'min' by
    the same vmap probe (None: the sequential fold runs). A classified
    fold op is associative and commutative, so scatter order is
    immaterial — except for a float add, which reassociates: the
    sequential fold honours it bit for bit, so float sums stay off the
    dense path (max/min are exact in any order, NaN included)."""
    rng = np.random.RandomState(0)
    accd, vald = np.dtype(acc_dtype), np.dtype(val_dtype)
    acc, v = _probe_sample(rng, accd), _probe_sample(rng, vald)
    if acc is None or v is None:
        return None
    try:
        out = torch.func.vmap(fn)(torch.from_numpy(acc),
                                  torch.from_numpy(v)).numpy()
    except Exception:
        return None
    op = _match_op(out, acc, v.astype(accd))
    if op == "add" and accd.kind == "f":
        return None
    return op


def make_dense_fold(K: int, op: str, acc_dtype, init_val):
    """Sort-free dense Fold for a classified (associative) fold fn:
    scatter-accumulate into a [K] table, then apply the fold's init
    through the op (``acc = op(init, fold(vals))`` — exactly the
    sequential result for an associative, commutative op). The contract
    of ``make_sequential_fold_masked``'s core."""
    acc_t = torch_dtype(acc_dtype)

    def masked(valid, keys, vals):
        (key,) = keys
        (v,) = vals
        in_range = (key >= 0) & (key < K)
        idx = torch.where(valid & in_range, key, K)
        present, (table,) = _scatter_tables(idx, [v.to(acc_t)], [op], K + 1)
        table = table[:K]
        init = torch.tensor(init_val, dtype=acc_t, device=key.device)
        acc = table + init if op == "add" else _pair_extreme(table, init, op)
        out_key = torch.arange(K, dtype=torch.int32, device=key.device)
        return present[:K], (out_key,), (acc,)

    return masked


def make_dense_combine_shuffle(nmesh: int, K: int, ops: Tuple[str, ...],
                               seed: int = 0, me: Optional[int] = None):
    """The fused dense combine + shuffle: per-shard dense tables (one
    scatter-accumulate pass), gathered through the static routing
    permutation into [nmesh, maxc] planes and moved by ONE exchange
    (``shuffle.all_to_all``), then reduced elementwise over the
    received planes. ``masked(valid, key, *vals) -> (recv_mask,
    overflow, bad, out_cols)`` — ``make_combine_shuffle_fn``'s contract
    (out_cols = key column then value columns, front-packing left to
    the caller's compaction), each of ``routing_tables(K, nmesh,
    seed)[1]`` rows. The tables are built on the inputs' device at the
    first call. ``me`` is this slot (default the active mesh's,
    reference :413); ``bad`` is this slot's term, summed over the mesh
    by the executor at settle (reference :384)."""
    from bigslice_tpu_torch.parallel import meshutil
    from bigslice_tpu_torch.parallel import shuffle as shuffle_mod

    def masked(valid, key, *vals):
        slot_table, _, _, maxc = _tables_on(K, nmesh, seed,
                                            _device_key(valid.device))
        in_range = (key >= 0) & (key < K)
        bad = (valid & ~in_range).sum().to(torch.int32)
        idx = torch.where(valid & in_range, key, K)
        # 1. Per-shard dense tables (the K-th row is the drop lane).
        present, tables = _scatter_tables(idx, vals, ops, K + 1)
        gather = slot_table.reshape(-1).to(torch.int64)

        # 2. Gather through the static routing permutation, then one
        # exchange: device p receives every shard's partition-p plane.
        def route(x):
            planes = x[gather].reshape((nmesh, maxc) + tuple(x.shape[1:]))
            return shuffle_mod.all_to_all(planes, nmesh)

        recv_present = route(present)
        # 3. Elementwise reduce over the shard planes (one plane on one
        # device).
        out_vals = []
        for t, op in zip(tables, ops):
            r = route(t)
            red = r[0]
            for q in range(1, nmesh):
                red = (red + r[q] if op == "add"
                       else _pair_extreme(red, r[q], op))
            out_vals.append(red)
        my_slots = slot_table[meshutil.axis_index() if me is None else me]
        mask = recv_present.any(0) & (my_slots != K)
        zero = torch.zeros((), dtype=torch.int32, device=valid.device)
        return mask, zero, bad, (my_slots, *out_vals)

    return masked
