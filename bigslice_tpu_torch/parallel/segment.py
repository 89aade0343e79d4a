"""Device-tier keyed reduction: sort + segmented associative scan.

Rows are stably sorted by key (``sort_with_payload``), segment
boundaries are found by adjacent-key comparison (``sort_and_segment``)
and an arbitrary *associative* combine fn is applied per segment by a
segmented associative scan (``segmented_combine``). This is the
lowering of every combine fn the hash aggregation cannot serve: fns
that do not classify as add/max/min, float keys, and tables that
overflowed.

The JAX package writes this with ``lax.sort`` and
``lax.associative_scan``; here both are torch ops, with the same
results bit for bit:

- the sort orders keys as ``lax.sort`` does: -0.0 and +0.0 equal,
  every NaN last, ties in input order;
- the scan is JAX's own recursion (pairs combined in the same order,
  and the interleave's addition that turns every -0.0 into +0.0).

``DeviceReduceByKey`` runs the count-based core over one frame's
columns (the local executor's device combine). A Fold's function need
not be associative: ``make_sequential_fold_masked`` folds each key's
rows in order, one step a rank of every group at once
(``DeviceSortedFold`` over one frame). The host half,
``host_reduce_by_key`` and ``grouped_reduceat``, combines host keys and
combine fns that are not tensor functions: a lexsort and one
``ufunc.reduceat`` a column when the fn classifies as add/max/min, a
dict pass otherwise.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from bigslice_tpu_torch.parallel.jitutil import bucket_size, pad_cols


def canonical_combine(fn: Callable, nvals: int) -> Callable:
    """Normalize a user combine fn to ``cfn(a_tuple, b_tuple) -> tuple``.
    Single-value-column reduces use the natural ``fn(a, b) -> v`` form."""
    if nvals == 1:
        return lambda a, b: (fn(a[0], b[0]),)

    def cfn(a, b):
        out = fn(a, b)
        if not isinstance(out, tuple):
            out = tuple(out)
        return out

    return cfn


def take(col, idx):
    """``col[idx]`` for any device column dtype (uint32 gathers through
    its int32 bits: PyTorch has no uint32 gather kernels)."""
    if col.dtype == torch.uint32:
        return col.view(torch.int32)[idx].view(torch.uint32)
    return col[idx]


_SIGNED_VIEW = {torch.uint32: torch.int32, torch.uint16: torch.int16}


def eq_lanes(col):
    """``col`` viewed so that ``==``/``!=`` run on it: unsigned 16/32-bit
    columns compare through their signed bits (no CPU kernels for
    them); floats stay floats (NaN != NaN, -0.0 == +0.0)."""
    view = _SIGNED_VIEW.get(col.dtype)
    return col if view is None else col.view(view)


def _order_key(k, bits: Optional[int]):
    """(non-negative int64 ``u``, width ``w``): ``u`` orders as
    ``lax.sort`` orders ``k`` and fits in ``w`` bits. ``bits`` declares
    ``k`` a non-negative integer below ``2**bits``."""
    if bits is not None:
        return k.to(torch.int64), bits
    dt = k.dtype
    if dt == torch.bool:
        return k.to(torch.int64), 1
    if dt.is_floating_point:
        w = 8 * k.element_size()
        # lax.sort's canonical floats: -0.0 onto +0.0, every NaN onto one
        # positive NaN (which orders after +inf).
        k = torch.where(k == 0, torch.zeros_like(k), k)
        k = torch.where(torch.isnan(k), torch.full_like(k, float("nan")), k)
        mask = (1 << w) - 1
        sign = 1 << (w - 1)
        b = k.view(torch.int32 if w == 32 else torch.int16)
        b = b.to(torch.int64) & mask
        # Negative floats order by inverted bits, others above them.
        return torch.where((b & sign) != 0, b ^ mask, b | sign), w
    w = 8 * k.element_size()
    if dt in _SIGNED_VIEW:
        return k.view(_SIGNED_VIEW[dt]).to(torch.int64) & ((1 << w) - 1), w
    if dt == torch.uint8:
        return k.to(torch.int64), w
    return k.to(torch.int64) + (1 << (w - 1)), w


def sort_permutation(sort_keys, bits=None):
    """The stable lexicographic sort permutation of rows keyed by
    ``sort_keys`` (first most significant), int64[n].

    Torch has no multi-operand sort: each key becomes an
    order-preserving non-negative integer (``_order_key``); consecutive
    keys pack into one int64 while their widths fit 63 bits (one int32
    when they fit 31), and the groups sort least significant first with
    stable sorts, carrying the permutation."""
    if bits is None:
        bits = (None,) * len(sort_keys)
    groups, cur, cur_w = [], None, 0
    for k, b in zip(sort_keys, bits):
        u, w = _order_key(k, b)
        if cur is not None and cur_w + w <= 63:
            cur, cur_w = (cur << w) | u, cur_w + w
        else:
            if cur is not None:
                groups.append((cur, cur_w))
            cur, cur_w = u, w
    groups.append((cur, cur_w))
    perm = None
    for g, w in reversed(groups):
        if w <= 31:
            g = g.to(torch.int32)
        if perm is not None:
            g = g[perm]
        _, idx = torch.sort(g, stable=True)
        perm = idx if perm is None else perm[idx]
    return perm


def sort_with_payload(sort_keys, num_keys: int, payload, bits=None):
    """Stable-sort rows by ``sort_keys`` (scalar int/float columns)
    carrying ``payload`` columns along — the shared idiom of every keyed
    kernel. ``bits`` optionally declares, per key, that it is a
    non-negative integer below ``2**bits`` (None: the dtype's full
    width), which lets more keys share one sort pass. Payload columns,
    vector ones included, move with one gather each. Returns
    (sorted_key_tuple, sorted_payload_tuple)."""
    sort_keys = tuple(sort_keys)[:num_keys]
    perm = sort_permutation(sort_keys, bits)
    return (tuple(take(k, perm) for k in sort_keys),
            tuple(take(c, perm) for c in payload))


def sort_and_segment(nkeys: int, valid_mask, key_cols, payload):
    """Shared prelude for keyed kernels: stable-sort rows by (validity,
    keys) with payload columns riding along, and mark segment starts
    (row 0, any key change, validity change; invalid rows isolate into
    their own segments). Returns (s_invalid, s_keys, s_payload, diff)."""
    size = key_cols[0].shape[0]
    invalid = (~valid_mask).to(torch.int32)
    sorted_keys, s_payload = sort_with_payload(
        (invalid,) + tuple(key_cols), 1 + nkeys, payload,
        bits=(1,) + (None,) * nkeys,
    )
    s_invalid = sorted_keys[0]
    s_keys = sorted_keys[1:]
    return s_invalid, s_keys, s_payload, segment_starts(
        (s_invalid,) + tuple(s_keys), s_invalid == 1, size)


def segment_starts(sorted_keys, isolate, size: int):
    """bool[size]: row 0, every row whose key differs from the row
    before (``!=``, so every NaN starts a segment of its own), and every
    ``isolate`` row."""
    diff = torch.zeros(size, dtype=torch.bool, device=isolate.device)
    if size:
        diff[0] = True
    for k in sorted_keys:
        k = eq_lanes(k)
        diff[1:] |= k[1:] != k[:-1]
    return diff | isolate


def compact_by_mask(mask, cols):
    """Front-compact the rows selected by ``mask``, keeping their order.
    Returns (count int32 0-d tensor, cols) with every column at its
    input length: survivors first, zeros after (callers read ``count``
    rows)."""
    cols = tuple(cols)
    idx = torch.nonzero(mask).squeeze(1)
    k = idx.shape[0]
    out = []
    for c in cols:
        buf = torch.zeros_like(c)
        buf[:k] = take(c, idx)
        out.append(buf)
    return torch.tensor(k, dtype=torch.int32, device=mask.device), tuple(out)


def compact_to_bucket(mask, cols):
    """``compact_by_mask`` into buffers of ``bucket_size(count)`` rows
    (at least 8) instead of the input's length: an output whose size
    follows its valid rows, not the table or buffer it came from."""
    idx = torch.nonzero(mask).squeeze(1)
    k = idx.shape[0]
    cap = bucket_size(k)
    out = []
    for c in cols:
        buf = c.new_zeros((cap,) + tuple(c.shape[1:]))
        buf[:k] = take(c, idx)
        out.append(buf)
    return torch.full((), k, dtype=torch.int32, device=mask.device), tuple(out)


def _interleave(a, b):
    """JAX's ``_interleave``: ``a`` at even rows, ``b`` at odd rows. JAX
    pads both with zeros and adds them (ors for bool), so a float -0.0
    leaves as +0.0; integer adds of 0 change nothing."""
    out = torch.empty((a.shape[0] + b.shape[0],) + tuple(a.shape[1:]),
                      dtype=a.dtype, device=a.device)
    out[0::2] = a
    out[1::2] = b
    if out.is_floating_point():
        out = out + 0
    return out


def associative_scan(combine, elems):
    """Inclusive scan of the list of columns ``elems`` along rows with
    ``combine(a_list, b_list) -> list``: JAX's ``associative_scan``
    recursion (jax/_src/lax/control_flow/loops.py ``_scan``), which
    combines the same pairs in the same order as the JAX package."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = combine([e[0:-1:2] for e in elems], [e[1::2] for e in elems])
    odd = associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = combine(odd, [e[2::2] for e in elems])
    even = [torch.cat([e[:1], r]) for e, r in zip(elems, even)]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def segmented_combine(diff, s_vals, cfn):
    """Apply an associative combine within each segment of sorted rows.

    ``diff`` marks segment starts; returns ``(is_last, reduced)`` where
    ``is_last`` marks each segment's final row (which holds the full
    segment reduction in ``reduced``). Shared by the standalone reduce
    core and the fused combine+shuffle (parallel/shuffle.py).
    """
    size = diff.shape[0]

    def scan_op(x, y):
        fx, vx = x[0], x[1:]
        fy, vy = y[0], y[1:]
        merged = cfn(tuple(vx), tuple(vy))
        # Broadcast the boundary flag over any trailing (vector) dims.
        return [fx | fy] + [
            torch.where(fy.reshape(fy.shape + (1,) * (b.dim() - 1)), b, m)
            for b, m in zip(vy, merged)
        ]

    red = associative_scan(scan_op, [diff] + list(s_vals))[1:]
    is_last = torch.ones(size, dtype=torch.bool, device=diff.device)
    is_last[:-1] = diff[1:]
    return is_last, tuple(red)


def make_segmented_reduce_masked(nkeys: int, nvals: int, cfn):
    """Mask-based segmented reduce core.

    ``core(valid_mask, key_cols, val_cols) -> (keep_mask, keys, vals)``
    reduces the rows selected by ``valid_mask`` (bool[size]) and returns
    them *in sorted position* with a survivor mask (chained stages
    accept masks).
    """

    def core(valid_mask, key_cols, val_cols):
        s_invalid, s_keys, s_vals, diff = sort_and_segment(
            nkeys, valid_mask, key_cols, val_cols
        )
        is_last, red = segmented_combine(diff, s_vals, cfn)
        return is_last & (s_invalid == 0), s_keys, tuple(red)

    return core


def make_segmented_reduce(nkeys: int, nvals: int, cfn):
    """Count-based wrapper over the masked core: ``core(n, key_cols,
    val_cols) -> (count, keys, vals)`` with survivors front-compacted
    (sorted by key)."""
    masked = make_segmented_reduce_masked(nkeys, nvals, cfn)

    def core(n, key_cols, val_cols):
        size = key_cols[0].shape[0]
        mask = torch.arange(size, device=key_cols[0].device) < n
        keep, keys, vals = masked(mask, key_cols, val_cols)
        count, packed = compact_by_mask(keep, tuple(keys) + tuple(vals))
        return count, packed[:nkeys], packed[nkeys:]

    return core


class DeviceReduceByKey:
    """Keyed reduction of one frame's device columns:
    ``__call__(key_cols, val_cols, n) -> (keys, vals)``, one row per
    distinct key, sorted by key. The rows are padded to
    ``bucket_size(n)`` (the last row repeated, masked off) as the JAX
    package pads them, so the scan pairs the same rows; the surviving
    count is read back once."""

    def __init__(self, fn: Callable, nkeys: int, nvals: int):
        self.nkeys = nkeys
        self.nvals = nvals
        self._core = make_segmented_reduce(
            nkeys, nvals, canonical_combine(fn, nvals))

    def __call__(self, key_cols: Sequence, val_cols: Sequence, n: int):
        size = bucket_size(n)
        cols = pad_cols(list(key_cols) + list(val_cols), n, size)
        count, keys, vals = self._core(n, cols[: self.nkeys],
                                       cols[self.nkeys:])
        count = int(count)
        return ([k[:count] for k in keys], [v[:count] for v in vals])


#: The device fold's steps (``make_sequential_fold_masked``): one a
#: rank, each folding that rank of every segment still active. ``steps``
#: sums them over the folds since ``reset_fold_steps``, ``longest`` is
#: the most one fold took (its longest group), ``folds`` counts folds.
FOLD_STEPS = {"steps": 0, "longest": 0, "folds": 0}
_FOLD_STEPS_LOCK = threading.Lock()


def reset_fold_steps() -> None:
    with _FOLD_STEPS_LOCK:
        FOLD_STEPS.update(steps=0, longest=0, folds=0)


def _note_fold_steps(steps: int) -> None:
    with _FOLD_STEPS_LOCK:
        FOLD_STEPS["steps"] += steps
        FOLD_STEPS["longest"] = max(FOLD_STEPS["longest"], steps)
        FOLD_STEPS["folds"] += 1


def make_sequential_fold_masked(nkeys: int, nvals: int, fold_fn: Callable,
                                init_val, acc_dtype: torch.dtype):
    """Device-tier keyed Fold: ``acc = fold_fn(acc, *vals)`` over each
    key's rows in input order, from ``init_val``, cast to ``acc_dtype``
    after every step. The fold fn need not be associative, so no scan
    can serve it.

    The rows sort stably by key (each key's rows keep their input
    order); the segments are ordered longest first, with one readback of
    the length histogram, so the segments still active at rank ``r`` are
    a prefix of them; step ``r`` folds row ``start + r`` of each of those
    at once, ``fold_fn`` vmapped over them. That is as many steps as the
    longest group (``FOLD_STEPS``), each the same fold the JAX package's
    one scan over every row does for that row. Invalid rows never fold.

    ``core(valid_mask, key_cols, val_cols) -> (keep_mask, keys,
    (accs,))``: rows in sorted position, each group's result at its last
    row (the mask-chained contract of the segmented reduce)."""
    vfn = torch.func.vmap(fold_fn)

    def core(valid_mask, key_cols, val_cols):
        size = key_cols[0].shape[0]
        device = valid_mask.device
        s_invalid, s_keys, s_vals, diff = sort_and_segment(
            nkeys, valid_mask, key_cols, val_cols)
        valid = s_invalid == 0
        # Valid rows sort first, so their segments end where the next
        # one starts, the last at the valid count.
        starts = torch.nonzero(diff & valid).squeeze(1)
        ends = torch.empty_like(starts)
        ends[:-1] = starts[1:]
        ends[-1:] = valid.sum()
        lengths, order = torch.sort(ends - starts, descending=True,
                                    stable=True)
        starts = starts[order]
        # active[r]: the segments longer than r, a prefix of them.
        hist = torch.bincount(lengths).tolist()
        active, left = [], len(starts)
        for count in hist[:-1]:
            left -= count
            active.append(left)
        acc = torch.as_tensor(init_val).to(acc_dtype).to(device).expand(
            len(starts)).clone()
        for r, m in enumerate(active):
            idx = starts[:m] + r
            acc[:m] = vfn(acc[:m], *[take(c, idx) for c in s_vals]).to(
                acc_dtype)
        _note_fold_steps(len(active))
        accs = torch.zeros(size, dtype=acc_dtype, device=device)
        accs[starts + lengths - 1] = acc
        is_last = torch.ones(size, dtype=torch.bool, device=device)
        is_last[:-1] = diff[1:]
        return is_last & valid, s_keys, (accs,)

    return core


class DeviceSortedFold:
    """The sequential fold over one frame's device columns:
    ``__call__(key_cols, val_cols, n) -> (keys, [accs])``, one row per
    distinct key, sorted by key."""

    def __init__(self, fold_fn: Callable, nkeys: int, nvals: int, init_val,
                 acc_dtype: torch.dtype):
        self._core = make_sequential_fold_masked(nkeys, nvals, fold_fn,
                                                 init_val, acc_dtype)

    def __call__(self, key_cols: Sequence, val_cols: Sequence, n: int):
        mask = torch.ones(n, dtype=torch.bool, device=key_cols[0].device)
        keep, keys, accs = self._core(mask, tuple(key_cols), tuple(val_cols))
        idx = torch.nonzero(keep).squeeze(1)
        return [take(k, idx) for k in keys], [take(a, idx) for a in accs]


# Keyed by id(fn) with an aliveness guard; bounded FIFO; shared by the
# local executor's task threads, so guarded by a lock.
_KERNEL_CACHE: dict = {}
_KERNEL_CACHE_MAX = 128
_KERNEL_LOCK = threading.Lock()


def _cached(fn: Callable, key: tuple, make: Callable):
    """The kernel cached under ``key`` while ``fn`` lives, else
    ``make()``, cached."""
    with _KERNEL_LOCK:
        entry = _KERNEL_CACHE.get(key)
        if entry is not None:
            ref, kern = entry
            if ref is None or ref() is fn:
                return kern
        kern = make()
        try:
            ref = weakref.ref(fn)
        except TypeError:  # unweakrefable callables
            ref = None
        _KERNEL_CACHE[key] = (ref, kern)
        while len(_KERNEL_CACHE) > _KERNEL_CACHE_MAX:
            _KERNEL_CACHE.pop(next(iter(_KERNEL_CACHE)))
        return kern


def cached_reduce_kernel(fn: Callable, nkeys: int, nvals: int
                         ) -> DeviceReduceByKey:
    """One DeviceReduceByKey per (fn, nkeys, nvals), shared across the
    combiners built from the same function object."""
    return _cached(fn, ("reduce", id(fn), nkeys, nvals),
                   lambda: DeviceReduceByKey(fn, nkeys, nvals))


def cached_sorted_fold(fn: Callable, nkeys: int, nvals: int, init_val,
                       acc_dtype: torch.dtype) -> DeviceSortedFold:
    """One DeviceSortedFold per (fn, nkeys, nvals, init, dtype), shared
    across the Folds built from the same function object."""
    return _cached(fn, ("fold", id(fn), nkeys, nvals, repr(init_val),
                        str(acc_dtype)),
                   lambda: DeviceSortedFold(fn, nkeys, nvals, init_val,
                                            acc_dtype))


HOST_REDUCEAT = {"add": np.add, "max": np.maximum, "min": np.minimum}


def grouped_reduceat(key_cols, val_cols, ops):
    """Segmented reduce of KEY-SORTED host (numpy) columns: group
    boundaries from adjacent key change, one classified
    ``ufunc.reduceat`` a value column (float sums follow reduceat's
    blocking). Returns (keys_at_bounds, reduced_vals)."""
    n = len(key_cols[0])
    diff = np.zeros(n, dtype=bool)
    diff[0] = True
    for c in key_cols:
        c = np.asarray(c)
        diff[1:] |= c[1:] != c[:-1]
    bounds = np.flatnonzero(diff)
    keys_out = [np.asarray(c)[bounds] for c in key_cols]
    vals_out = [
        HOST_REDUCEAT[op].reduceat(np.asarray(c), bounds, axis=0)
        for op, c in zip(ops, val_cols)
    ]
    return keys_out, vals_out


def classified_host_ops(fn, nvals: int, val_cols):
    """Per-column add/max/min classification for host (numpy) value
    columns, or None: object or vector columns, empty input, an
    unhashable fn, or a fn that does not classify."""
    if not val_cols or not len(val_cols[0]):
        return None
    if any(np.asarray(c).dtype == np.dtype(object) or np.ndim(c) > 1
           for c in val_cols):
        return None
    from bigslice_tpu_torch.parallel.dense import classified_ops_cached

    try:
        return classified_ops_cached(
            fn, nvals, tuple(np.asarray(c).dtype for c in val_cols))
    except TypeError:  # unhashable fn: classify is skipped, not run
        return None


def host_reduce_by_key(key_cols, val_cols, fn, nvals: int):
    """Host-tier keyed reduction (object keys, or a combine fn that is
    not a tensor function) over numpy columns.

    A fn that classifies as per-column add/max/min takes a lexsort and
    ``grouped_reduceat`` (string keys compare in C inside
    ``np.lexsort``); incomparable keys and unclassified fns take an
    exact dict pass. Output is key-sorted either way (the dict pass
    sorts at emit when the keys compare)."""
    from bigslice_tpu_torch.frame.frame import obj_col

    n = len(key_cols[0])
    ops = classified_host_ops(fn, nvals, val_cols)
    if ops is not None:
        try:
            order = np.lexsort(
                tuple(reversed([np.asarray(c) for c in key_cols])))
        except TypeError:
            order = None  # incomparable keys: dict pass below
        if order is not None:
            return grouped_reduceat(
                [np.asarray(c)[order] for c in key_cols],
                [np.asarray(c)[order] for c in val_cols],
                ops,
            )

    cfn = canonical_combine(fn, nvals)
    acc = {}
    order = []
    for i in range(n):
        k = tuple(c[i] for c in key_cols)
        v = tuple(c[i] for c in val_cols)
        if k in acc:
            acc[k] = cfn(acc[k], v)
        else:
            acc[k] = v
            order.append(k)
    try:
        order.sort()
    except TypeError:
        pass  # incomparable key types: emit in insertion order

    def column(vals, like):
        if np.asarray(like).dtype == np.dtype(object):
            return obj_col(vals)
        return np.asarray(vals, dtype=np.asarray(like).dtype)

    keys_out = [column([k[j] for k in order], c)
                for j, c in enumerate(key_cols)]
    vals_out = [column([acc[k][j] for k in order], val_cols[j])
                for j in range(nvals)]
    return keys_out, vals_out
