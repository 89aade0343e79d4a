"""The tagged-sort alignment of an aggregating inner join.

After each side is reduced to at most one row per key, the two sides
are aligned on the device: concatenated with a side tag, stably sorted
by (validity, keys..., tag), and an inner-join match is an adjacent
valid (tag 0, tag 1) pair with equal keys. The sort is
``segment.sort_with_payload`` in ``lax.sort``'s order (-0.0 and +0.0
equal, NaN last, ties in input order), so a join over float keys
matches the JAX package's: ±0.0 join, a NaN key never matches.
"""

from __future__ import annotations

from typing import Callable

import torch

from bigslice_tpu_torch.parallel import segment


def _pad_rows(v: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """``v`` with ``before`` zero rows ahead of it and ``after`` behind."""
    tail = tuple(v.shape[1:])
    return torch.cat([v.new_zeros((before,) + tail), v,
                      v.new_zeros((after,) + tail)])


def make_align(nkeys: int, nvals_a: int, nvals_b: int):
    """The tagged-sort align kernel of the executor's join stage.

    ``align(keep_a, key_cols_a, val_cols_a, keep_b, key_cols_b,
    val_cols_b) -> (match_mask, out_cols)`` where each side's rows are
    selected by its ``keep`` mask and hold at most one row per key.
    ``out_cols`` is keys + A's values + B's values (taken from the next
    row), valid where ``match_mask``: callers compact or chain the mask.
    """

    def align(keep_a, key_a, val_a, keep_b, key_b, val_b):
        size_a = key_a[0].shape[0]
        size_b = key_b[0].shape[0]
        size = size_a + size_b
        device = keep_a.device
        keys = [torch.cat([x, y]) for x, y in zip(key_a, key_b)]
        tag = torch.cat([torch.zeros(size_a, dtype=torch.int32,
                                     device=device),
                         torch.ones(size_b, dtype=torch.int32,
                                    device=device)])
        avals = [_pad_rows(v, 0, size_b) for v in val_a]
        bvals = [_pad_rows(v, size_a, 0) for v in val_b]
        invalid = (~torch.cat([keep_a, keep_b])).to(torch.int32)
        # The tag is one more sort key after the keys: validity 1 bit,
        # the key, the tag 1 bit (one packed int64 pass for a 32-bit
        # key).
        srt, payload = segment.sort_with_payload(
            (invalid,) + tuple(keys) + (tag,), 2 + nkeys,
            tuple(avals) + tuple(bvals),
            bits=(1,) + (None,) * nkeys + (1,),
        )
        s_inv, s_keys, s_tag = srt[0], srt[1:1 + nkeys], srt[1 + nkeys]
        s_avals, s_bvals = payload[:nvals_a], payload[nvals_a:]
        match = torch.zeros(size, dtype=torch.bool, device=device)
        if size > 1:
            eq = ((s_tag[:-1] == 0) & (s_tag[1:] == 1)
                  & (s_inv[:-1] == 0) & (s_inv[1:] == 0))
            for k in s_keys:
                k = segment.eq_lanes(k)
                eq = eq & (k[:-1] == k[1:])
            match[:-1] = eq
        b_next = [torch.cat([v[1:], v[-1:]]) for v in s_bvals]
        return match, list(s_keys) + list(s_avals) + b_next

    return align


class MeshJoinAggregate:
    """A standalone aggregating inner join of two keyed single-value
    sides over the device slots: each side's ``MeshReduceByKey``, then
    the tagged-sort alignment, front-packed. ``__call__(a_cols,
    a_counts, b_cols, b_counts)`` takes each side's (keys, vals) of
    ``capacity`` rows and int32[1] counts and returns ``(keys, a_vals,
    b_vals, out_counts, overflow)`` with one row a key present in both
    sides; ``device`` (default ``cuda``) replaces the JAX package's
    mesh."""

    def __init__(self, capacity: int, a_combine: Callable,
                 b_combine: Callable, seed: int = 0, slack: float = 2.0,
                 device=None):
        from bigslice_tpu_torch.parallel import shuffle as shuffle_mod

        self.a_reduce = shuffle_mod.MeshReduceByKey(
            1, 1, capacity, a_combine, seed=seed, slack=slack,
            device=device)
        self.b_reduce = shuffle_mod.MeshReduceByKey(
            1, 1, capacity, b_combine, seed=seed, slack=slack,
            device=device)
        self.device = self.a_reduce.device
        self.out_capacity = (self.a_reduce.out_capacity
                             + self.b_reduce.out_capacity)
        self._align = make_align(1, 1, 1)

    def __call__(self, a_cols, a_counts, b_cols, b_counts):
        ka, va, na, ov_a = self.a_reduce([a_cols[0]], [a_cols[1]], a_counts)
        kb, vb, nb, ov_b = self.b_reduce([b_cols[0]], [b_cols[1]], b_counts)
        keep_a = torch.arange(ka[0].shape[0], device=self.device) < na[0]
        keep_b = torch.arange(kb[0].shape[0], device=self.device) < nb[0]
        match, cols = self._align(keep_a, (ka[0],), (va[0],),
                                  keep_b, (kb[0],), (vb[0],))
        n, (keys, avals, bvals) = segment.compact_by_mask(match, cols)
        return keys, avals, bvals, n.reshape(1), ov_a + ov_b


def join_count_oracle(a_keys, b_keys) -> dict:
    """Host oracle: keys present in both sides with (countA, countB)."""
    from collections import Counter

    ca, cb = Counter(a_keys), Counter(b_keys)
    return {k: (ca[k], cb[k]) for k in ca.keys() & cb.keys()}
