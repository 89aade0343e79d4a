"""Fixed-capacity device grouping: ragged groups as (matrix, counts).

Grouping lowers to the device as the fixed-capacity encoding

    keys:   the key columns, one row per group
    values: dtype[n_groups, G]  (entries beyond a group's count are 0)
    counts: int32[n_groups]     (the true group size, may exceed G;
                                only the first G values are kept)

Rows are stably sorted by key (``segment.sort_and_segment``), so a
group's rows are contiguous and keep their arrival order; each group's
head row takes the [G] window of values starting at it, masked by the
group's true length. Overflowing rows (a group's tail past G) are
dropped deterministically and visible through ``counts > G``.

``DeviceGroupByKey`` runs the core over one frame's columns (the local
executor's GroupByKey reader).
"""

from __future__ import annotations

import threading
from typing import Sequence

import torch

from bigslice_tpu_torch.parallel import segment
from bigslice_tpu_torch.parallel.jitutil import bucket_size, pad_cols


def make_group_by_key_masked(nkeys: int, capacity: int):
    """The mask-chained grouping core of the executor's groupby stage:
    ``core(mask, key_cols, val_col) -> (head_mask, keys, groups,
    counts)``. Rows stay in sorted position; each group's head row
    carries its [capacity] vector of values and its true count, and
    ``head_mask`` selects the heads (compact with
    ``segment.compact_by_mask``, which moves vector columns too)."""
    G = capacity

    def core(mask, key_cols, val_col):
        size = val_col.shape[0]
        device = val_col.device
        s_invalid, s_keys, (s_val,), diff = segment.sort_and_segment(
            nkeys, mask, key_cols, (val_col,))
        valid_row = s_invalid == 0
        is_head = diff & valid_row
        # A group's length is the distance from its head to the next
        # segment start (invalid rows each start their own segment, so
        # the last group stops where they begin), written at its head:
        # distinct rows, so no two writes meet.
        starts = torch.nonzero(diff).squeeze(1)
        ends = torch.cat([starts[1:], starts.new_full((1,), size)])
        counts_row = torch.zeros(size, dtype=torch.int32, device=device)
        counts_row[starts] = (ends - starts).to(torch.int32)
        counts_row = torch.where(is_head, counts_row, 0)
        # Each row's [G] window of the sorted values, as a view (no
        # [size, G] index tensor): rows past the end read the zero pad
        # and are masked off with the rest of the window.
        lanes = segment.eq_lanes(s_val)
        padded = torch.cat([lanes, lanes.new_zeros(G)])
        windows = padded.unfold(0, G, 1)[:size]
        in_group = (torch.arange(G, device=device)[None, :]
                    < torch.clamp(counts_row, max=G)[:, None])
        groups = torch.where(in_group, windows, lanes.new_zeros(()))
        return is_head, list(s_keys), groups.view(s_val.dtype), counts_row

    return core


class DeviceGroupByKey:
    """Fixed-capacity grouping of one frame's device columns:
    ``__call__(key_cols, val_col, n) -> (keys, groups [k, G], counts
    [k])``, sorted by key, compacted (the group count read back
    once)."""

    def __init__(self, nkeys: int, capacity: int):
        self.nkeys = nkeys
        self.capacity = capacity
        self._core = make_group_by_key_masked(nkeys, capacity)

    def __call__(self, key_cols: Sequence, val_col, n: int):
        size = bucket_size(n)
        cols = pad_cols(list(key_cols) + [val_col], n, size)
        mask = torch.arange(size, device=cols[0].device) < n
        is_head, keys, groups, counts = self._core(
            mask, tuple(cols[: self.nkeys]), cols[self.nkeys])
        k, packed = segment.compact_by_mask(
            is_head, tuple(keys) + (groups, counts))
        k = int(k)
        return ([c[:k] for c in packed[: self.nkeys]],
                packed[self.nkeys][:k], packed[self.nkeys + 1][:k])


_GROUPBY_CACHE: dict = {}
_GROUPBY_LOCK = threading.Lock()


def cached_group_by_key(nkeys: int, capacity: int) -> DeviceGroupByKey:
    """One DeviceGroupByKey per (nkeys, capacity), shared across task
    threads."""
    key = (nkeys, capacity)
    with _GROUPBY_LOCK:
        kern = _GROUPBY_CACHE.get(key)
        if kern is None:
            kern = _GROUPBY_CACHE[key] = DeviceGroupByKey(nkeys, capacity)
        return kern
