"""The device lowering of the general Cogroup.

The shuffle has already routed equal keys of every input to the same
consumer wave. The aligner then groups the union of the inputs' rows
with ONE tagged, stable sort and rank-scatters each input's values into
a fixed-capacity matrix per value column — the pad/count encoding, with
an exact count per (key, input):

    sort (validity, key..., dep) carrying each row's source index
    key heads   -> union-key ranks (a full outer join of the inputs)
    pair heads  -> ranks within each (key, dep) segment (the JAX
                   package's running max of segment starts, here a
                   cumsum of heads and a gather: exact, and far
                   cheaper on the card than ``torch.cummax``'s
                   indexed scan)
    scatter     -> per input, [U, G] value matrices + an int32 count

The capacity G is not declared by the user. With a given G the aligner
reports ``deficit = max(0, biggest group - G)``, as the JAX package's
does for its executor's retry ladder. Without one (the executor's
case), it counts every (key, input) first, reads the largest count back
once, and scatters at ``G = bucket_size`` of it: the deficit is then 0,
no wave reruns, and each wave's matrices are as wide as its own largest
group needs. One G serves every input.

The JAX package builds each matrix in the sorted row space, [ntot+1, G],
and gathers it back to the rows (``mat[u_row]``), then keeps the key
heads. This port builds it in union-key space, [U, G] with U <= ntot
distinct keys (plus dump lanes), and returns the U head rows already
compacted: the same rows, in the same order, as the reference's after
its compaction, at a fraction of the memory when groups are large.
"""

from __future__ import annotations

import gc
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigslice_tpu_torch.parallel import segment
from bigslice_tpu_torch.parallel.jitutil import bucket_size

#: Scatter views for dtypes the index kernels lack.
_SCATTER_VIEW = {torch.uint32: torch.int32}
#: Rows a scatter discards land on one of this many dump lanes (by row
#: index), not on one: a single lane serializes the card's atomics and
#: stores on one address.
_DUMP_LANES = 1024


def make_cogroup_align(nk: int, nvals: Tuple[int, ...],
                       capacity: Optional[int] = None, agree=None):
    """Build the cogroup aligner for inputs with ``nk`` key columns and
    ``nvals[j]`` value columns each, at the shared capacity G
    (``capacity``; None: ``bucket_size`` of the largest group, read back
    to the host once, then passed through ``agree`` when given: the
    executor's max over the mesh, the JAX package's pmax of the deficit,
    reference parallel/cogroup.py:136, so every slot builds and records
    the same width).

    ``align(masks, col_sets) -> (count, cols, deficit, G)``: ``cols`` is
    ``[key..., per input: value matrices [U, G]..., count int32[U]]``
    for the U distinct valid keys in sorted order (front-packed, no
    invalid rows), ``count`` the int32 0-d U, ``deficit`` the int32 0-d
    capacity shortfall (0: every group fits) and ``G`` the width the
    matrices were built at."""
    ndeps = len(nvals)
    dep_bits = max(1, (ndeps - 1).bit_length())

    def align(masks: Sequence[torch.Tensor],
              col_sets: Sequence[Sequence[torch.Tensor]]):
        sizes = [int(cs[0].shape[0]) for cs in col_sets]
        ntot = sum(sizes)
        device = masks[0].device
        inval = torch.cat([(~m).to(torch.int32) for m in masks])
        keys = [torch.cat([cs[k] for cs in col_sets]) for k in range(nk)]
        dep = torch.cat([torch.full((sz,), j, dtype=torch.int32,
                                    device=device)
                         for j, sz in enumerate(sizes)])
        perm = segment.sort_permutation(
            [inval] + keys + [dep], bits=(1,) + (None,) * nk + (dep_bits,))
        s_inval = inval[perm]
        s_keys = [segment.take(k, perm) for k in keys]
        s_dep = dep[perm]
        valid = s_inval == 0

        idx = torch.arange(ntot, dtype=torch.int32, device=device)
        key_diff = idx == 0
        for k in s_keys:
            k = segment.eq_lanes(k)
            key_diff[1:] |= k[1:] != k[:-1]
        key_head = valid & key_diff
        u = torch.cumsum(key_head.to(torch.int32), 0,
                         dtype=torch.int32) - 1  # union rank
        dep_diff = key_diff.clone()
        dep_diff[1:] |= s_dep[1:] != s_dep[:-1]
        pair_head = valid & dep_diff
        dump = idx & (_DUMP_LANES - 1)
        # Each row's (key, dep) segment, and the segment's first row.
        pid = torch.cumsum(pair_head.to(torch.int32), 0,
                           dtype=torch.int32) - 1
        first = torch.zeros(ntot + _DUMP_LANES, dtype=torch.int32,
                            device=device)
        first[torch.where(pair_head, pid, ntot + dump).to(torch.int64)] = idx
        rank = idx - first[torch.clamp(pid, min=0).to(torch.int64)]

        heads = torch.nonzero(key_head).squeeze(1)
        U = int(heads.shape[0])
        # Exact counts per (union key, input), rows of other inputs on
        # the dump lanes from U.
        sels, cnts = [], []
        for j in range(ndeps):
            sel = valid & (s_dep == j)
            u_dump = torch.where(sel, u, U + dump).to(torch.int64)
            cnt = torch.zeros(U + _DUMP_LANES, dtype=torch.int32,
                              device=device)
            cnt.index_add_(0, u_dump, torch.ones_like(u))
            sels.append(sel)
            cnts.append(cnt[:U])
        largest = (torch.stack([c.max() for c in cnts]).max() if U
                   else torch.zeros((), dtype=torch.int32, device=device))
        if capacity is None:
            G = bucket_size(int(largest))
            if agree is not None:
                G = int(agree(G))
        else:
            G = int(capacity)
        deficit = torch.clamp(largest - G, min=0).to(torch.int32)

        out_cols: List[torch.Tensor] = [segment.take(k, heads)
                                        for k in s_keys]
        off = 0
        for j in range(ndeps):
            # Flat [U, G] slots: a row past the capacity, or of another
            # input, lands on the dump lanes behind them.
            keep = sels[j] & (rank < G)
            slot = torch.where(keep, u.to(torch.int64) * G + rank,
                               U * G + dump)
            src = torch.clamp(perm - off, 0, max(sizes[j] - 1, 0))
            for v in range(nvals[j]):
                col = col_sets[j][nk + v]
                view = _SCATTER_VIEW.get(col.dtype)
                lanes = col if view is None else col.view(view)
                mat = torch.zeros(U * G + _DUMP_LANES, dtype=lanes.dtype,
                                  device=device)
                if sizes[j]:
                    mat[slot] = lanes[src]
                mat = mat[: U * G].view(U, G)
                out_cols.append(mat if view is None else mat.view(col.dtype))
            out_cols.append(cnts[j])
            off += sizes[j]
        return (torch.full((), U, dtype=torch.int32, device=device),
                out_cols, deficit, G)

    return align


def ragged_from_padded(nk: int, nvals: Tuple[int, ...], cols) -> list:
    """Host decode of the padded encoding into the Cogroup contract's
    object list columns: ``[keys..., per input per value column: object
    column of lists]``, each list holding numpy scalars of the column's
    dtype, its first ``count`` values (counts are exact: a committed
    attempt never truncates). Vectorised over rows: one boolean gather
    and one conversion per matrix, then list slices, with the cyclic
    garbage collector paused (millions of new lists would otherwise set
    off its passes over them, tripling the time)."""
    paused = gc.isenabled()
    gc.disable()
    try:
        return _ragged(nk, nvals, cols)
    finally:
        if paused:
            gc.enable()


def _ragged(nk: int, nvals: Tuple[int, ...], cols) -> list:
    out = [np.asarray(c) for c in cols[:nk]]
    off = nk
    for nv in nvals:
        mats = [np.asarray(cols[off + v]) for v in range(nv)]
        cnt = np.asarray(cols[off + nv]).astype(np.int64)
        off += nv + 1
        n = len(cnt)
        for m in mats:
            G = m.shape[1]
            held = np.minimum(cnt, G)
            ends = np.cumsum(held)
            starts = ends - held
            flat = m[np.arange(G)[None, :] < held[:, None]]
            cells = list(flat)  # numpy scalars of m's dtype
            col = np.empty(n, dtype=object)
            for i, (a, b) in enumerate(zip(starts.tolist(),
                                           ends.tolist())):
                col[i] = cells[a:b]
            out.append(col)
    return out
