"""Ulysses-style sequence parallelism on one device.

The JAX package's second long-context lowering (the first is the ring,
``parallel/ringattention.py``) re-shards the problem with one
all_to_all each way:

    [seq/N, H, d]  --all_to_all-->  [seq, H/N, d]
        (sharded on sequence)        (sharded on heads)

then computes ordinary full-sequence attention for the local heads, one
batched product pair, and a second all_to_all restores sequence
sharding. The attend stage runs on one device slot (over more than one
rank the executor runs a SelfAttend on its host tier), where both
all_to_alls are the identity: the device holds every head of the whole
sequence.
The middle phase is the JAX package's: a [H, seq, seq] fp32 score
tensor, the padded-row validity and logical positions, and the full
softmax with its 1e-30 clamp. Products take ``dtype`` operands and an
fp32 result (``ringattention._matmul32``).
"""

from __future__ import annotations

import numpy as np
import torch

from bigslice_tpu_torch.parallel.ringattention import (
    NEG_INF,
    _matmul32,
    check_fp32_matmul,
    compute_dtype,
    score_scale,
)


def _heads_first(x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """[seq, H, d] → [H, seq, d] in the compute dtype: the phase-1
    all_to_all on one device."""
    return x.to(cdt).transpose(0, 1)


def _attend(qh, kh, vh, scale, mask):
    """The middle phase over [H, seq, d] operands: fp32 scores, the
    masked full softmax, an fp32 output [seq, H, d] (the phase-3
    all_to_all, the identity here, restores the row-major layout)."""
    s = _matmul32(qh, kh.transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return _matmul32(p.to(vh.dtype), vh).transpose(0, 1)


def make_ulysses_attention(nheads: int, d: int, causal: bool = False,
                           dtype=np.float32):
    """A differentiable Ulysses attention forward on one device.

    Returns ``fn(q, k, v) -> out`` on tensors of shape [seq, nheads, d];
    out is fp32. The one device slot owns every head, so any ``nheads``
    divides it. ``dtype`` is the products' operand type; scores, softmax
    and output are fp32. Gradients flow by autograd."""
    cdt = compute_dtype(dtype)
    scale = score_scale(d)

    def fn(q, k, v):
        check_fp32_matmul(q, cdt)
        seq = q.shape[0]
        mask = None
        if causal:
            rows = torch.arange(seq, dtype=torch.int32, device=q.device)
            mask = rows[:, None] >= rows[None, :]
        return _attend(_heads_first(q, cdt), _heads_first(k, cdt),
                       _heads_first(v, cdt), scale, mask)

    return fn


def masked_local_body(nmesh: int = 1, nheads: int = 1, d: int = 0,
                      causal: bool = False, dtype=np.float32):
    """The mesh executor's Ulysses "attend" stage core over
    CAPACITY-PADDED columns.

    ``fn(count, q, k, v) -> o``: count is the device's valid-row count;
    q/k/v are [cap, H, d] with garbage beyond count. The re-sharded
    sequence is the padded global one in device order, here the one
    device's [cap] rows: invalid rows are masked out of every score,
    and causal positions are logical global row indexes (with one
    device, a valid row's index), so padding never shifts attention.
    Output rows beyond count are unspecified."""
    _check_heads(nheads, nmesh)
    cdt = compute_dtype(dtype)
    scale = score_scale(d)

    def body(count, q, k, v):
        check_fp32_matmul(q, cdt)
        dev = q.device
        pos = torch.arange(q.shape[0], dtype=torch.int32, device=dev)
        valid = pos < count.reshape(()).to(device=dev, dtype=torch.int32)
        mask = valid[:, None] & valid[None, :]
        if causal:
            mask = mask & (pos[:, None] >= pos[None, :])
        return _attend(_heads_first(q, cdt), _heads_first(k, cdt),
                       _heads_first(v, cdt), scale, mask)

    return body


def _check_heads(nheads: int, nmesh: int) -> None:
    """The JAX package's refusal of heads that do not divide the mesh,
    then this package's of more than one device slot (the two
    all_to_alls over a mesh of ranks are not ported)."""
    if nheads % nmesh != 0:
        raise ValueError(
            f"ulysses: nheads ({nheads}) must divide evenly over the "
            f"mesh ({nmesh} devices); use ring attention for H < N")
    if nmesh != 1:
        raise ValueError(
            f"ulysses: the attend stage runs on one device slot (nmesh "
            f"{nmesh}); its all_to_alls over the mesh are not ported")


def dense_mha_reference(q, k, v, causal: bool = False):
    """Host oracle for tests: per-head softmax(QK^T/sqrt(d))V on
    [seq, H, d] arrays, in float64 numpy."""
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    seq, h, d = q.shape
    out = np.empty_like(q)
    for i in range(h):
        s = (q[:, i] @ k[:, i].T) / np.sqrt(d)
        if causal:
            s = np.where(np.tril(np.ones((seq, seq), bool)), s, -np.inf)
        s = s - s.max(axis=-1, keepdims=True)
        p = np.exp(s)
        out[:, i] = (p / p.sum(axis=-1, keepdims=True)) @ v[:, i]
    return out
