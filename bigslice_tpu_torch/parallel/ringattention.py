"""Ring attention on one device: the ring with one member.

The JAX package shards the sequence over its device mesh and rotates
K/V blocks around the ring (``lax.ppermute``) while each device
accumulates its queries' output with an online (flash-style) softmax:

    per hop:  scores = Q_local @ K_blk^T
              rescale the running (max, denom, acc), exactly
              K/V blocks advance one hop around the ring

The attend stage runs on one device slot (``MeshExecutor.nmesh == 1``;
over more than one rank the executor runs a SelfAttend on its host
tier, until the ring's K/V rotation over the mesh is ported), so the
ring has one member and one hop: the local block is the whole
sequence. The online softmax, its constants and its order of
operations are the JAX package's all the same (the -1e30 fill, the
running max ``m``, the ``corr`` rescale, ``l`` clamped at 1e-30 at the
end), so the values match it at any ring length.

- The products take ``dtype`` operands (bf16 rounds q, k, v and ``p``)
  and accumulate in fp32 with an fp32 result, as the JAX package's
  ``preferred_element_type`` does: the rounded operands are upcast to
  fp32 for the product (``_matmul32``), because torch has no product
  with an fp32 output for bf16 operands on the CPU. Statistics and
  accumulators stay fp32.
- ``block_q`` tiles the query rows: the Q tiles are visited one at a
  time, so the live score buffer is ``[heads, block_q, nk]``.
- Heads ride a leading batch axis of every tensor (the JAX package
  vmaps the ring body over heads); no Python loop visits them.
- ``make_ring_attention`` is differentiable through autograd; with
  ``remat`` each hop runs under ``torch.utils.checkpoint``, so its
  residuals are recomputed in the backward pass. No backward kernel is
  written.

The mesh executor's "attend" stage runs ``masked_local_body`` over
capacity-padded columns (``exec/meshexec.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from bigslice_tpu_torch.slicetype import torch_dtype

NEG_INF = -1e30


def compute_dtype(dtype) -> torch.dtype:
    """The torch dtype of the products for ``dtype`` (numpy, ml_dtypes'
    bfloat16 or torch)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch_dtype(np.dtype(dtype))


def score_scale(d: int) -> float:
    """1/sqrt(d) rounded to fp32, as a Python float: a scalar operand
    (a tensor made from it would be a host-to-device copy a use)."""
    return float(np.float32(1.0 / np.sqrt(d)))


def check_fp32_matmul(x: torch.Tensor, dtype: torch.dtype) -> None:
    """Refuse a float32 attention on a card whose fp32 products run as
    TF32: the JAX package's contract is full fp32 products, and TF32
    would round every operand to 10 mantissa bits."""
    if (x.device.type == "cuda" and dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise ValueError(
            "attention in float32 needs full fp32 products, but "
            "torch.backends.cuda.matmul.allow_tf32 is on: turn it off, "
            "or pass dtype=bfloat16")


def _matmul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with fp32 accumulation and an fp32 result. A product of
    two bf16 values is exact in fp32, so upcasting the rounded operands
    gives the JAX package's ``preferred_element_type=float32``."""
    if a.dtype != torch.float32:
        a = a.float()
    if b.dtype != torch.float32:
        b = b.float()
    return torch.matmul(a, b)


def _online_hop(q, k_blk, v_blk, m, l, acc, scale, score_mask=None,
                pdt=None):
    """One online-softmax accumulation step in fp32 statistics.

    q: [B, bq, d] (compute dtype); k_blk/v_blk: [B, nk, d], in the
    compute dtype or already upcast from it; m, l: f32[B, bq]; acc:
    f32[B, bq, d]. ``score_mask`` (bool [bq, nk], broadcast over B)
    marks the VALID scores. ``p`` is rounded to ``pdt`` (default
    v_blk's dtype) for its product, as the JAX package rounds it to the
    compute dtype."""
    s = _matmul32(q, k_blk.transpose(-1, -2)) * scale
    if score_mask is not None:
        s = torch.where(score_mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    p = p.to(v_blk.dtype if pdt is None else pdt)
    acc = acc * corr[..., None] + _matmul32(p, v_blk)
    return m_new, l, acc


def _q_tiling(n: int, block_q: int):
    """(block, nblocks, pad) for the Q dimension: block_q <= 0 or >= n
    disables tiling (one block)."""
    bq = block_q if 0 < block_q < n else n
    nblk = (n + bq - 1) // bq
    return bq, nblk, nblk * bq - n


def _pad_blocks(x: torch.Tensor, pad: int, nblk: int, bq: int,
                axis: int = 0) -> torch.Tensor:
    """Pad a per-row tensor along its row ``axis`` to the tiled domain
    and split that axis into [nblk, bq], the tile axis moved to the
    front: done once before the ring; statistics stay in this domain
    across hops."""
    axis = axis % x.ndim
    if pad:
        shape = list(x.shape)
        shape[axis] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=axis)
    x = x.reshape(x.shape[:axis] + (nblk, bq) + x.shape[axis + 1:])
    return x.movedim(axis, 0)


def _hop_update(q3, rows2, valid2, carry, k_blk, v_blk, scale,
                make_mask):
    """One K/V block's online update over all Q tiles. ``q3`` ([nblk, B,
    bq, d]), ``rows2``/``valid2`` ([nblk, bq]) and the ``carry`` (m, l,
    acc) live in the padded tile domain. ``make_mask(rows_b, valid_b)
    -> bool [bq, nk] | None`` builds each tile's score mask. The tiles
    are visited one at a time, so the live score buffer is [B, bq,
    nk]. K/V are upcast to fp32 once for every tile's products (exact:
    they hold compute-dtype values); ``p`` is still rounded to their
    compute dtype."""
    m2, l2, a3 = carry
    pdt = v_blk.dtype
    k_blk, v_blk = k_blk.float(), v_blk.float()
    ms, ls, accs = [], [], []
    for b in range(q3.shape[0]):
        m, l, a = _online_hop(q3[b], k_blk, v_blk, m2[b], l2[b], a3[b],
                              scale, make_mask(rows2[b], valid2[b]), pdt)
        ms.append(m)
        ls.append(l)
        accs.append(a)
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def _init_carry(nblk: int, B: int, bq: int, d: int, device):
    return (torch.full((nblk, B, bq), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((nblk, B, bq), dtype=torch.float32, device=device),
            torch.zeros((nblk, B, bq, d), dtype=torch.float32,
                        device=device))


def _finish(carry, n: int, d: int) -> torch.Tensor:
    """Unpad the statistics once and divide: [B, n, d] fp32. A fully
    masked row (a padding row; causally every row sees itself) would
    divide by zero, hence the clamp."""
    _, l2, a3 = carry
    B = l2.shape[1]
    l = l2.movedim(0, 1).reshape(B, -1)[:, :n]
    acc = a3.movedim(0, 1).reshape(B, -1, d)[:, :n]
    return acc / torch.clamp(l, min=1e-30)[..., None]


def make_ring_attention(d: int, causal: bool = False, dtype=np.float32,
                        block_q: int = 0, remat: bool = True):
    """A differentiable ring-attention forward on one device.

    Returns ``fn(q, k, v) -> out`` on tensors of shape [seq, d] (or
    [B, seq, d] for a batch of independent heads); ``out`` is fp32.
    ``causal`` masks by global positions. ``dtype`` is the products'
    operand type; statistics and accumulation are fp32. ``block_q`` > 0
    tiles the query rows. ``remat`` checkpoints the hop, so that the
    backward pass recomputes its residuals; gradients flow by autograd
    to q, k and v."""
    cdt = compute_dtype(dtype)
    scale = score_scale(d)

    def hop_body(carry, q3, rows2, valid2, k_blk, v_blk, cols):
        def make_mask(rb, vb):
            del vb
            if not causal:
                return None
            return cols[None, :] <= rb[:, None]

        return _hop_update(q3, rows2, valid2, carry, k_blk, v_blk, scale,
                           make_mask)

    def hop(*args):
        if remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            return checkpoint(hop_body, *args, use_reentrant=False)
        return hop_body(*args)

    def fn(q, k, v):
        single = q.ndim == 2
        if single:
            q, k, v = q[None], k[None], v[None]
        check_fp32_matmul(q, cdt)
        B, n = q.shape[0], q.shape[1]
        bq, nblk, pad = _q_tiling(n, block_q)
        rows = torch.arange(n, dtype=torch.int32, device=q.device)
        q3 = _pad_blocks(q.to(cdt), pad, nblk, bq, axis=1)
        rows2 = _pad_blocks(rows, pad, nblk, bq)
        valid2 = torch.ones((nblk, bq), dtype=torch.bool, device=q.device)
        carry = _init_carry(nblk, B, bq, d, q.device)
        # The ring's one hop: the resident block is the whole sequence,
        # at global offset 0 (no rotation follows the last hop).
        carry = hop(carry, q3, rows2, valid2, k.to(cdt), v.to(cdt), rows)
        out = _finish(carry, n, d)
        return out[0] if single else out

    return fn


def masked_local_body(nmesh: int = 1, d: int = 0, causal: bool = False,
                      dtype=np.float32, block_q: int = 0):
    """The mesh executor's "attend" stage core: ring attention over
    CAPACITY-PADDED columns.

    ``fn(count, q, k, v) -> o``: count is the device's valid-row count
    (an int32 tensor of one element); q/k/v are [cap, d] or [B, cap, d]
    with garbage beyond count. Invalid K columns are masked out of every
    score; causal positions are global LOGICAL row indexes, so padding
    never shifts a position. On the one device slot the ring has one
    member, whose block starts at logical row 0: a position is its row
    index, and its one hop sees every K row. Output rows beyond count
    are unspecified (callers carry counts). ``nmesh`` must be 1: the
    ring's K/V rotation over a mesh of ranks is not ported."""
    if nmesh != 1:
        raise ValueError(
            f"ring attention: the attend stage runs on one device slot "
            f"(nmesh {nmesh}); the ring's K/V rotation over the mesh is "
            f"not ported")
    cdt = compute_dtype(dtype)
    scale = score_scale(d)

    def body(count, q, k, v):
        single = q.ndim == 2
        if single:
            q, k, v = q[None], k[None], v[None]
        check_fp32_matmul(q, cdt)
        B, cap = q.shape[0], q.shape[1]
        dev = q.device
        rows = torch.arange(cap, dtype=torch.int32, device=dev)
        valid = rows < count.reshape(()).to(device=dev, dtype=torch.int32)

        bq, nblk, pad = _q_tiling(cap, block_q)
        q3 = _pad_blocks(q.to(cdt), pad, nblk, bq, axis=1)
        rows2 = _pad_blocks(rows, pad, nblk, bq)
        valid2 = _pad_blocks(valid, pad, nblk, bq)

        def make_mask(rb, vb):
            mask = vb[:, None] & valid[None, :]
            if causal:
                mask = mask & (rows[None, :] <= rb[:, None])
            return mask

        carry = _hop_update(q3, rows2, valid2,
                            _init_carry(nblk, B, bq, d, dev), k.to(cdt),
                            v.to(cdt), scale, make_mask)
        out = _finish(carry, cap, d)
        return out[0] if single else out

    return body


def dense_attention_reference(q, k, v, causal: bool = False):
    """Host oracle for tests: materialized softmax(QK^T/sqrt(d))V in
    float64 numpy."""
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    s = (q @ k.T) / np.sqrt(q.shape[1])
    if causal:
        n = s.shape[0]
        s = np.where(np.tril(np.ones((n, n), bool)), s, -np.inf)
    s = s - s.max(axis=-1, keepdims=True)
    p = np.exp(s)
    p = p / p.sum(axis=-1, keepdims=True)
    return p @ v
