"""Batching utilities: ragged batches are padded up to power-of-two
*buckets*, so table sizes and buffer shapes come from a bounded set."""

from __future__ import annotations

from typing import Sequence

import torch


def bucket_size(n: int, minimum: int = 8) -> int:
    """Smallest power of two ≥ n (≥ minimum)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def pad_cols(cols: Sequence[torch.Tensor], n: int, target: int) -> list:
    """Pad columns from n to target rows by repeating the last row
    (stays in the user function's domain, unlike zero fill)."""
    if n == target:
        return list(cols)
    out = []
    for c in cols:
        if n == 0:
            out.append(torch.zeros((target,) + tuple(c.shape[1:]),
                                   dtype=c.dtype, device=c.device))
        else:
            fill = c[n - 1 : n].expand((target - n,) + tuple(c.shape[1:]))
            out.append(torch.cat([c[:n], fill]))
    return out


def kernel_device(device, who: str) -> torch.device:
    """The device a standalone kernel class runs on: ``cuda`` unless the
    caller passes another; raises when there is no GPU for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device is available; pass "
                           f"device='cpu' to run on the CPU")
    return device
