"""Per-key integer max — the canonical Reduce example."""

from __future__ import annotations

import torch

from bigslice_tpu_torch.ops.base import Slice
from bigslice_tpu_torch.ops.const import Const
from bigslice_tpu_torch.ops.func import func
from bigslice_tpu_torch.ops.reduce import Reduce


def int_max(slice_: Slice) -> Slice:
    """Max value per key over a (key, value) slice, via Reduce with
    map-side combining (the torch.maximum combine runs on the device)."""
    return Reduce(slice_, lambda a, b: torch.maximum(a, b))


@func
def int_max_func(nshards: int, keys, vals) -> Slice:
    """``int_max`` over ``Const(nshards, keys, vals)``, as a registered
    Func: ``Session().run(int_max_func, nshards, keys, vals)``."""
    return int_max(Const(nshards, keys, vals))
