"""Word count: source -> tokenize -> (word, 1) pairs -> Reduce-by-key.

``wordcount`` is the host tier's demo (strings through host functions,
a Reduce over ``str`` keys, on the local executor); ``wordcount_ids`` is
the same count over pre-tokenized int32 ids, the whole combine path on
the device.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np

from bigslice_tpu_torch.ops.base import Slice
from bigslice_tpu_torch.ops.const import Const
from bigslice_tpu_torch.ops.func import func
from bigslice_tpu_torch.ops.mapops import Flatmap, Map
from bigslice_tpu_torch.ops.reduce import Reduce
from bigslice_tpu_torch.ops.source import ScanReader


def wordcount(num_shards: int, source: Union[str, Callable]) -> Slice:
    """Counts of the words of a text file (a local path) or of a
    callable yielding lines. Tokenizing and pairing are host functions;
    the count's combine is associative, so the map side combines before
    the shuffle."""
    lines = ScanReader(num_shards, source)
    words = Flatmap(lines, lambda line: [(w,) for w in line.split()],
                    out=[str])
    pairs = Map(words, lambda w: (w, 1), out=[str, np.int32])
    return Reduce(pairs, lambda a, b: a + b)


def wordcount_ids(num_shards: int, token_ids, bound: int) -> Slice:
    """Counts of int32 token ids. ``bound`` documents the id range and
    is otherwise unused."""
    ones = np.ones(len(token_ids), dtype=np.int32)
    pairs = Const(num_shards, np.asarray(token_ids, np.int32), ones)
    return Reduce(pairs, lambda a, b: a + b)


@func
def wordcount_func(num_shards: int, path: str) -> Slice:
    """``wordcount`` as a registered Func (host tier: run it on the
    local executor)."""
    return wordcount(num_shards, path)
