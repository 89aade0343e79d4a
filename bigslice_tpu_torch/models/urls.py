"""Domain count over a corpus of URL lines (ReaderFunc -> Map -> Reduce).

- ``domain_count``: host-tier parsing and str keys end to end (the
  host CRC routes each domain).
- ``domain_count_encoded``: one host sweep parses and dictionary-encodes
  every line to an int32 code (``frame/strparse.py``); the count runs
  on the device tier over the codes as a dense ``Reduce`` and is
  decoded at the edge (``frame/dictenc.py``).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch

from bigslice_tpu_torch.frame import dictenc, strparse
from bigslice_tpu_torch.ops.base import Slice
from bigslice_tpu_torch.ops.mapops import Map, MapBatches
from bigslice_tpu_torch.ops.reduce import Reduce
from bigslice_tpu_torch.ops.source import ScanReader


def _domain(url: str) -> str:
    url = url.split("//", 1)[-1]
    return url.split("/", 1)[0].lower()


def _add(a, b):
    # Module-level (a stable identity): the executor's program caches
    # key on the combine fn, so repeated counts in one session reuse
    # them.
    return a + b


def _attach_one(code):
    # A tensor, not the literal 1: a device Map's fn must return tensors,
    # or the Map runs on the host tier, a Python call a row.
    return (code, torch.ones_like(code))


def _domains_batch(urls) -> np.ndarray:
    """``_domain`` over a whole column, as an object array. A list
    comprehension on purpose: for short strings np.char's fixed-width
    round trips cost more than the str methods. Bit-equal to
    ``_domain``."""
    out = np.empty(len(urls), dtype=object)
    out[:] = [_domain(u) for u in urls]
    return out


def domain_count(num_shards: int,
                 source: Union[str, Callable, Sequence]) -> Slice:
    """Count URLs per domain (host-tier str keys)."""
    lines = ScanReader(num_shards, source)
    pairs = Map(lines, lambda u: (_domain(u), 1), out=[str, np.int32])
    return Reduce(pairs, lambda a, b: a + b)


def domain_count_encoded(sess, num_shards: int,
                         source: Union[str, Callable, Sequence]
                         ) -> List[Tuple[str, int]]:
    """Count URLs per domain with the count on the device tier.

    Pass 1 (host): one sweep parses, builds the vocabulary and encodes,
    and the session stores the int32 codes.
    Pass 2 (device): a Map attaches unit counts and a Reduce, declared
    dense over the vocabulary, adds them; the rows are decoded at the
    edge.
    """
    lines = ScanReader(num_shards, source)
    vocab = dictenc.GlobalVocab()

    def parse_encode(f):
        return (strparse.domains_codes(f.cols[0], vocab,
                                       fallback_fn=_domain),)

    corpus = sess.run(MapBatches(lines, parse_encode, out=[np.int32]))
    try:
        pairs = Map(corpus, _attach_one, out=[np.int32, np.int32])
        res = sess.run(Reduce(pairs, _add, dense_keys=max(1, len(vocab))))
        return dictenc.decode_result_rows(res, vocab)
    finally:
        corpus.discard()
