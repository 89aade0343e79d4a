"""Dictionary encoding: host payloads as device surrogate keys.

Strings (or any hashable host values) map to dense int32 codes against
a vocabulary; the codes ride the device tier (hash, shuffle, combine on
the card), and the vocabulary turns them back into values at the
edges.

- ``encode_column`` / ``decode_column``: one column with its own
  (first-seen) vocabulary.
- ``GlobalVocab`` with ``encode_frame_column`` / ``decode_frame_column``:
  one vocabulary for keyed work across shards, built on the host,
  encoding anywhere, decoding at the edges.
- ``dict_encoded_reduce``: the whole pattern, an encode in a
  ``MapBatches``, a dense ``Reduce`` on the device tier, a decode on
  read-back.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np

from bigslice_tpu_torch.frame.frame import Frame, obj_col, to_numpy
from bigslice_tpu_torch.slicetype import ColType, Schema


def encode_column(col: Sequence) -> Tuple[np.ndarray, List]:
    """Host values to dense int32 codes and their vocabulary (first-seen
    order)."""
    vocab: Dict = {}
    codes = np.empty(len(col), dtype=np.int32)
    for i, v in enumerate(col):
        code = vocab.get(v)
        if code is None:
            code = len(vocab)
            vocab[v] = code
        codes[i] = code
    return codes, list(vocab)


def decode_column(codes, vocab: Sequence) -> np.ndarray:
    lookup = np.empty(len(vocab), dtype=object)
    lookup[:] = list(vocab)
    return lookup[to_numpy(codes)]


class GlobalVocab:
    """A vocabulary shared across shards: built once on the host (or
    incrementally), encoding anywhere, decoding at the edges.

    ``extend`` and ``encode_extending`` hold a lock: the local
    executor's task threads extend one vocabulary at once, and an
    unlocked check-then-insert could give one code to two values."""

    def __init__(self, values: Sequence = ()):
        self._lock = threading.Lock()
        self._index: Dict = {}
        self._values: List = []
        self._lookup = None  # the decode array, rebuilt after growth
        self.extend(values)

    def extend(self, values: Sequence) -> None:
        with self._lock:
            for v in values:
                if v not in self._index:
                    self._index[v] = len(self._values)
                    self._values.append(v)
            self._lookup = None

    def __len__(self) -> int:
        return len(self._values)

    def encode(self, col: Sequence) -> np.ndarray:
        # map + fromiter keeps the lookup loop in C.
        try:
            return np.fromiter(map(self._index.__getitem__, col), np.int32,
                               len(col))
        except KeyError as e:
            raise KeyError(f"value {e.args[0]!r} not in vocabulary") from None

    def encode_extending(self, col: Sequence) -> np.ndarray:
        """Encode a column, giving unseen values fresh codes: the build
        and the encode in one locked pass. The probe sweep stays in C
        (``map(dict.get)``); only new values reach the Python insert
        loop."""
        with self._lock:
            idx = self._index
            vals = self._values
            out = np.fromiter(map(idx.get, col, itertools.repeat(-1)),
                              np.int32, len(col))
            miss = np.flatnonzero(out < 0)
            for i in miss.tolist():
                v = col[i]
                c = idx.get(v)
                if c is None:
                    c = len(vals)
                    idx[v] = c
                    vals.append(v)
                out[i] = c
            self._lookup = None
            return out

    def decode(self, codes) -> np.ndarray:
        lookup = self._lookup
        if lookup is None:
            with self._lock:
                lookup = np.empty(len(self._values), dtype=object)
                lookup[:] = self._values
                self._lookup = lookup
        return lookup[to_numpy(codes)]


def encode_frame_column(frame: Frame, col_index: int,
                        vocab: GlobalVocab) -> Frame:
    """The frame with host column ``col_index`` replaced by its int32
    codes (a device column)."""
    cols = list(frame.cols)
    cols[col_index] = vocab.encode(cols[col_index])
    types = list(frame.schema.cols)
    types[col_index] = ColType(np.dtype(np.int32))
    return Frame(cols, Schema(types, frame.schema.prefix))


def decode_frame_column(frame: Frame, col_index: int, vocab: GlobalVocab,
                        tag: str = "str") -> Frame:
    """The frame with code column ``col_index`` replaced by its values
    (a host column); a code column on the card is copied back once."""
    cols = list(frame.cols)
    cols[col_index] = obj_col(list(vocab.decode(cols[col_index])))
    types = list(frame.schema.cols)
    types[col_index] = ColType(np.dtype(object), tag)
    return Frame(cols, Schema(types, frame.schema.prefix))


def decode_result_rows(res, vocab: GlobalVocab,
                       col_index: int = 0) -> List[Tuple]:
    """A Result's rows with one code column decoded; the Result's
    outputs are discarded afterwards, also when a read or decode
    fails."""
    out = []
    try:
        for f in res.frames():
            f = decode_frame_column(f.to_host(), col_index, vocab)
            out.extend(f.rows())
    finally:
        res.discard()
    return out


def dict_encoded_reduce(sess, slice_, combine_fn, vocab: GlobalVocab):
    """Reduce a ``(host_key, *device_vals)`` slice on the device tier:
    keys encoded to codes, shuffled and combined on the card, decoded on
    read-back. Returns the decoded rows.

    The shape for str-keyed reduces over a bounded dictionary (word
    count): the host pays one encode pass; the hash, shuffle and combine
    run on the card."""
    from bigslice_tpu_torch.ops.mapops import MapBatches
    from bigslice_tpu_torch.ops.reduce import Reduce

    encoded = MapBatches(
        slice_,
        lambda f: [vocab.encode(f.cols[0])] + list(f.cols[1:]),
        out=[np.int32] + list(slice_.schema.cols[1:]),
    )
    # Codes are dense in [0, len(vocab)) by construction: declaring it
    # lets the device executor take the dense-table lowering.
    res = sess.run(Reduce(encoded, combine_fn,
                          dense_keys=max(1, len(vocab))))
    return decode_result_rows(res, vocab)
