"""Archive sources: slices over tar files.

``TarSlice(num_shards, path)`` has a row ``(name, payload)`` for each
regular file in a tar archive, entries striped across shards. Payloads
are host (bytes) columns; device work typically begins after a parse
Map.
"""

from __future__ import annotations

import tarfile

from bigslice_tpu_torch import sliceio, typecheck
from bigslice_tpu_torch.frame.frame import Frame
from bigslice_tpu_torch.ops.base import Slice, make_name
from bigslice_tpu_torch.slicetype import Schema


class TarSlice(Slice):
    """``TarSlice(num_shards, path)`` -> rows of (name: str, data:
    bytes); the i-th regular file belongs to shard ``i % num_shards``."""

    def __init__(self, num_shards: int, path: str):
        typecheck.check(num_shards >= 1, "tarslice: num_shards must be >= 1")
        super().__init__(Schema([str, bytes], prefix=1), num_shards,
                         make_name("tarslice"))
        self.path = path

    def reader(self, shard, deps):
        def read():
            batch = []
            with tarfile.open(self.path, "r:*") as tf:
                i = -1
                for member in tf:
                    if not member.isfile():
                        continue
                    i += 1
                    if i % self.num_shards != shard:
                        continue
                    fp = tf.extractfile(member)
                    data = fp.read() if fp is not None else b""
                    batch.append((member.name, data))
                    if len(batch) >= sliceio.DEFAULT_CHUNK_ROWS:
                        yield Frame.from_rows(batch, self.schema)
                        batch = []
            if batch:
                yield Frame.from_rows(batch, self.schema)

        return read()
