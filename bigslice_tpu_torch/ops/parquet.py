"""ParquetReader — a sharded columnar file source.

Parquet row groups are distributed round-robin across shards (row
group r belongs to shard r % num_shards), so shards stream disjoint
subsets with no coordination. URLs go through fsspec (``gs://``,
``s3://``, ``memory://``, local paths), as the stores do.

The schema is declared (``out=``), as every host source's is: no file
is read to build the graph. 64-bit numeric columns are cast down to the
32-bit device tier on read (``frame/arrow.from_arrow``), as ``Const``
casts them. The source runs on the host tier (on the device executor,
its inner local executor); its frames hold CPU tensors, which move to
the card only before a device consumer.
"""

from __future__ import annotations

import threading
import time

from bigslice_tpu_torch import typecheck
from bigslice_tpu_torch.ops.base import Slice, make_name
from bigslice_tpu_torch.slicetype import Schema
from bigslice_tpu_torch.utils import fileio


class ParquetReader(Slice):
    """``ParquetReader(num_shards, url, out=[...], prefix=1,
    columns=None)`` — read Parquet across shards. ``url`` is one file
    (its row groups round-robin) or an fsspec glob (``data/*.parquet``:
    whole files round-robin, so a shard never reads the footer of a file
    it does not own).

    ``stats()`` reports the row groups and rows decoded and the seconds
    spent decoding them, summed over the shards' threads."""

    def __init__(self, num_shards: int, url: str, out, prefix: int = 1,
                 columns=None):
        typecheck.check(num_shards >= 1, "parquet: num_shards must be >= 1")
        schema = out if isinstance(out, Schema) else Schema(out, prefix)
        super().__init__(schema, num_shards, make_name("parquet"))
        self.url = url
        self.columns = list(columns) if columns is not None else None
        # The file list is pinned when the graph is built: listing at
        # read time could see a changing directory differently in each
        # shard and duplicate or drop files under the round-robin split.
        # Only '*' expands ('?' and '[' appear in presigned URLs and
        # literal file names).
        self.urls = self._expand(url)
        self._lock = threading.Lock()
        self._stats = {"row_groups": 0, "rows": 0, "decode_s": 0.0}

    @staticmethod
    def _expand(url: str):
        if "*" not in url:
            return [url]
        import fsspec

        fs, _, paths = fsspec.get_fs_token_paths(url)
        typecheck.check(bool(paths), "parquet: glob %r matched no files",
                        url)
        proto = fs.protocol if isinstance(fs.protocol, str) \
            else fs.protocol[0]
        if proto in ("file", "local"):
            return sorted(paths)
        return sorted(f"{proto}://{p}" for p in paths)

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    def _note(self, rows: int, seconds: float) -> None:
        with self._lock:
            self._stats["row_groups"] += 1
            self._stats["rows"] += rows
            self._stats["decode_s"] += seconds

    def reader(self, shard, deps):
        def read():
            from bigslice_tpu_torch.frame import arrow

            arrow._require_pyarrow()
            import pyarrow.parquet as pq

            # One file: its row groups round-robin. Many files: whole
            # files round-robin, so a shard opens (and parses the footer
            # of) only its own files. Groups stream one at a time.
            if len(self.urls) == 1:
                plan = [(self.urls[0], False)]
            else:
                plan = [(u, True) for i, u in enumerate(self.urls)
                        if i % self.num_shards == shard]
            for url, whole in plan:
                with fileio.open_read(url) as fh:
                    pf = pq.ParquetFile(fh)
                    n_groups = pf.metadata.num_row_groups
                    mine = (range(n_groups) if whole
                            else range(shard, n_groups, self.num_shards))
                    for g in mine:
                        t0 = time.perf_counter()
                        f = arrow.from_arrow(
                            pf.read_row_groups([g], columns=self.columns),
                            prefix=self.schema.prefix)
                        self._note(len(f), time.perf_counter() - t0)
                        typecheck.check(
                            f.schema.assignable_to(self.schema),
                            "parquet: %s columns %s do not match the "
                            "declared schema %s", url, f.schema,
                            self.schema)
                        if len(f):
                            yield f

        return read()
