"""Task output storage: partitioned, committed result buffers,
addressable by (task name, partition) and re-readable — what makes
lost-task recovery and Result reuse possible.

``MemoryStore`` holds frames in host memory; ``FileStore`` writes them
under a local directory or any fsspec URL prefix (``gs://``, ``s3://``,
``memory://``) in the BSF4 codec (``frame/codec.py``), with the layout
``{prefix}/inv{N}/{op}/{shard}-of-{num}/p{partition}``, and reads them
back a frame at a time. The spill exchange
(``exec/shuffleplan.py``) writes through a ``FileStore``.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from bigslice_tpu_torch.exec.task import TaskName
from bigslice_tpu_torch.frame import codec
from bigslice_tpu_torch.frame.frame import Frame
from bigslice_tpu_torch.utils import fileio


class Missing(KeyError):
    """The requested (task, partition) output is not committed."""


class Store:
    #: Whether ``put`` consumes its frames as a stream, writing a batch
    #: at a time (the local executor spills a pure shuffle's partition
    #: buffers only into such a store).
    streaming = False

    def put(self, name: TaskName, partition: int, frames) -> None:
        """Store a partition's frames (consumed eagerly, in full, before
        put returns)."""
        raise NotImplementedError

    def committed(self, name: TaskName, partition: int) -> bool:
        raise NotImplementedError

    def read(self, name: TaskName, partition: int) -> Iterator[Frame]:
        raise NotImplementedError

    def prefetch(self, name: TaskName, partition: int) -> None:
        """Advisory read-ahead hint: a later ``read`` of this partition
        is likely (the executor's wave prefetcher hints upcoming waves'
        store-resident deps). Allowed to do nothing, as memory tiers do;
        the FileStore warms the partition into a bounded host cache off
        the caller's thread."""
        return None

    def drop(self, name: TaskName, partition: int) -> None:
        """Remove one partition entry (best-effort; default no-op)."""
        return None

    def discard(self, name: TaskName) -> None:
        raise NotImplementedError

    # Small named blobs beside the partitions (not task outputs).

    def put_aux(self, aux_name: str, data: bytes) -> None:
        raise NotImplementedError

    def get_aux(self, aux_name: str) -> Optional[bytes]:
        """The blob's bytes, or None when absent."""
        raise NotImplementedError


class MemoryStore(Store):
    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[Tuple[TaskName, int], List[Frame]] = {}
        self._aux: Dict[str, bytes] = {}

    def put(self, name, partition, frames):
        # Consume OUTSIDE the lock: lazy streams may read other
        # partitions from this same store.
        frames = list(frames)
        with self._lock:
            self._data[(name, partition)] = frames

    def committed(self, name, partition):
        with self._lock:
            return (name, partition) in self._data

    def read(self, name, partition):
        with self._lock:
            frames = self._data.get((name, partition))
        if frames is None:
            raise Missing(f"{name} p{partition}")
        return iter(list(frames))

    def drop(self, name, partition):
        with self._lock:
            self._data.pop((name, partition), None)

    def discard(self, name):
        with self._lock:
            for key in [k for k in self._data if k[0] == name]:
                del self._data[key]

    def put_aux(self, aux_name, data):
        with self._lock:
            self._aux[aux_name] = bytes(data)

    def get_aux(self, aux_name):
        with self._lock:
            return self._aux.get(aux_name)


class FileStore(Store):
    """Durable partition store under a local directory or a URL prefix
    (``utils/fileio.py``; ``memory://`` is one filesystem a process, so
    give each store its own prefix). Reads stream a frame at a time
    (``codec.read_stream``), so a spilled partition never materializes
    whole on read-back; a corrupt file is moved aside (``*.quarantine``)
    and its read raises ``Missing``, the lost-output signal that re-runs
    its producers."""

    streaming = True

    def __init__(self, prefix: str):
        self.prefix = fileio.join(prefix)
        # Corrupt partition files moved aside on read (see _quarantine).
        self.quarantined = 0
        self._warm_lock = threading.Lock()
        # (name, partition) -> frames read ahead by prefetch. A failed
        # prefetch inserts nothing: read() then takes the direct path,
        # which raises the authoritative error.
        self._warm: Dict[Tuple[TaskName, int], List[Frame]] = {}
        self._warm_pending: set = set()
        # Per-name generation, bumped by put(), drop() and discard(): a
        # prefetch that started before the bump must not insert its
        # stale frames over a recomputed task's fresh output.
        self._warm_gen: Dict[TaskName, int] = {}
        # ONE worker drains the hints in order (started on first use,
        # retired when idle): read-ahead never fans out a thread per
        # partition.
        self._warm_queue: list = []
        self._warm_worker_live = False

    @property
    def PREFETCH_CACHE_MAX(self) -> int:
        """The warm cache's bound: at most this many prefetched
        partitions held (FIFO); hints beyond it drop. Read at each use
        (``BIGSLICE_PREFETCH_CACHE``, default 32)."""
        env = os.environ.get("BIGSLICE_PREFETCH_CACHE")
        return int(env) if env else 32

    def _path(self, name: TaskName, partition: int) -> str:
        return fileio.join(self.prefix, f"inv{name.inv_index}",
                           name.op.replace("/", "_"),
                           f"{name.shard}-of-{name.num_shard}",
                           f"p{partition}")

    def _aux_path(self, aux_name: str) -> str:
        return fileio.join(self.prefix, "aux", aux_name.replace("/", "_"))

    def put_aux(self, aux_name, data):
        with fileio.atomic_write(self._aux_path(aux_name)) as fp:
            fp.write(bytes(data))

    def get_aux(self, aux_name):
        try:
            with fileio.open_read(self._aux_path(aux_name)) as fp:
                return fp.read()
        except FileNotFoundError:
            return None

    def put(self, name, partition, frames):
        with self._warm_lock:
            # New contents supersede anything warmed or in flight.
            self._warm_gen[name] = self._warm_gen.get(name, 0) + 1
            self._warm.pop((name, partition), None)
        with fileio.atomic_write(self._path(name, partition)) as fp:
            for f in frames:
                fp.write(codec.encode_frame(f))

    def committed(self, name, partition):
        return fileio.exists(self._path(name, partition))

    def prefetch(self, name, partition):
        key = (name, partition)
        spawn = False
        with self._warm_lock:
            if (key in self._warm or key in self._warm_pending
                    or len(self._warm_pending) >= self.PREFETCH_CACHE_MAX):
                return  # advisory: saturated read-ahead drops the hint
            self._warm_pending.add(key)
            self._warm_queue.append((key, self._warm_gen.get(name, 0)))
            if not self._warm_worker_live:
                self._warm_worker_live = True
                spawn = True
        if spawn:
            threading.Thread(target=self._prefetch_loop, daemon=True,
                             name="filestore-prefetch").start()

    def _prefetch_loop(self) -> None:
        # The worker-live flag retires on every exit path: a worker that
        # died with it set would end read-ahead for good.
        try:
            while True:
                with self._warm_lock:
                    if not self._warm_queue:
                        self._warm_worker_live = False
                        return
                    key, gen = self._warm_queue.pop(0)
                self._prefetch_one(key, gen)
        except BaseException:
            with self._warm_lock:
                self._warm_worker_live = False
            raise

    def _prefetch_one(self, key, gen: int) -> None:
        name, partition = key
        try:
            frames = list(self._read_direct(name, partition))
        except Exception:  # noqa: BLE001 — the worker must keep running
            # read() takes the direct path and raises the error itself.
            frames = None
        with self._warm_lock:
            self._warm_pending.discard(key)
            if frames is not None and self._warm_gen.get(name, 0) == gen:
                # No put/drop/discard raced this read: the frames are
                # current.
                self._warm[key] = frames
                while len(self._warm) > self.PREFETCH_CACHE_MAX:
                    self._warm.pop(next(iter(self._warm)))

    def read(self, name, partition):
        # A warm entry serves one read; a re-read streams from the file,
        # which stays authoritative.
        with self._warm_lock:
            warm = self._warm.pop((name, partition), None)
        if warm is not None:
            return iter(warm)
        return self._read_direct(name, partition)

    def _read_direct(self, name, partition):
        path = self._path(name, partition)
        try:
            fp = fileio.open_read(path)
        except FileNotFoundError as e:
            # Only true absence is Missing (-> DepLost -> recompute);
            # other IO errors surface as task errors.
            raise Missing(f"{name} p{partition}") from e

        def stream():
            try:
                with fp:
                    yield from codec.read_stream(fp)
            except codec.CorruptionError as e:
                # A corrupt file is a lost output, not a run error:
                # quarantine it so that committed() stops claiming it and
                # a recompute's put replaces it.
                self._quarantine(path)
                raise Missing(
                    f"{name} p{partition} (corrupt file quarantined)") from e

        return stream()

    def _quarantine(self, path: str) -> None:
        """Move a corrupt partition file aside (removing it if the rename
        fails), kept on disk for a post-mortem."""
        self.quarantined += 1
        try:
            fileio.rename(path, path + ".quarantine")
        except OSError:
            fileio.remove(path)

    def drop(self, name, partition):
        with self._warm_lock:
            self._warm_gen[name] = self._warm_gen.get(name, 0) + 1
            self._warm.pop((name, partition), None)
        fileio.remove(self._path(name, partition))

    def discard(self, name):
        with self._warm_lock:
            # An in-flight prefetch that read before this discard must
            # not repopulate the cache.
            self._warm_gen[name] = self._warm_gen.get(name, 0) + 1
            for k in [k for k in self._warm if k[0] == name]:
                del self._warm[k]
        path = self._path(name, 0)
        fileio.remove_tree(path.rsplit("/", 1)[0] if fileio.is_url(path)
                           else os.path.dirname(path))
