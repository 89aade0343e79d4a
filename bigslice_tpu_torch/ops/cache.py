"""File-backed per-shard result caching: ``Cache``, ``CachePartial``
and ``ReadCache``.

A slice's per-shard output is kept at a user-named path prefix, one
file a shard, ``{prefix}-NNNN-of-MMMM``; on a re-run, cached shards
short-circuit their whole dependency subgraph (the deps are dropped at
compile time, so no producer task is even built). Keeping a cache
consistent across code changes is the user's responsibility.

Files hold the checksummed columnar codec (``frame/codec.py``) in a
zstd container when ``zstandard`` is installed, plain frames otherwise;
reads sniff either, and the files are the JAX package's, byte for byte.
Prefixes are local paths: a URL prefix raises ``URLNotPorted``.

On the device executor a cached slice runs on the host tier (its inner
local executor), reading a device producer's output through the store
bridge; the writethrough encodes host copies of its columns.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Optional

from bigslice_tpu_torch import typecheck
from bigslice_tpu_torch.frame import codec
from bigslice_tpu_torch.ops.base import Dep, Slice, make_name
from bigslice_tpu_torch.slicetype import Schema
from bigslice_tpu_torch.utils import fileio


def shard_path(prefix: str, shard: int, num_shards: int) -> str:
    return f"{prefix}-{shard:04d}-of-{num_shards:04d}"


# Process-scope outcome counts, one a shard: a hit is a shard served
# from its cache file, a miss a shard computed and written through,
# ``expired`` a file past the TTL, ``evicted`` a file the byte bound
# removed.
_rc_lock = threading.Lock()
_rc_counts = {"hit": 0, "miss": 0}


def _record_result_cache(outcome: str) -> None:
    with _rc_lock:
        _rc_counts[outcome] = _rc_counts.get(outcome, 0) + 1


def result_cache_counts() -> dict:
    """Snapshot of the process-wide result-cache outcome counters."""
    with _rc_lock:
        return dict(_rc_counts)


def reset_result_cache_counts() -> None:
    """Zero the counters (tests)."""
    with _rc_lock:
        for k in list(_rc_counts):
            _rc_counts[k] = 0


# -- TTL + byte-bounded LRU eviction ---------------------------------------
#
# Two independent policies, both optional, bound the cache:
#
# - **TTL** (``BIGSLICE_RESULT_CACHE_TTL_S`` / ``ttl_s``): a shard file
#   older than the TTL is an *expired* MISS — removed at presence-scan
#   time, recomputed, written through fresh (counter outcome
#   ``expired``).
# - **Byte-bounded LRU** (``BIGSLICE_RESULT_CACHE_MAX_BYTES`` /
#   ``max_bytes``): a process-scope registry tracks shard files by
#   last use (construction scan, read, writethrough all refresh); when
#   tracked bytes exceed the bound, least-recently-used files are
#   deleted (counter outcome ``evicted``). The most recent entry
#   always survives — evicting what was just written would make every
#   write useless.
#
# A read racing an eviction is safe: the open fd keeps streaming on
# POSIX, and a presence-map hit whose file vanished falls back to
# recompute + writethrough (``_CachedSlice._read_or_recompute``)
# instead of crashing the task.

_rc_policy = {"ttl_s": None, "max_bytes": None}
_rc_env_loaded = False
# path -> bytes, in LRU order (first = coldest); _rc_total_bytes is
# the maintained running sum so the byte-bound check is O(1) under
# the lock.
_rc_registry: "OrderedDict[str, int]" = OrderedDict()
_rc_total_bytes = 0


def _load_policy_env_locked() -> None:
    global _rc_env_loaded
    if _rc_env_loaded:
        return
    _rc_env_loaded = True
    ttl = os.environ.get("BIGSLICE_RESULT_CACHE_TTL_S")
    if ttl:
        _rc_policy["ttl_s"] = float(ttl)
    mb = os.environ.get("BIGSLICE_RESULT_CACHE_MAX_BYTES")
    if mb:
        _rc_policy["max_bytes"] = int(mb)


def configure_result_cache(ttl_s=..., max_bytes=...) -> None:
    """Set the eviction policy. ``None`` disables a policy; omitted
    arguments keep the current (environment-seeded) value."""
    with _rc_lock:
        _load_policy_env_locked()
        if ttl_s is not ...:
            _rc_policy["ttl_s"] = float(ttl_s) if ttl_s else None
        if max_bytes is not ...:
            _rc_policy["max_bytes"] = (int(max_bytes) if max_bytes
                                       else None)


def result_cache_policy() -> dict:
    """The active policy + registry footprint (stats surfaces)."""
    with _rc_lock:
        _load_policy_env_locked()
        return {
            "ttl_s": _rc_policy["ttl_s"],
            "max_bytes": _rc_policy["max_bytes"],
            "tracked_files": len(_rc_registry),
            "tracked_bytes": _rc_total_bytes,
        }


def reset_result_cache_policy() -> None:
    """Forget policy + registry and re-read the env next use (tests)."""
    global _rc_env_loaded, _rc_total_bytes
    with _rc_lock:
        _rc_env_loaded = False
        _rc_policy["ttl_s"] = None
        _rc_policy["max_bytes"] = None
        _rc_registry.clear()
        _rc_total_bytes = 0


def _expired(path: str) -> bool:
    """TTL check for one shard file; an expired file is removed and
    counted so the presence scan treats it as a miss."""
    with _rc_lock:
        _load_policy_env_locked()
        ttl = _rc_policy["ttl_s"]
    if not ttl:
        return False
    m = fileio.mtime(path)
    if m is None or time.time() - m <= ttl:
        return False
    fileio.remove(path)
    global _rc_total_bytes
    with _rc_lock:
        _rc_counts["expired"] = _rc_counts.get("expired", 0) + 1
        known = _rc_registry.pop(path, None)
        if known is not None:
            _rc_total_bytes -= known
    return True


def _touch(path: str, nbytes: Optional[int] = None) -> None:
    """Refresh ``path``'s LRU position (registering it when new),
    then enforce the byte bound. The stat of an unknown size runs
    outside the lock, and the bound check is O(1) against the running
    total, so concurrent cache reads never queue behind IO held under
    the lock."""
    global _rc_total_bytes
    with _rc_lock:
        _load_policy_env_locked()
        if _rc_policy["max_bytes"] is None:
            return
        known = _rc_registry.get(path)
    if nbytes is None:
        nbytes = known
    if nbytes is None:
        nbytes = fileio.size(path) or 0
    evict = []
    with _rc_lock:
        if _rc_policy["max_bytes"] is None:
            return
        prev = _rc_registry.pop(path, None)
        if prev is not None:
            _rc_total_bytes -= prev
        _rc_registry[path] = int(nbytes)
        _rc_total_bytes += int(nbytes)
        while _rc_total_bytes > _rc_policy["max_bytes"] \
                and len(_rc_registry) > 1:
            victim, vbytes = next(iter(_rc_registry.items()))
            del _rc_registry[victim]
            _rc_total_bytes -= vbytes
            evict.append(victim)
            _rc_counts["evicted"] = _rc_counts.get("evicted", 0) + 1
    for victim in evict:
        fileio.remove(victim)


class ShardCache:
    """The presence map, reads and writes of one cache prefix."""

    def __init__(self, prefix: str, num_shards: int):
        self.prefix = prefix
        self.num_shards = num_shards
        self.present = [
            self._usable(shard_path(prefix, s, num_shards))
            for s in range(num_shards)
        ]
        for s, ok in enumerate(self.present):
            if ok:  # presence scan == use: refresh LRU standing
                _touch(shard_path(prefix, s, num_shards))

    @staticmethod
    def _usable(path: str) -> bool:
        """A cached shard counts only if it exists, is within the TTL
        (expired files are removed and count as ``expired`` misses —
        recompute + overwrite), AND carries the current codec format
        (plain or zstd-compressed) — files from older formats are
        cache misses, not runtime crashes. Mid-file corruption still
        fails loud at read time (checksums). A 0-byte file is a
        legitimately empty shard (its reader yielded no frames), not a
        format mismatch."""
        if _expired(path):
            return False
        try:
            with fileio.open_read(path) as fp:
                head = fp.read(4)
                return head in (b"", codec.ZMAGIC) + codec.MAGICS
        except (OSError, FileNotFoundError):
            return False

    @property
    def all_cached(self) -> bool:
        return all(self.present)

    def is_cached(self, shard: int) -> bool:
        return self.present[shard]

    def read(self, shard: int):
        path = shard_path(self.prefix, shard, self.num_shards)
        _touch(path)
        with fileio.open_read(path) as fp:
            yield from codec.read_stream(codec.maybe_decompressed(fp))

    def writethrough(self, shard: int, reader):
        """Tee a shard stream into the cache file, atomically (a temp
        file renamed over it), zstd-compressed (plain when zstd is not
        installed; reads sniff either). A frame on the card is encoded
        from one host copy a column (``codec.encode_frame``). The
        committed file joins the LRU registry at its size, evicting
        colder entries past the byte bound."""
        path = shard_path(self.prefix, shard, self.num_shards)
        with fileio.atomic_write(path) as fp:
            zw = codec.open_compressed_write(fp)
            sink = zw if zw is not None else fp
            for f in reader:
                sink.write(codec.encode_frame(f))
                yield f
            if zw is not None:
                zw.close()  # finalize the zstd frame; fp stays open
        _touch(path, fileio.size(path))


_END = object()  # stream-exhausted sentinel for the read fallback


class _CachedSlice(Slice):
    """Wraps a slice with cache read/writethrough behavior per shard."""

    def __init__(self, slice_: Slice, cache: ShardCache, require_all: bool,
                 op: str):
        super().__init__(slice_.schema, slice_.num_shards, make_name(op),
                         pragmas=slice_.pragmas)
        self.dep_slice = slice_
        self.cache = cache
        # All-or-nothing (Cache) against per-shard (CachePartial).
        self.use_cache = (
            cache.all_cached if require_all
            else None  # per-shard decision
        )

    def _shard_cached(self, shard: int) -> bool:
        if self.use_cache is not None:
            return self.use_cache
        return self.cache.is_cached(shard)

    def deps(self):
        # When every shard is served from the cache the dependency
        # subgraph is dropped entirely: the compile-time short-circuit.
        if self.use_cache is True:
            return ()
        return (Dep(self.dep_slice),)

    def reader(self, shard, deps):
        if self._shard_cached(shard):
            return self._read_or_recompute(shard, deps)
        _record_result_cache("miss")
        return self.cache.writethrough(shard, deps[0]())

    def _read_or_recompute(self, shard, deps):
        """Serve the cached shard; when the file vanished between the
        presence scan and this read (a concurrent LRU eviction), fall
        back to recompute + writethrough instead of crashing the task.
        All-or-nothing caches whose dependency subgraph was dropped at
        compile time have nothing to recompute from — the read error
        stays loud there."""
        try:
            it = self.cache.read(shard)
            first = next(it, _END)
        except FileNotFoundError:
            if not deps:
                raise
            _record_result_cache("miss")
            yield from self.cache.writethrough(shard, deps[0]())
            return
        _record_result_cache("hit")
        if first is not _END:
            yield first
            yield from it


def Cache(slice_: Slice, prefix: str) -> Slice:
    """All-or-nothing cache: the short-circuit only when every shard is
    present."""
    cache = ShardCache(prefix, slice_.num_shards)
    return _CachedSlice(slice_, cache, require_all=True, op="cache")


def CachePartial(slice_: Slice, prefix: str) -> Slice:
    """Per-shard cache: cached shards read back, missing shards
    recompute and write through."""
    cache = ShardCache(prefix, slice_.num_shards)
    return _CachedSlice(slice_, cache, require_all=False, op="cachepartial")


class _ReadCacheSlice(Slice):
    def __init__(self, schema, num_shards: int, cache: ShardCache):
        super().__init__(schema, num_shards, make_name("readcache"))
        self.cache = cache

    def reader(self, shard, deps):
        _record_result_cache("hit")
        return self.cache.read(shard)


def ReadCache(schema, num_shards: int, prefix: str) -> Slice:
    """Read a cache written by an earlier session without recomputing;
    every shard must be present."""
    if not isinstance(schema, Schema):
        schema = Schema(schema)
    cache = ShardCache(prefix, num_shards)
    typecheck.check(
        cache.all_cached,
        "readcache: missing cached shards under prefix %s", prefix,
    )
    return _ReadCacheSlice(schema, num_shards, cache)
