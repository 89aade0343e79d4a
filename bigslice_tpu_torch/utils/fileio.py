"""File IO for the stores, the result cache and the sources: one seam
for local paths and object stores.

A path containing ``://`` routes to its ``fsspec`` filesystem
(``gs://``, ``s3://``, ``memory://``, ...), imported at first use; a
bare path uses plain ``os`` and ``open``. Without ``fsspec`` a URL
raises ``URLNotPorted`` by name.

Atomicity: a local write goes to a temp file beside the target and is
renamed over it with ``os.replace``, so readers never observe a partial
file; on error the temp file is removed. A URL write goes to a temp key
beside the target, moved onto it server-side when complete: an object
store commits a key when the upload closes (``memory://`` shows it at
open), so a failed writer leaves the final key untouched.

Transient failures: opens and commits retry with bounded exponential
backoff and jitter (``retry_transient``; ``BIGSLICE_IO_RETRIES``,
``BIGSLICE_IO_BACKOFF``). True absence (``FileNotFoundError``) never
retries: it is the store's ``Missing`` signal. The chaos plane's
``io.read`` and ``io.commit`` seams (``utils/faultinject.py``) sit
inside those retries, on both tiers.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import os
import random
import shutil
import tempfile
import time
from typing import BinaryIO, Callable, Iterator, Optional

from bigslice_tpu_torch.ops.reduce import LoweringNotPorted
from bigslice_tpu_torch.utils import faultinject

# Distinct temp keys for concurrent URL writes of one process.
_TMP_IDS = itertools.count()


class URLNotPorted(LoweringNotPorted):
    """A store path is a URL and ``fsspec`` is not installed."""


def is_url(path: str) -> bool:
    return "://" in path


def _fsspec(path: str):
    try:
        import fsspec
    except ImportError as e:
        raise URLNotPorted(
            f"{path}: URL store paths need fsspec, which is not "
            f"installed; use a local directory") from e
    return fsspec


def _fs(path: str):
    """The fsspec filesystem of a URL and the URL's path within it."""
    fs, _, paths = _fsspec(path).get_fs_token_paths(path)
    return fs, paths[0]


# Outcomes a retry cannot change: absence is the Missing signal, and
# permissions do not heal in milliseconds.
_NON_TRANSIENT = (FileNotFoundError, IsADirectoryError,
                  NotADirectoryError, PermissionError)


def io_retries() -> int:
    env = os.environ.get("BIGSLICE_IO_RETRIES")
    return max(0, int(env)) if env is not None else 2


def retry_transient(fn: Callable, what: str = "io"):
    """``fn()`` with up to ``io_retries()`` retries on transient
    OSErrors, with exponential backoff and jitter between attempts.
    Other exceptions and the ``_NON_TRANSIENT`` classes propagate at
    once. ``what`` names the operation for the caller's reading."""
    retries = io_retries()
    base = float(os.environ.get("BIGSLICE_IO_BACKOFF", "0.02"))
    attempt = 0
    while True:
        try:
            return fn()
        except OSError as e:
            if isinstance(e, _NON_TRANSIENT) or attempt >= retries:
                raise
            delay = base * (2 ** attempt) * (1.0 + random.random())
            attempt += 1
            if delay > 0:
                time.sleep(delay)


def join(*parts: str) -> str:
    """Path join that keeps a URL's scheme ('/' separator)."""
    if is_url(parts[0]):
        _fsspec(parts[0])
        return "/".join(p.strip("/") if i else p.rstrip("/")
                        for i, p in enumerate(parts))
    return os.path.join(*parts)


def exists(path: str) -> bool:
    def attempt():
        if is_url(path):
            fs, p = _fs(path)
            return fs.exists(p)
        return os.path.exists(path)

    return retry_transient(attempt, f"exists {path}")


def open_read(path: str) -> BinaryIO:
    """Open for streaming binary read; raises FileNotFoundError when
    absent (both tiers). Transient open failures retry."""
    def attempt():
        if faultinject.ENABLED:
            # Chaos seam (reference utils/fileio.py:105).
            faultinject.maybe_raise("io.read")
        if is_url(path):
            fs, p = _fs(path)
            f = fs.open(p, "rb")
            if isinstance(f, io.BytesIO):
                # memory:// hands every opener its one stored file,
                # position included: give this reader its own (the bytes
                # are shared, not copied).
                return io.BytesIO(f.getvalue())
            return f
        return open(path, "rb")

    return retry_transient(attempt, f"open {path}")


def size(path: str) -> Optional[int]:
    """File size in bytes, or None when unknowable (a missing file, an
    object store without a size field): cache eviction accounting,
    never a correctness input."""
    if is_url(path):
        fs, p = _fs(path)
        with contextlib.suppress(OSError):
            v = fs.info(p).get("size")
            return int(v) if v is not None else None
        return None
    with contextlib.suppress(OSError):
        return os.stat(path).st_size
    return None


def mtime(path: str) -> Optional[float]:
    """Last-modified time as a POSIX timestamp, or None when unknowable:
    the result cache's TTL input, never correctness."""
    if is_url(path):
        fs, p = _fs(path)
        with contextlib.suppress(OSError):
            info = fs.info(p)
            m = info.get("mtime") or info.get("LastModified") \
                or info.get("created")
            if m is None:
                return None
            ts = getattr(m, "timestamp", None)
            return float(ts() if callable(ts) else m)
        return None
    with contextlib.suppress(OSError):
        return os.stat(path).st_mtime
    return None


def remove(path: str) -> None:
    """Best-effort removal of one file (both tiers)."""
    if is_url(path):
        fs, p = _fs(path)
        with contextlib.suppress(OSError):
            fs.rm(p)
        return
    with contextlib.suppress(OSError):
        os.unlink(path)


def rename(src: str, dst: str) -> None:
    """``os.replace`` locally, a server-side move on object stores."""
    if is_url(src):
        fs, p = _fs(src)
        fs.mv(p, _fs(dst)[1])
        return
    os.replace(src, dst)


@contextlib.contextmanager
def atomic_write(path: str) -> Iterator[BinaryIO]:
    """Write ``path`` so that readers never observe a partial file; on
    error nothing is left behind."""
    if is_url(path):
        fs, p = _fs(path)
        with contextlib.suppress(OSError):
            fs.makedirs(p.rsplit("/", 1)[0], exist_ok=True)
        tmp = f"{p}.tmp-{os.getpid()}-{next(_TMP_IDS)}"
        ok = False
        try:
            with fs.open(tmp, "wb") as fp:
                yield fp

            def commit():
                if faultinject.ENABLED:
                    # Chaos seam (reference utils/fileio.py:185).
                    faultinject.maybe_raise("io.commit")
                fs.mv(tmp, p)

            retry_transient(commit, f"commit {path}")
            ok = True
        finally:
            if not ok:
                with contextlib.suppress(OSError):
                    fs.rm(tmp)
        return
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
    ok = False
    try:
        with os.fdopen(fd, "wb") as fp:
            yield fp

        def commit():
            if faultinject.ENABLED:
                # Chaos seam (reference utils/fileio.py:204).
                faultinject.maybe_raise("io.commit")
            os.replace(tmp, path)

        retry_transient(commit, f"commit {path}")
        ok = True
    finally:
        if not ok and os.path.exists(tmp):
            os.unlink(tmp)


def remove_tree(path: str) -> None:
    """Best-effort recursive removal of a directory or a URL prefix."""
    if is_url(path):
        fs, p = _fs(path)
        with contextlib.suppress(OSError):
            fs.rm(p, recursive=True)
        return
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
