"""Local file IO for the stores: path joins, atomic writes, reads, and
bounded retry of transient failures.

Local paths only. A URL (``gs://...``, ``memory://...``) needs
``fsspec``, which this package does not use: it raises ``URLNotPorted``
by name.

Atomicity: a write goes to a temp file beside the target and is
renamed over it with ``os.replace``, so readers never observe a partial
file; on error the temp file is removed.

Transient failures: opens and commits retry with bounded exponential
backoff and jitter (``retry_transient``; ``BIGSLICE_IO_RETRIES``,
``BIGSLICE_IO_BACKOFF``). True absence (``FileNotFoundError``) never
retries: it is the store's ``Missing`` signal.
"""

from __future__ import annotations

import contextlib
import os
import random
import shutil
import tempfile
import time
from typing import BinaryIO, Callable, Iterator, Optional

from bigslice_tpu_torch.ops.reduce import LoweringNotPorted


class URLNotPorted(LoweringNotPorted):
    """A store path is a URL: object stores (fsspec) are not ported."""


def is_url(path: str) -> bool:
    return "://" in path


def _local(path: str) -> str:
    if is_url(path):
        raise URLNotPorted(
            f"{path}: URL store paths need fsspec, which is not ported; "
            f"use a local directory")
    return path


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
    return os.path.join(_local(parts[0]), *parts[1:])


def exists(path: str) -> bool:
    return retry_transient(lambda: os.path.exists(_local(path)),
                           f"exists {path}")


def open_read(path: str) -> BinaryIO:
    """Open for streaming binary read; raises FileNotFoundError when
    absent. Transient open failures retry."""
    return retry_transient(lambda: open(_local(path), "rb"), f"open {path}")


def size(path: str) -> Optional[int]:
    """File size in bytes, or None when the file is missing: cache
    eviction accounting, never a correctness input."""
    p = _local(path)
    with contextlib.suppress(OSError):
        return os.stat(p).st_size
    return None


def mtime(path: str) -> Optional[float]:
    """Last-modified time as a POSIX timestamp, or None when the file is
    missing: the result cache's TTL input, never correctness."""
    p = _local(path)
    with contextlib.suppress(OSError):
        return os.stat(p).st_mtime
    return None


def remove(path: str) -> None:
    """Best-effort removal of one file."""
    with contextlib.suppress(OSError):
        os.unlink(_local(path))


def rename(src: str, dst: str) -> None:
    os.replace(_local(src), _local(dst))


@contextlib.contextmanager
def atomic_write(path: str) -> Iterator[BinaryIO]:
    """Write ``path`` so that readers never observe a partial file; on
    error nothing is left behind."""
    d = os.path.dirname(_local(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
    ok = False
    try:
        with os.fdopen(fd, "wb") as fp:
            yield fp
        retry_transient(lambda: os.replace(tmp, path), f"commit {path}")
        ok = True
    finally:
        if not ok and os.path.exists(tmp):
            os.unlink(tmp)


def remove_tree(path: str) -> None:
    """Best-effort recursive removal of a directory."""
    if os.path.isdir(_local(path)):
        shutil.rmtree(path, ignore_errors=True)
