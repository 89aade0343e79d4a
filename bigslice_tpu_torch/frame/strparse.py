"""Vectorized host-string parsing: the urls host sweep.

Per-line Python string ops cost about a microsecond a row, while
everything after the parse runs on the device tier. This module parses
and dictionary-encodes each line's URL domain (``models.urls._domain``)
with no per-row Python for ASCII rows, through a ladder of rungs, each
exact, each falling to the next when it cannot answer:

1. native (``bigslice_tpu_torch.native``): the CPython extension over
   the list in place, else the ctypes kernel over one joined buffer;
2. Arrow (``pyarrow``, imported when first needed), the chain below;
3. the exact per-row path, ``fallback_fn`` on each line.

``RUNGS`` counts the batches (or pool chunks) each rung answered.

The Arrow chain, one pass each:

1. Join lines with the 2-byte separator ``"\\n/"`` into ONE buffer.
   The trailing ``/`` is the trick: every row's tail is guaranteed a
   ``/`` terminator before any next-row byte, so the later
   before-first-slash split can never leak across rows.
2. ``bytes.translate`` ASCII-lower (memcpy speed; case never moves a
   delimiter byte).
3. Find each row's first ``//`` with a vectorized pair-mask over the
   buffer, resolving "first occurrence per row" with a REVERSED
   scatter (later writes win, so writing occurrences back-to-front
   leaves the first) — no sorts, no per-row find calls.
4. Build the after-``//`` tails as a ZERO-COPY Arrow StringArray over
   the same buffer (just a new offsets vector).
5. C++ ``split_pattern('/', max_splits=1)`` + ``list_element 0`` +
   ``utf8_rtrim('\\n')`` → the domains; ``dictionary_encode`` them so
   only per-batch UNIQUES cross back into Python for the global-vocab
   merge.

Rows whose bytes include non-ASCII re-parse through the exact Python
path (``str.lower`` is unicode-aware; the byte table is not), as does
any batch with embedded newlines (ambiguous join delimiter).

Multi-core hosts parse chunks across a process pool of the spawn
context (``parse_procs``, ``BIGSLICE_PARSE_PROCS``): threads would
serialize on the interpreter lock.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional, Sequence

import numpy as np

#: Batches (or pool chunks) each rung answered, since the last
#: ``reset_rungs()``: "native-list" (the extension), "native-buffer"
#: (the ctypes kernel), "arrow" and "python".
RUNGS = {"native-list": 0, "native-buffer": 0, "arrow": 0, "python": 0}
_RUNGS_LOCK = threading.Lock()


def reset_rungs() -> None:
    with _RUNGS_LOCK:
        for k in RUNGS:
            RUNGS[k] = 0


def _rung(name: str) -> None:
    with _RUNGS_LOCK:
        RUNGS[name] += 1


_NL = np.uint8(10)
_SLASH = np.uint8(ord("/"))
# ASCII-lower translation table (only A-Z move; '/' and '\n' fixed).
_LOWER = bytes(c + 32 if 65 <= c <= 90 else c for c in range(256))


def _domains_encoded(blob_b: bytes, n: int):
    """Arrow DictionaryArray of per-row domains over a lowered
    ``"\\n/"``-joined buffer of ``n`` rows (…content\\n/…content\\n/),
    or None when the buffer is ambiguous (embedded newlines)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if len(blob_b) > (1 << 31) - 8:
        return None  # Arrow int32 offsets would overflow silently
    blob = np.frombuffer(blob_b, np.uint8)
    nl = np.flatnonzero(blob == _NL)
    if len(nl) != n:
        return None
    starts = np.empty(n, np.int64)
    starts[0] = 0
    starts[1:] = nl[:-1] + 2
    # First "//" fully inside row content ([start, nl)): tail starts
    # after it; rows without one keep the row head. The separator's
    # own '/' can pair with a next row starting '/', but that pair's
    # position precedes the next row's start and filters out.
    slash = blob == _SLASH
    dd = np.flatnonzero(slash[:-1] & slash[1:])
    st = starts.copy()
    if len(dd):
        row = np.searchsorted(nl, dd, "left")
        keep = (dd >= starts[row]) & (dd + 1 < nl[row])
        rk, dk = row[keep], dd[keep]
        st[rk[::-1]] = dk[::-1] + 2  # reversed: first occurrence wins
    offs = np.empty(n + 1, np.int32)
    offs[:-1] = st
    offs[-1] = len(blob_b)
    tails = pa.StringArray.from_buffers(
        n, pa.py_buffer(offs.tobytes()), pa.py_buffer(blob_b)
    )
    heads = pc.list_element(
        pc.split_pattern(tails, "/", max_splits=1), 0
    )
    return pc.dictionary_encode(pc.utf8_rtrim(heads, "\n"))


def _merge_codes_raw(indices: np.ndarray, batch_vocab: list,
                     vocab) -> np.ndarray:
    """Batch dictionary → global-vocab int32 codes; only the batch's
    unique values touch Python. ONE implementation for the single- and
    pool-path merges so the quarantine below can't diverge.

    Non-ASCII dictionary values are QUARANTINED (code -1, never
    entered into the vocab): the byte-level lower mangles multibyte
    case, and every row that can map to such a value is re-parsed by
    _fix_nonascii anyway — entering them would permanently pollute the
    vocabulary (and inflate dense_keys=len(vocab) reduces)."""
    ascii_mask = np.fromiter((v.isascii() for v in batch_vocab),
                             bool, len(batch_vocab))
    remap = np.full(len(batch_vocab), -1, np.int32)
    if ascii_mask.any():
        keep = np.array(batch_vocab, dtype=object)[ascii_mask]
        remap[ascii_mask] = vocab.encode_extending(keep)
    return remap[indices].astype(np.int32)


def _merge_codes(enc, vocab) -> np.ndarray:
    return _merge_codes_raw(enc.indices.to_numpy(),
                            enc.dictionary.to_pylist(), vocab)


def _fix_nonascii(joined: bytes, lines, codes, vocab,
                  fallback_fn) -> None:
    """Re-parse rows whose bytes include non-ASCII through the exact
    Python path (in place)."""
    blob = np.frombuffer(joined, np.uint8)
    hi = np.flatnonzero(blob >= 128)
    if not len(hi):
        return
    nl = np.flatnonzero(blob == _NL)
    bad = np.unique(np.searchsorted(nl, hi, "left"))
    fixed = np.empty(len(bad), dtype=object)
    fixed[:] = [fallback_fn(lines[i]) for i in bad]
    codes[bad] = vocab.encode_extending(fixed)


def domains_codes_single(lines: Sequence, vocab,
                         fallback_fn: Callable,
                         max_rows: int = 1 << 20) -> np.ndarray:
    """Single-process vectorized parse+encode (see module doc).
    Inputs beyond ``max_rows`` process in slices so the joined buffer
    stays far from the Arrow int32-offset ceiling."""
    n = len(lines)
    if n == 0:
        return np.empty(0, np.int32)
    if n > max_rows:
        return np.concatenate([
            domains_codes_single(lines[i : i + max_rows], vocab,
                                 fallback_fn)
            for i in range(0, n, max_rows)
        ])

    def slow_path():
        _rung("python")
        out = np.empty(n, dtype=object)
        out[:] = [fallback_fn(u) for u in lines]
        return vocab.encode_extending(out)

    # Native rung first: one fused C pass (framing, span extraction,
    # lower, dict-encode) against the five-pass numpy and Arrow chain
    # below. Framing ambiguity -> None -> Arrow -> slow_path.
    native = _native_codes(lines, n, vocab, fallback_fn)
    if native is not None:
        return native

    try:
        import pyarrow  # noqa: F401
    except ImportError:
        return slow_path()
    try:
        joined = "\n/".join(lines).encode("utf-8") + b"\n/"
    except TypeError:  # non-str rows: the slow path's problem
        return slow_path()
    enc = _domains_encoded(joined.translate(_LOWER), n)
    if enc is None:
        return slow_path()
    _rung("arrow")
    codes = _merge_codes(enc, vocab)
    _fix_nonascii(joined, lines, codes, vocab, fallback_fn)
    return codes


def _native_codes(lines, n: int, vocab, fallback_fn):
    """Parse+encode through the native kernel; None when unavailable
    or the buffer framing is ambiguous. Uniques come back already
    lowered and ASCII-pure (non-ASCII domain spans arrive as -1 codes
    and re-parse through the exact Python path), so no quarantine pass
    is needed — the quarantine lives inside the kernel."""
    from bigslice_tpu_torch import native

    if not native.enabled():
        return None
    # Preferred: the extension parses the list in place (no joined
    # copy, embedded newlines exact); the ctypes kernel over a joined
    # buffer is the rung below, for hosts without Python.h.
    if not isinstance(lines, list):
        lines = (lines.tolist() if isinstance(lines, np.ndarray)
                 else list(lines))
    res = native.domains_encode_list(lines)
    rung = "native-list"
    if res is None:
        try:
            joined = "\n".join(lines).encode("utf-8") + b"\n"
        except TypeError:  # non-str rows: the slow path's problem
            return None
        res = native.domains_encode(joined, n)
        rung = "native-buffer"
    if res is None:
        return None
    _rung(rung)
    return _merge_native(res[0], res[1], lines, vocab, fallback_fn)


def _merge_native(local_codes, uniques, lines, vocab,
                  fallback_fn) -> np.ndarray:
    """Batch-local native codes → global-vocab codes. Uniques arrive
    lowered and ASCII-pure (the kernel quarantines non-ASCII domain
    spans as -1), so no quarantine pass is needed; -1 rows re-parse
    through the exact Python path."""
    n = len(local_codes)
    out = np.empty(n, np.int32)
    if uniques:
        keep = np.empty(len(uniques), dtype=object)
        keep[:] = uniques
        remap = np.asarray(vocab.encode_extending(keep), np.int32)
        ok = local_codes >= 0
        out[ok] = remap[local_codes[ok]]
    bad = np.flatnonzero(local_codes < 0)
    if len(bad):
        fixed = np.empty(len(bad), dtype=object)
        fixed[:] = [fallback_fn(lines[i]) for i in bad]
        out[bad] = vocab.encode_extending(fixed)
    return out


# ---------------------------------------------------------------- pool

_POOL = None
_POOL_PROCS = 0
_POOL_LOCK = threading.Lock()  # created at import: the lazy-creation
# alternative is itself a check-then-set race


def parse_procs() -> int:
    """Worker count for the parse pool (0/1 → no pool). Overridable via
    BIGSLICE_PARSE_PROCS for benchmarking and tests.

    NOTE the spawn-context contract that comes with the pool: spawn
    workers re-import the main script's ``__main__`` module, so a script
    run as ``python main.py`` MUST guard its pipeline behind
    ``if __name__ == "__main__":`` — an unguarded script would
    re-execute its whole pipeline inside every worker during spawn
    prepare. Set ``BIGSLICE_PARSE_PROCS=0`` to
    keep parsing single-process. ``_pool()`` additionally refuses to
    build a pool inside a process that is itself a multiprocessing
    worker, so even an unguarded script cannot recurse into a process
    explosion."""
    env = os.environ.get("BIGSLICE_PARSE_PROCS")
    if env:
        return max(0, int(env))
    return os.cpu_count() or 1


def _pool():
    """Lazy shared process pool (None when a pool cannot help).

    Spawn context, never fork: by parse time the parent runs task
    threads and may have started CUDA, and forking either can deadlock
    or break the child. A worker imports numpy, this module and
    ``native`` (the package's ``__init__`` loads nothing until a name is
    used), plus what the main script imports at its top level: a
    script that keeps ``import torch`` under its ``__main__`` guard
    spares each worker torch's start-up and memory. The pool is
    terminated at interpreter exit and whenever the proc count
    changes."""
    global _POOL, _POOL_PROCS
    import multiprocessing as _mp

    if _mp.parent_process() is not None:
        # This process IS a multiprocessing worker (e.g. a spawn worker
        # re-importing an unguarded main script): a nested pool
        # here recurses into a process explosion. Parse inline.
        return None
    procs = parse_procs()
    if procs < 2:
        return None
    # Locked check-then-create: executor worker threads parse shards
    # concurrently, and a race here would leak a whole spawned pool.
    with _POOL_LOCK:
        if _POOL is None or _POOL_PROCS != procs:
            import atexit
            import multiprocessing as mp

            _shutdown_pool_locked()
            ctx = mp.get_context("spawn")
            _POOL = ctx.Pool(procs)
            _POOL_PROCS = procs
            atexit.register(shutdown_pool)
        return _POOL


def shutdown_pool() -> None:
    """Terminate the shared parse pool (idempotent)."""
    with _POOL_LOCK:
        _shutdown_pool_locked()


def _shutdown_pool_locked() -> None:
    global _POOL, _POOL_PROCS
    if _POOL is not None:
        _POOL.terminate()
        _POOL.join()
        _POOL = None
        _POOL_PROCS = 0


def _worker_parse(args):
    """Pool worker: parse one "\\n/"-joined chunk. Native kernel first
    (rows cannot contain '\\n' under this framing, so every "\\n/" is a
    separator and the plain-framing rewrite below is exact — ambiguity
    makes BOTH tiers bail to None and the parent slow-paths the
    chunk); the Arrow chain is the rung below. Returns a tagged tuple
    so the parent runs the matching merge."""
    from bigslice_tpu_torch import native

    joined, n = args
    res = native.domains_encode(joined.replace(b"\n/", b"\n"), n)
    if res is not None:
        return ("native", res[0], res[1])
    enc = _domains_encoded(joined.translate(_LOWER), n)
    if enc is None:
        return None
    return ("arrow", enc.indices.to_numpy().astype(np.int32),
            enc.dictionary.to_pylist())


def domains_codes(lines: Sequence, vocab,
                  fallback_fn: Optional[Callable] = None,
                  chunk_rows: int = 1 << 14) -> np.ndarray:
    """Global-vocabulary int32 codes of ``_domain(line)`` per line.

    Parses across the host process pool when cores allow (one joined
    buffer per chunk ships to a worker; only per-chunk UNIQUE domains
    ship back), else the single-process vectorized path.
    """
    if fallback_fn is None:
        from bigslice_tpu_torch.models.urls import _domain as fallback_fn

    n = len(lines)
    pool = _pool() if n >= 2 * chunk_rows else None
    if pool is None:
        return domains_codes_single(lines, vocab, fallback_fn)
    chunks = [lines[i : i + chunk_rows]
              for i in range(0, n, chunk_rows)]
    jobs = [("\n/".join(ch).encode("utf-8") + b"\n/", len(ch))
            for ch in chunks]
    out = np.empty(n, np.int32)
    pos = 0
    for (joined, _), ch, res in zip(jobs, chunks,
                                    pool.map(_worker_parse, jobs)):
        if res is None:
            out[pos : pos + len(ch)] = domains_codes_single(
                ch, vocab, fallback_fn
            )
        elif res[0] == "native":
            _rung("native-buffer")
            out[pos : pos + len(ch)] = _merge_native(
                res[1], res[2], ch, vocab, fallback_fn
            )
        else:
            _rung("arrow")
            _tag, indices, batch_vocab = res
            codes = _merge_codes_raw(indices, batch_vocab, vocab)
            _fix_nonascii(joined, ch, codes, vocab, fallback_fn)
            out[pos : pos + len(ch)] = codes
        pos += len(ch)
    return out
