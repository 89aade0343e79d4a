"""Cross-Session program cache: the identity of every wave program a
process has built, with its accounting.

A copy of the JAX package's ``serve/programcache.py``, adapted. There
the cache holds AOT-compiled XLA executables, so that a fresh Session
in a long-lived server performs zero XLA compiles. This package
compiles no wave program: the device executor's ``_program`` builds a
Python closure of torch calls and the prebuilt CUDA kernels, in
microseconds. Its cold costs are process-wide (the kernel library's
first-use ``nvcc`` build, cached on disk by digest; CUDA's module
loads; the CUDA context), and a fresh Session in the same process pays
none of them, cache or not. So an entry here holds the program's
repr-stable spec (its key parts) and ``build_s``, the seconds
``_program`` took to build it, and the cache is what the serving plane
reads: the content-fingerprinted identity of each program, whether a
fresh Session's programs are ones the process served before (a hit),
and how many it had to build after a miss.

Key design (what makes cross-session sharing *sound*):

- The executor's session-local program key embeds ``id()``s of the
  user stage functions. The cross-session key instead folds a
  **content fingerprint** of every user function the program closes
  over (bytecode, constants, names, closure cells and the globals it
  reads, recursively; modules hash by name, so ``torch`` hashes as
  ``np`` does). Anything that defeats fingerprinting (a closure over a
  tensor or an array, an exotic callable) keeps the program
  *session-local*: it never enters this cache.
- The rest of the key is the op **site** (file:line, the ``#N``
  re-invocation suffix stripped), the program kind, the repr-stable
  structural key (stage kinds, partition config, input columns, slack,
  subids, donation, the mesh signature), serve-only extra parts (the
  stage structure, output schema, the hash-lowering bit, the kernel
  selector's token), plus the per-call argument signature (the wave
  inputs' shapes and dtypes).
- Entries are ``(spec, build_s)``. Capacity is bounded (LRU); hits,
  misses, insertions, evictions and seconds saved are counted and ride
  the telemetry hub (``telemetry_summary()["program_cache"]``) and
  Prometheus (``bigslice_program_cache_total{outcome}``). The stats
  keep the JAX package's key names (``compile_s_saved``,
  ``compile_s_held``, ``compile_s_evicted``), so that ``/serve/stats``
  and Prometheus keep their schema: here they are build seconds, and
  near zero.

``BIGSLICE_PROGRAM_CACHE`` sets the capacity in entries (default 128);
``0``/``off`` disables the cross-session tier entirely.
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading
from typing import Optional, Tuple

DEFAULT_CAPACITY = 128

# Primitive const/cell types whose repr is stable and content-complete.
_PRIMITIVES = (type(None), bool, int, float, complex, str, bytes)


class Unfingerprintable(Exception):
    """A function closes over state we cannot stably fingerprint."""


def _const_token(v, depth: int):
    """Stable token for one code const / closure cell / default value.
    Raises Unfingerprintable for anything whose repr could embed a
    memory address or mutate between sessions."""
    if isinstance(v, _PRIMITIVES):
        return repr(v)
    if isinstance(v, (tuple, frozenset)):
        return (type(v).__name__,
                tuple(_const_token(x, depth) for x in v))
    code = getattr(v, "co_code", None)
    if code is not None:  # nested code object (comprehension, lambda)
        return _code_token(v, depth)
    raise Unfingerprintable(type(v).__name__)


def _code_token(code, depth: int):
    if depth > 8:
        raise Unfingerprintable("nesting too deep")
    return (
        "code",
        code.co_name,
        code.co_argcount,
        code.co_flags,
        code.co_code.hex(),
        tuple(_const_token(c, depth + 1) for c in code.co_consts),
        code.co_names,
        code.co_varnames,
        code.co_freevars,
    )


def _global_tokens(fn, code, depth: int) -> tuple:
    """Value tokens for the module globals a function reads. Closure
    cells and defaults are value-hashed; globals must be too, or two
    programs reading different global values (same bytecode, same
    names) would share one identity. ``co_names``
    mixes global loads with attribute names, so only names that
    actually resolve in ``fn.__globals__`` count (builtins and
    attribute names are skipped — stable by construction). Modules
    hash by name (numpy and torch are stable libraries); functions
    recurse; primitives hash by value; anything else (mutable objects,
    arrays, tensors) is Unfingerprintable, keeping the program
    session-local."""
    g = getattr(fn, "__globals__", None)
    if g is None:
        return ()
    names = set(code.co_names)
    stack = list(code.co_consts)
    while stack:  # nested code objects read globals too
        c = stack.pop()
        if hasattr(c, "co_names"):
            names.update(c.co_names)
            stack.extend(c.co_consts)
    out = []
    for name in sorted(names):
        if name not in g:
            continue  # builtin or attribute name: stable
        v = g[name]
        if isinstance(v, type(os)):  # module
            out.append((name, "module", v.__name__))
        elif callable(v) and getattr(v, "__code__", None) is not None:
            out.append((name, _fn_token(v, depth + 1)))
        else:
            out.append((name, _const_token(v, depth + 1)))
    return tuple(out)


def _fn_token(fn, depth: int = 0):
    if depth > 8:
        raise Unfingerprintable("nesting too deep")
    code = getattr(fn, "__code__", None)
    if code is None:
        raise Unfingerprintable(type(fn).__name__)
    cells = ()
    if fn.__closure__:
        cells = tuple(
            _cell_token(c.cell_contents, depth + 1)
            for c in fn.__closure__
        )
    defaults = ()
    if fn.__defaults__:
        defaults = tuple(
            _cell_token(d, depth + 1) for d in fn.__defaults__
        )
    return ("fn", getattr(fn, "__qualname__", fn.__name__),
            _code_token(code, depth), cells, defaults,
            _global_tokens(fn, code, depth))


def _cell_token(v, depth: int):
    """Closure cells / defaults may hold other functions (combiner
    factories): recurse; otherwise primitives only."""
    if callable(v) and getattr(v, "__code__", None) is not None:
        return _fn_token(v, depth)
    return _const_token(v, depth)


def fn_fingerprint(fns) -> Optional[tuple]:
    """Content fingerprint of the user functions a program closes
    over: the cross-session half of the cache key. ``fns`` is a
    sequence of callables (empty = a purely structural program, always
    fingerprintable). Returns None when any function defeats stable
    fingerprinting — the caller must then keep the program
    session-local."""
    try:
        return tuple(_fn_token(f) for f in fns)
    except Exception:
        return None


def serve_digest(op: str, kind: str, key_parts, extra,
                 fingerprint: tuple) -> str:
    """The cross-session program identity: op SITE (the compiler's
    ``#N`` re-invocation suffix stripped), program kind, the
    repr-stable structural key (which already folds the mesh-topology
    signature at the meshexec call sites), serve-only extra key parts
    (output schema, lowering-selection bits), and the user-fn content
    fingerprint. ``key_parts``/``extra`` must be repr-stable (no
    ids)."""
    site = op.split("#", 1)[0]
    payload = repr((site, kind, key_parts, extra, fingerprint)).encode()
    return hashlib.sha1(payload).hexdigest()


def cache_capacity() -> int:
    """Configured capacity in entries; 0 disables the cross-session
    tier (``BIGSLICE_PROGRAM_CACHE=0``/``off`` is the chicken bit)."""
    raw = os.environ.get("BIGSLICE_PROGRAM_CACHE", "").strip().lower()
    if raw in ("", None):
        return DEFAULT_CAPACITY
    if raw in ("off", "false", "no"):
        return 0
    try:
        return max(0, int(raw))
    except ValueError:
        return DEFAULT_CAPACITY


class ProgramCache:
    """Bounded process-scope LRU of wave-program specs.

    Keys are ``(digest, arg_signature)``: the serve digest above plus
    the wave inputs' (shape, dtype) tuple. Values are ``(spec,
    build_s)``. Thread-safe; all accounting is O(1) under one lock."""

    def __init__(self, capacity: Optional[int] = None):
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[Tuple, Tuple]" = \
            collections.OrderedDict()
        self._capacity = (cache_capacity() if capacity is None
                          else max(0, int(capacity)))
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.discards = 0
        self.compile_s_saved = 0.0     # compile seconds hits avoided
        self.compile_s_held = 0.0      # invested in live entries
        self.compile_s_evicted = 0.0   # invested then evicted

    @property
    def enabled(self) -> bool:
        return self._capacity > 0

    def get(self, digest: str, sig: tuple):
        """The spec held for (digest, sig), or None. A hit refreshes
        recency and credits the entry's build seconds to
        ``compile_s_saved`` (the key name the serving plane
        advertises)."""
        if not self.enabled:
            return None
        key = (digest, sig)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            self.compile_s_saved += entry[1]
            return entry[0]

    def put(self, digest: str, sig: tuple, spec,
            compile_s: float) -> None:
        if not self.enabled:
            return
        key = (digest, sig)
        compile_s = max(0.0, float(compile_s))
        with self._lock:
            if key not in self._entries:
                self.inserts += 1
                self.compile_s_held += compile_s
            self._entries[key] = (spec, compile_s)
            self._entries.move_to_end(key)
            while len(self._entries) > self._capacity:
                _, (_, ev_s) = self._entries.popitem(last=False)
                self.evictions += 1
                self.compile_s_held -= ev_s
                self.compile_s_evicted += ev_s

    def discard(self, digest: str, sig: tuple) -> None:
        """Invalidate one entry."""
        with self._lock:
            entry = self._entries.pop((digest, sig), None)
            if entry is not None:
                self.discards += 1
                self.compile_s_held -= entry[1]

    def clear(self) -> None:
        """Drop every entry (tests)."""
        with self._lock:
            self._entries.clear()
            self.compile_s_held = 0.0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            n = self.hits + self.misses
            return {
                "enabled": self.enabled,
                "capacity": self._capacity,
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / n, 4) if n else None,
                "inserts": self.inserts,
                "evictions": self.evictions,
                "discards": self.discards,
                "compile_s_saved": round(self.compile_s_saved, 6),
                "compile_s_held": round(self.compile_s_held, 6),
                "compile_s_evicted": round(self.compile_s_evicted, 6),
            }


_global_lock = threading.Lock()
_global: Optional[ProgramCache] = None


def global_program_cache() -> ProgramCache:
    """The process-wide cache every wave program probes.
    Capacity is read from ``BIGSLICE_PROGRAM_CACHE`` at first use;
    tests that flip the env var should construct their own
    ``ProgramCache`` or call ``reset_global_program_cache()``."""
    global _global
    with _global_lock:
        if _global is None:
            _global = ProgramCache()
        return _global


def reset_global_program_cache() -> None:
    """Drop the singleton (tests): the next ``global_program_cache()``
    re-reads the capacity knob and starts with empty accounting."""
    global _global
    with _global_lock:
        old, _global = _global, None
    if old is not None:
        old.clear()


def program_cache_stats() -> dict:
    """The stats dict the telemetry hub surfaces as
    ``telemetry_summary()["program_cache"]``: zero-valued (but
    present) before the first program is built."""
    with _global_lock:
        cache = _global
    if cache is None:
        return ProgramCache(capacity=cache_capacity()).stats()
    return cache.stats()
