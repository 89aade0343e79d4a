"""Native host kernels: C compiled at first use, loaded with ctypes or as
a CPython extension.

Two sources, both host C (not CUDA), copies of the JAX package's:

- ``strscan.c`` (ctypes): dictionary-encode each row's URL domain over
  one "\\n"-joined buffer (``domains_encode``).
- ``strlist.c`` (a CPython extension, needs ``Python.h``): the same
  parse straight off a list of str (``domains_encode_list``), and the
  zlib CRC-32 of each str's UTF-8 bytes (``crc32_strings``), the host
  routing hash of str keys.

Each builds with ``cc -O3 -shared -fPIC`` into
``bigslice_tpu_torch/_build/``, its file named by a digest of its
source and flags, never beside the source. Every kernel has an exact
fallback at its call site, so a missing compiler or ``Python.h`` costs
throughput, never correctness; ``BIGSLICE_NATIVE=0`` forces the
fallbacks. ``CALLS`` counts each kernel's calls that returned a result.

This module imports neither torch nor the rest of the package, so a
parse worker that loads it stays light.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_SRC = os.path.join(_DIR, "strscan.c")
_LIST_SRC = os.path.join(_DIR, "strlist.c")
CFLAGS = ("-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB = None
_LOAD_FAILED = False
_LIST_MOD = None
_LIST_FAILED = False

#: Calls of each kernel that returned a result, since the last
#: ``reset_calls()``.
CALLS = {"domains_encode": 0, "domains_encode_list": 0, "crc32_strings": 0}
_CALLS_LOCK = threading.Lock()


def reset_calls() -> None:
    with _CALLS_LOCK:
        for k in CALLS:
            CALLS[k] = 0


def _count(name: str) -> None:
    with _CALLS_LOCK:
        CALLS[name] += 1


#: This process's first-use builds: one record a ``.so``, with its wall
#: seconds and whether the digest's file was already built (a cache
#: hit). The telemetry hub reports them.
BUILDS: list = []


def enabled() -> bool:
    return os.environ.get("BIGSLICE_NATIVE", "1") not in (
        "0", "false", "off")


def _so_path(src: str, extra: Sequence[str], tag: str) -> str:
    """The build's path: the source's stem and a digest of its bytes,
    the flags and ``tag`` (the interpreter's ABI, for the extension)."""
    h = hashlib.sha256(" ".join((*CFLAGS, *extra, tag)).encode())
    with open(src, "rb") as fh:
        h.update(fh.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"native-{stem}-{h.hexdigest()[:16]}.so")


def _build_locked(src: str, extra: Sequence[str] = (),
                  tag: str = "") -> Optional[str]:
    """Compile ``src`` unless its build exists; the .so path, or None
    when there is no compiler or the build fails."""
    so = _so_path(src, extra, tag)
    if os.path.exists(so):
        BUILDS.append({"name": os.path.basename(so), "wall_s": 0.0,
                       "cache_hit": True})
        return so
    cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("g++")
    if cc is None:
        return None
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    try:
        subprocess.run([cc, *CFLAGS, *extra, "-o", tmp, src], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: concurrent processes race safely
    except (subprocess.SubprocessError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    BUILDS.append({"name": os.path.basename(so),
                   "wall_s": time.perf_counter() - t0, "cache_hit": False})
    return so


def _load():
    """The ctypes library, built at first use; None when native is
    disabled or the toolchain is unavailable."""
    global _LIB, _LOAD_FAILED
    if not enabled():
        return None
    if _LIB is not None or _LOAD_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LOAD_FAILED:
            return _LIB
        so = _build_locked(_SRC)
        try:
            lib = ctypes.CDLL(so) if so else None
        except OSError:
            lib = None
        if lib is None:
            _LOAD_FAILED = True
            return None
        lib.bs_domains_encode.restype = ctypes.c_int64
        lib.bs_domains_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        _LIB = lib
        return _LIB


def _load_list():
    """The ``_strlist`` extension module, built at first use; None when
    native is disabled, ``Python.h`` is missing or the build or import
    fails."""
    global _LIST_MOD, _LIST_FAILED
    if not enabled():
        return None
    if _LIST_MOD is not None or _LIST_FAILED:
        return _LIST_MOD
    with _LOCK:
        if _LIST_MOD is not None or _LIST_FAILED:
            return _LIST_MOD
        inc = sysconfig.get_paths().get("include")
        mod = None
        if inc and os.path.exists(os.path.join(inc, "Python.h")):
            so = _build_locked(
                _LIST_SRC, extra=("-I" + inc,),
                tag=sysconfig.get_config_var("EXT_SUFFIX") or "")
            if so is not None:
                mod = _import_extension(so)
        if mod is None:
            _LIST_FAILED = True
            return None
        _LIST_MOD = mod
        return _LIST_MOD


def _import_extension(so: str):
    """Load the built ``_strlist`` from ``so`` without entering it in
    ``sys.modules`` (its init function is ``PyInit__strlist``)."""
    import importlib.machinery
    import importlib.util

    try:
        loader = importlib.machinery.ExtensionFileLoader("_strlist", so)
        spec = importlib.util.spec_from_file_location("_strlist", so,
                                                      loader=loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
    except ImportError:
        return None
    return mod


def rungs() -> dict:
    """Which native kernels this process can run (building them if
    needed): ``{"strscan": bool, "strlist": bool}``."""
    return {"strscan": _load() is not None,
            "strlist": _load_list() is not None}


def domains_encode_list(lines) -> Optional[Tuple[np.ndarray, List[str]]]:
    """Dictionary-encode each row's domain straight off a list of str
    (no joined copy, embedded newlines exact). Returns ``(codes,
    uniques)`` as ``domains_encode`` does; None when the extension is
    unavailable or a row is not str."""
    mod = _load_list()
    if mod is None:
        return None
    if not isinstance(lines, list):
        lines = list(lines)
    res = mod.domains_encode(lines)
    if res is None:
        return None
    _count("domains_encode_list")
    codes_b, uniques = res
    return np.frombuffer(codes_b, np.int32), uniques


def crc32_strings(lines) -> Optional[np.ndarray]:
    """uint32 zlib CRC-32 of each str's UTF-8 bytes. None when the
    extension is unavailable or an element is not str (a lone surrogate
    included: it needs Python's surrogatepass)."""
    mod = _load_list()
    if mod is None:
        return None
    if not isinstance(lines, list):
        lines = list(lines)
    res = mod.crc32_strings(lines)
    if res is None:
        return None
    _count("crc32_strings")
    return np.frombuffer(res, np.uint32)


def domains_encode(joined: bytes,
                   n: int) -> Optional[Tuple[np.ndarray, List[str]]]:
    """Dictionary-encode each row's domain over a "\\n"-joined (not
    lowered) buffer of ``n`` rows, each ending in "\\n".

    Returns ``(codes, uniques)``: int32 codes a row into the lowered
    unique domains, ``-1`` where the domain span is not ASCII (the
    caller re-parses those rows exactly). None when the kernel is
    unavailable or the framing is ambiguous (embedded newlines)."""
    lib = _load()
    if lib is None or n == 0:
        return None
    buf = np.frombuffer(joined, np.uint8)
    codes = np.empty(n, np.int32)
    # Worst case every row's domain is unique and spans its whole row.
    uniq_buf = np.empty(max(1, len(joined)), np.uint8)
    uniq_off = np.empty(n + 1, np.int64)
    rc = lib.bs_domains_encode(
        buf.ctypes.data, len(joined), n,
        codes.ctypes.data, uniq_buf.ctypes.data, len(uniq_buf),
        uniq_off.ctypes.data, n,
    )
    if rc < 0:
        return None
    _count("domains_encode")
    uniq_bytes = uniq_buf.tobytes()
    uniques = [uniq_bytes[uniq_off[i]:uniq_off[i + 1]].decode("ascii")
               for i in range(rc)]
    return codes, uniques
