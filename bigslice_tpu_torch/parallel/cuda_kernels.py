"""The hand-written Hopper kernels and their plain PyTorch versions.

Three kernels, CUDA C++ in ``bigslice_tpu_torch/csrc/``, built by
``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface and loaded with ``ctypes``:

- ``hash_partition`` (csrc/hash_partition.cu): per-row routing id
  ``combine_hashes(fmix32(bits(key) ^ seed32)...) % nparts`` with the
  drop lane for invalid rows, plus the routable-row histogram.
- ``hash_aggregate`` (csrc/hash_aggregate.cu): open-addressed
  aggregation of rows into a destination-contiguous table, in three
  passes (bucket the rows by home slot range, aggregate each bucket in
  shared memory, place the rows a bucket could not hold); the wrapper
  plans the buckets (``aggregate_plan``) and allocates the scratch.
- ``probe_add1`` (csrc/probe.cu): the build probe behind
  ``kernels_available()``.

Each wrapper takes its plain version for tensors on the CPU, and only
then; for CUDA tensors it launches its kernel or raises. Each launch
runs on ``torch.cuda.current_stream()``, the kernel allocates nothing
(the wrapper allocates with torch), the C function returns
``cudaGetLastError()`` and the wrapper raises when it is not 0, and the
wrapper adds one to ``LAUNCHES[name]`` per launch and nowhere else (one
per ``hash_aggregate`` call, whose C function runs its three passes).

Each kernel declares the bytes and operations of a launch from its
arguments (``cost``): the least traffic of the function (each input
read once, each output written once) and its integer operations. The
telemetry hub sums them per op, and ``chip_smoke.py`` holds each
kernel's time against the same bytes. Where a launch runs inside
``launch_sink(fn)``, ``fn(name, cost)`` hears it at the increment of
``LAUNCHES``: the hub's per-op launch counts are those increments.

The library is built at first use, keyed by a hash of the sources and
flags, into ``bigslice_tpu_torch/_build/`` (one ``nvcc -c`` per source,
all started together, then one link). Loading it also loads every
kernel into the CUDA context (``bs_load_kernels``, csrc/probe.cu): under
CUDA's lazy module loading a kernel's first launch in a process would
otherwise wait for the device.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from bigslice_tpu_torch.frame.ops import _seed32
from bigslice_tpu_torch.parallel.dense import identity_table
from bigslice_tpu_torch.parallel.hashagg import SLOT_SEED_XOR

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: Kernel launches per wrapper since the last ``reset_launches()``.
LAUNCHES = {"hash_partition": 0, "hash_aggregate": 0, "probe_add1": 0}

#: Wall seconds of the last build in this process (0.0 when the library
#: was already built).
BUILD_SECONDS = 0.0

#: This process's build of the library: its file, wall seconds and
#: whether the digest's ``.so`` was already built (a cache hit).
BUILDS: list = []

# The launch listener of the running op (``launch_sink``).
_SINK: contextvars.ContextVar = contextvars.ContextVar(
    "bigslice_tpu_torch_launch_sink", default=None)

_LIB = None
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_AVAILABLE: Optional[bool] = None

# Column codes shared with csrc/common.cuh. bfloat16 takes the 16-bit
# float code: its -0.0 is 0x8000 too, and key_bits folds it onto +0.0.
_KEY_CODES = {
    torch.int32: 0, torch.uint32: 0, torch.float32: 1,
    torch.int16: 2, torch.uint16: 3, torch.int8: 4, torch.uint8: 5,
    torch.bool: 5, torch.float16: 6, torch.bfloat16: 6,
}
_VAL_DTYPE_CODES = {torch.int32: 0, torch.uint32: 1, torch.float32: 2}
_OP_CODES = {"add": 0, "max": 1, "min": 2}
MAX_COLS = 8


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str, **shape) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
    sink = _SINK.get()
    if sink is not None:
        sink(name, cost(name, **shape))


@contextlib.contextmanager
def launch_sink(fn):
    """Within the block (this thread's context), every counted launch
    also calls ``fn(name, cost)``; ``fn`` None is a no-op block."""
    if fn is None:
        yield
        return
    token = _SINK.set(fn)
    try:
        yield
    finally:
        _SINK.reset(token)


def cost(name: str, **shape) -> dict:
    """The declared work of one launch of kernel ``name``: ``{"bytes",
    "flops"}``, each input read once and each output written once, and
    the integer operations of the function.

    - ``hash_partition(n, key_itemsizes, valid, nparts, with_counts)``:
      the key columns, the mask's bytes and the int32 ids of n rows,
      plus the int32 histogram; the murmur fmix32 chain of each key (8
      operations) and the modulus.
    - ``hash_aggregate(n, key_itemsizes, val_itemsizes, nparts, R,
      val_lanes)``: the mask, keys, values (a vector column's itemsize
      is its row's bytes) and int32 partition ids of n rows in; the
      presence byte, keys and values of ``nparts * R`` slots out; the
      slot hash of each key and one op a value lane a row
      (``val_lanes``, default one a column).
    - ``probe_add1(numel)``: an int32 array read and written, one add
      an element.
    """
    if name == "hash_partition":
        n = int(shape["n"])
        kb = sum(shape["key_itemsizes"])
        nbytes = n * (kb + (1 if shape.get("valid") else 0) + 4)
        if shape.get("with_counts"):
            nbytes += 4 * int(shape["nparts"])
        flops = n * (8 * len(shape["key_itemsizes"]) + 2)
    elif name == "hash_aggregate":
        n = int(shape["n"])
        kb = sum(shape["key_itemsizes"])
        vb = sum(shape["val_itemsizes"])
        T = int(shape["nparts"]) * int(shape["R"])
        nbytes = n * (1 + kb + vb + 4) + T * (1 + kb + vb)
        flops = n * (8 * len(shape["key_itemsizes"]) + 2
                     + int(shape.get("val_lanes",
                                     len(shape["val_itemsizes"]))))
    elif name == "probe_add1":
        numel = int(shape["numel"])
        nbytes, flops = 8 * numel, numel
    else:
        raise ValueError(f"cost: unknown kernel {name!r}")
    return {"bytes": int(nbytes), "flops": int(flops)}


# -- build -----------------------------------------------------------------


def _nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                   "bin", "nvcc")
    return str(default) if default.exists() else None


def _digest(paths: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out: Path) -> None:
    sources = sorted(SRC_DIR.glob("*.cu"))
    tmp = BUILD_DIR / f"tmp-{out.stem}-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    objs = [tmp / (s.stem + ".o") for s in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", str(s),
             "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for s, o in zip(sources, objs)
    ]
    errors = []
    for s, p in zip(sources, procs):
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            errors.append(f"{s.name}:\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    lib_tmp = tmp / out.name
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
         str(lib_tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    if link.returncode != 0:
        raise RuntimeError(
            "nvcc link failed:\n" + link.stdout.decode(errors="replace"))
    os.replace(lib_tmp, out)
    shutil.rmtree(tmp, ignore_errors=True)


def build():
    """Build (once per source digest) and load the kernel library.
    Raises when ``nvcc`` is missing or fails, or the library does not
    load."""
    global _LIB, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        nvcc = _nvcc()
        if nvcc is None:
            raise RuntimeError("nvcc not found: cannot build the kernels")
        t0 = time.perf_counter()
        srcs = sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"libbigslice_kernels-{_digest(srcs)}.so"
        cache_hit = out.exists()
        if not cache_hit:
            _compile(nvcc, out)
        lib = ctypes.CDLL(str(out))
        vp, ci, cll, cu = (ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_uint)
        lib.bs_probe_add1.argtypes = [vp, cll, vp]
        lib.bs_hash_partition.argtypes = [
            vp, vp, ci, vp, vp, vp, cll, ci, cu, vp]
        lib.bs_hash_aggregate.argtypes = [
            vp, vp, ci, vp, vp, vp, ci, vp, vp, cll, ci, cll, cu, ci, ci,
            vp, vp, vp, vp, vp, vp, vp, vp, ci, vp]
        lib.bs_load_kernels.argtypes = []
        for fn in (lib.bs_probe_add1, lib.bs_hash_partition,
                   lib.bs_hash_aggregate, lib.bs_load_kernels):
            fn.restype = ci
        # Load every kernel now: under CUDA's lazy module loading a
        # kernel's first launch would otherwise wait for the device.
        _check(lib.bs_load_kernels(), "bs_load_kernels")
        BUILD_SECONDS = time.perf_counter() - t0
        BUILDS.append({"name": out.name, "wall_s": BUILD_SECONDS,
                       "cache_hit": cache_hit})
        _LIB = lib
        return lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _stream(device) -> int:
    """The raw handle of the current stream on ``device``."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


_PtrArray = ctypes.c_void_p * MAX_COLS
_IntArray = ctypes.c_int * MAX_COLS


def _ptrs(tensors: Sequence[torch.Tensor]):
    return _PtrArray(*[t.data_ptr() for t in tensors])


@functools.lru_cache(maxsize=256)
def _codes(codes: Tuple[int, ...]):
    """A C int array of ``codes`` (cached: the kernels only read it)."""
    return _IntArray(*codes)


@functools.lru_cache(maxsize=256)
def _key_codes(dtypes: Tuple[torch.dtype, ...]):
    return _codes(tuple(_KEY_CODES[d] for d in dtypes))


_seed32_cached = functools.lru_cache(maxsize=256)(_seed32)


def probe() -> bool:
    """K3: run the ``+1`` kernel over an (8, 128) int32 tensor on the
    card. Raises when the library does not build or the launch fails."""
    lib = build()
    x = torch.zeros((8, 128), dtype=torch.int32, device="cuda")
    _check(lib.bs_probe_add1(x.data_ptr(), x.numel(), _stream(x.device)),
           "probe_add1")
    _count("probe_add1", numel=x.numel())
    torch.cuda.synchronize()
    return bool((x == 1).all())


def kernels_available() -> bool:
    """Can this process build and run the kernels? False without a GPU
    or without ``nvcc``; otherwise the library is built and the probe
    kernel run (cached per process), and a failure raises."""
    global _AVAILABLE
    if _AVAILABLE is None:
        if not torch.cuda.is_available() or _nvcc() is None:
            _AVAILABLE = False
        else:
            _AVAILABLE = probe()
    return _AVAILABLE


def _check_cols(name: str, cols: Sequence[torch.Tensor], n: int,
                device, rows_only: bool = False) -> None:
    """Columns on ``device``, contiguous, of ``n`` rows: 1-D, or with
    ``rows_only`` of any per-row shape."""
    for c in cols:
        if c.device != device:
            raise ValueError(f"{name}: columns on {c.device} and {device}")
        if (c.dim() < 1 or c.shape[0] != n
                or (c.dim() != 1 and not rows_only)):
            raise ValueError(f"{name}: expected {'' if rows_only else '1-D '}"
                             f"columns of {n} rows, got shape "
                             f"{tuple(c.shape)}")
        if not c.is_contiguous():
            raise ValueError(f"{name}: columns must be contiguous")


# -- K1: hash_partition ----------------------------------------------------


def hash_partition(keys: Sequence[torch.Tensor], nparts: int, seed: int = 0,
                   with_counts: bool = True,
                   valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused hash + mask + partition (+ histogram) over key columns.

    Returns ``(ids int32[n], counts int32[nparts] | None)``: invalid rows
    get the drop-lane id ``nparts`` and are not counted. Bit-equal to
    the JAX package's ``pallas_kernels.hash_partition``.
    """
    keys = list(keys)
    n = keys[0].shape[0]
    device = keys[0].device
    if device.type == "cpu":
        return hash_partition_plain(keys, nparts, seed, with_counts, valid)
    _check_cols("hash_partition", keys, n, device)
    if valid is not None:
        _check_cols("hash_partition", [valid], n, device)
        if valid.dtype != torch.bool:
            raise ValueError("hash_partition: valid must be bool")
    if not 1 <= len(keys) <= MAX_COLS or any(
            k.dtype not in _KEY_CODES for k in keys):
        raise ValueError(
            f"hash_partition: unsupported key columns "
            f"{[k.dtype for k in keys]}")
    if not 1 <= nparts < 2**31:
        raise ValueError(f"hash_partition: nparts {nparts} out of range")
    ids = torch.empty(n, dtype=torch.int32, device=device)
    counts = (torch.zeros(nparts, dtype=torch.int32, device=device)
              if with_counts else None)
    if n == 0:
        return ids, counts
    lib = build()
    rc = lib.bs_hash_partition(
        *partition_args(keys, nparts, seed, valid, ids, counts))
    _check(rc, "hash_partition")
    _count("hash_partition", n=n,
           key_itemsizes=tuple(k.element_size() for k in keys),
           valid=valid is not None, nparts=nparts,
           with_counts=with_counts)
    return ids, counts


def partition_args(keys, nparts, seed, valid, ids, counts) -> tuple:
    """``bs_hash_partition``'s arguments over checked tensors (also what
    a bare-kernel timing passes)."""
    return (
        _ptrs(keys), _key_codes(tuple(k.dtype for k in keys)),
        len(keys), valid.data_ptr() if valid is not None else None,
        ids.data_ptr(), counts.data_ptr() if counts is not None else None,
        keys[0].shape[0], nparts, _seed32_cached(seed),
        _stream(keys[0].device),
    )


def hash_partition_plain(keys: Sequence[torch.Tensor], nparts: int,
                         seed: int = 0, with_counts: bool = True,
                         valid: Optional[torch.Tensor] = None):
    """The plain version of ``hash_partition``: the int64-masked murmur
    chain of frame/ops.py, on any device."""
    from bigslice_tpu_torch.frame import ops as frame_ops

    h = None
    for k in keys:
        kh = frame_ops.hash_device_column(k, seed)
        h = kh if h is None else frame_ops.combine_hashes(h, kh)
    ids = (h % nparts).to(torch.int32)
    if valid is not None:
        ids = torch.where(valid, ids, nparts).to(torch.int32)
    if not with_counts:
        return ids, None
    routed = ids[ids < nparts].to(torch.int64)
    counts = torch.bincount(routed, minlength=nparts)[:nparts]
    return ids, counts.to(torch.int32)


# -- K2: hash_aggregate ----------------------------------------------------


#: Shared memory a pass-B block of ``hash_aggregate`` gives its bucket's
#: sub-table: two such blocks fit one H100 SM's 227 KiB.
AGG_SMEM_BUDGET = 96 * 1024


class AggregatePlan(NamedTuple):
    """How ``hash_aggregate`` cuts its table, and its scratch sizes."""

    bucket_log2: int    # log2 of B, the consecutive slots of one bucket
    nbuckets: int       # T / B
    smem_bytes: int     # pass B's sub-table: B * (1 + nkeys + nvals) words
    payload_words: int  # pass A's bucketed rows: (nkeys + nvals) * n, and
                        # n more with the row lane
    spill_words: int    # pass B's spill list: 2 * n
    meta_words: int     # counts, starts, cursors and three counters


def aggregate_plan(nkeys: int, nvals: int, nparts: int, R: int,
                   n: int, row_lane: bool = False) -> AggregatePlan:
    """The bucket size for ``nkeys`` key and ``nvals`` value lanes (a
    [n, G] column is G lanes): the largest power of two B <= R whose
    sub-table (a claim word, the key lanes and the value lanes, 4 bytes
    each per slot) fits ``AGG_SMEM_BUDGET``. ``row_lane``: the payload
    also carries each row's index (the wide route's ``placed``)."""
    lanes = 1 + nkeys + nvals
    fit = AGG_SMEM_BUDGET // (4 * lanes)
    B = min(R, 1 << (fit.bit_length() - 1))
    nbuckets = nparts * R // B
    return AggregatePlan(
        bucket_log2=B.bit_length() - 1, nbuckets=nbuckets,
        smem_bytes=4 * lanes * B,
        payload_words=(nkeys + nvals + int(row_lane)) * n,
        spill_words=2 * n, meta_words=3 * nbuckets + 3)


def value_lanes(shape) -> int:
    """The 32-bit lanes a row of a value column of per-row ``shape``
    takes in K2: one for a scalar, G for [G] (the product of a larger
    shape)."""
    return math.prod(tuple(shape))


def aggregate_routes(val_shapes: Sequence,
                     val_dtypes: Optional[Sequence] = None
                     ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """K2's two routes over value columns of per-row ``val_shapes``
    (and ``val_dtypes``, default all the kernel's): ``(held, wide)``,
    the columns whose lanes the kernel holds and those scattered whole
    into their rows' slots after it. Narrow (every column of a dtype the
    kernel combines, every lane within ``MAX_COLS``): the kernel holds
    them all. Wide: it holds the first ``MAX_COLS`` scalar columns of
    its dtypes and places the rows; the rest are scattered."""
    shapes = [tuple(s) for s in val_shapes]
    kernel = [True] * len(shapes) if val_dtypes is None else [
        d in _VAL_DTYPE_CODES for d in val_dtypes]
    if all(kernel) and sum(value_lanes(s) for s in shapes) <= MAX_COLS:
        return tuple(range(len(shapes))), ()
    held = tuple(i for i, s in enumerate(shapes)
                 if not s and kernel[i])[:MAX_COLS]
    return held, tuple(i for i in range(len(shapes)) if i not in held)


class AggregateBuffers(NamedTuple):
    """``hash_aggregate``'s outputs and scratch, all ``torch.empty`` but
    ``placed``: the kernel writes every slot of the outputs and resets
    what it counts in."""

    present: torch.Tensor
    out_keys: List[torch.Tensor]
    tables: List[torch.Tensor]
    pay: torch.Tensor
    spill: torch.Tensor
    claim: torch.Tensor
    meta: torch.Tensor
    placed: Optional[torch.Tensor] = None  # [n] int32, -1 filled

    @property
    def overflow(self) -> torch.Tensor:
        return self.meta[-1]


def aggregate_buffers(plan: AggregatePlan, key_cols, val_cols, T: int,
                      device, placed: bool = False) -> AggregateBuffers:
    """Buffers for ``val_cols``, the columns the kernel holds: a [T]
    table for a scalar column, [T, *shape] for a vector one. ``placed``:
    also the wide route's [n] slot of each row, filled with -1."""
    def empty(size, dtype):
        return torch.empty(size, dtype=dtype, device=device)

    n = key_cols[0].shape[0]
    return AggregateBuffers(
        present=empty(T, torch.bool),
        out_keys=[empty(T, k.dtype) for k in key_cols],
        tables=[empty((T,) + tuple(v.shape[1:]), v.dtype) for v in val_cols],
        pay=empty(plan.payload_words, torch.int32),
        spill=empty(plan.spill_words, torch.int32),
        claim=empty(T, torch.int32),
        meta=empty(plan.meta_words, torch.int32),
        placed=(torch.full((n,), -1, dtype=torch.int32, device=device)
                if placed else None),
    )


def aggregate_supported(key_dtypes: Sequence, val_dtypes: Sequence,
                        nparts: int, R: int, n: int = 0,
                        val_shapes: Optional[Sequence] = None) -> bool:
    """Can ``hash_aggregate`` build this table on the card? Regions are
    powers of two; keys are at most ``MAX_COLS`` integer or bool columns
    (float keys never reach a hash lowering, parallel/keyutil.py);
    values are at least one column, scalar or of any per-row shape
    (``val_shapes``, default scalar), the kernel's own (int32, uint32,
    float32) or scattered after it (``aggregate_routes``); the table
    lives in device memory, so its size is bounded by int32 row ids,
    slots of rows the kernel places for the wide route, and bucket
    counts and 64-bit slot arithmetic."""
    if R < 1 or R & (R - 1):
        return False
    if not (1 <= len(key_dtypes) <= MAX_COLS and len(val_dtypes) >= 1):
        return False
    if any(d not in _KEY_CODES or d.is_floating_point for d in key_dtypes):
        return False
    if not (n < 2**31 and nparts * R < 2**40):
        return False
    if val_shapes is None:
        val_shapes = [() for _ in val_dtypes]
    held, wide = aggregate_routes(val_shapes, val_dtypes)
    if wide and nparts * R >= 2**31:
        return False
    lanes = sum(value_lanes(val_shapes[i]) for i in held)
    plan = aggregate_plan(len(key_dtypes), lanes, nparts, R, n)
    return plan.meta_words < 2**31


def hash_aggregate(valid: torch.Tensor, key_cols: Sequence[torch.Tensor],
                   val_cols: Sequence[torch.Tensor], ops: Sequence[str],
                   part: torch.Tensor, nparts: int, R: int, seed: int = 0):
    """Open-addressed aggregation of the selected rows into a
    ``T = nparts * R`` slot table, region p holding only partition-p
    keys. Returns ``(present bool[T], out_keys, out_vals, overflow
    int32 0-d)``; keys of empty slots repeat the last row's key, and
    value tables ([T], or [T, *shape] for a vector column) hold the
    op's identity there in every lane.

    Value columns take one of two routes (``aggregate_routes``): when
    their lanes fit the kernel's eight, the kernel combines them all,
    reading lane l of a [n, G] column at stride G; otherwise the kernel
    combines the scalar columns of its dtypes, writes each row's slot
    (``placed``), and the other columns (vector, or of a dtype it does
    not combine) are scattered whole into identity-filled tables by
    ``dense._scatter_tables`` (torch ops, the counterpart of the XLA
    scatter of the JAX package's table build, which also takes what its
    Pallas kernel cannot).

    The kernel's slot assignment (first claimer in a bucket wins)
    differs from the plain version's batched cascade: compare occupied
    rows, not slots. float32 ``add`` through atomics depends on the
    order of arrival.
    """
    key_cols = list(key_cols)
    val_cols = list(val_cols)
    n = key_cols[0].shape[0]
    device = key_cols[0].device
    if device.type == "cpu":
        return hash_aggregate_plain(valid, key_cols, val_cols, ops, part,
                                    nparts, R, seed)
    _check_cols("hash_aggregate", key_cols + [valid, part], n, device)
    _check_cols("hash_aggregate", val_cols, n, device, rows_only=True)
    if valid.dtype != torch.bool or part.dtype != torch.int32:
        raise ValueError("hash_aggregate: valid must be bool, part int32")
    if len(ops) != len(val_cols) or any(op not in _OP_CODES for op in ops):
        raise ValueError(f"hash_aggregate: bad ops {ops}")
    shapes = [tuple(v.shape[1:]) for v in val_cols]
    if not aggregate_supported([k.dtype for k in key_cols],
                               [v.dtype for v in val_cols], nparts, R, n,
                               shapes):
        raise ValueError(
            f"hash_aggregate: unsupported table (keys "
            f"{[k.dtype for k in key_cols]}, values "
            f"{[v.dtype for v in val_cols]} of shapes {shapes}, nparts "
            f"{nparts}, R {R})")
    T = nparts * R
    if n == 0:
        return _empty_table(key_cols, val_cols, ops, T, device)
    held, wide = aggregate_routes(shapes, [v.dtype for v in val_cols])
    hvals = [val_cols[i] for i in held]
    hops = [ops[i] for i in held]
    plan = aggregate_plan(len(key_cols),
                          sum(value_lanes(shapes[i]) for i in held),
                          nparts, R, n, row_lane=bool(wide))
    buf = aggregate_buffers(plan, key_cols, hvals, T, device,
                            placed=bool(wide))
    rc = build().bs_hash_aggregate(*aggregate_args(
        valid, key_cols, hvals, hops, part, nparts, R, seed, plan, buf))
    _check(rc, "hash_aggregate")
    _count("hash_aggregate", n=n,
           key_itemsizes=tuple(k.element_size() for k in key_cols),
           val_itemsizes=tuple(v.element_size() * value_lanes(sh)
                               for v, sh in zip(val_cols, shapes)),
           nparts=nparts, R=R,
           val_lanes=sum(value_lanes(sh) for sh in shapes))
    tables = [None] * len(val_cols)
    for i, t in zip(held, buf.tables):
        tables[i] = t
    if wide:
        from bigslice_tpu_torch.parallel.dense import _scatter_tables

        # Rows the kernel did not place (not selected, or overflow) land
        # in the drop slot T.
        idx = torch.where(buf.placed >= 0, buf.placed, T)
        _, wtables = _scatter_tables(idx, [val_cols[i] for i in wide],
                                     [ops[i] for i in wide], T + 1)
        for i, t in zip(wide, wtables):
            tables[i] = t[:T]
    return buf.present, buf.out_keys, tables, buf.overflow


def _value_lane_args(val_cols, tables):
    """Per value lane: its input's address, its table's, and its stride
    in words (G for each lane of a row-major [n, G] column)."""
    src, dst, strides = [], [], []
    for v, t in zip(val_cols, tables):
        G = value_lanes(v.shape[1:])
        step = v.element_size()
        for lane in range(G):
            src.append(v.data_ptr() + lane * step)
            dst.append(t.data_ptr() + lane * step)
            strides.append(G)
    return src, dst, strides


def aggregate_args(valid, key_cols, val_cols, ops, part, nparts, R, seed,
                   plan: AggregatePlan, buf: AggregateBuffers,
                   passes: int = 7) -> tuple:
    """``bs_hash_aggregate``'s arguments over checked tensors and the
    buffers of ``aggregate_buffers`` (also what a bare-kernel timing
    passes); ``val_cols`` are the columns the kernel holds, at most
    ``MAX_COLS`` lanes. ``passes`` picks the kernel's passes (bit 0:
    bucket, bit 1: aggregate, bit 2: spill); the wrapper runs all
    three."""
    src, dst, strides = _value_lane_args(val_cols, buf.tables)
    kinds = tuple(_VAL_DTYPE_CODES[v.dtype] * 3 + _OP_CODES[op]
                  for v, op in zip(val_cols, ops)
                  for _ in range(value_lanes(v.shape[1:])))
    return (
        _ptrs(key_cols), _key_codes(tuple(k.dtype for k in key_cols)),
        len(key_cols), _PtrArray(*src), _codes(kinds), _codes(tuple(strides)),
        len(src), valid.data_ptr(), part.data_ptr(), key_cols[0].shape[0],
        nparts, R, _seed32_cached(seed ^ SLOT_SEED_XOR), plan.bucket_log2,
        plan.nbuckets, buf.pay.data_ptr(), buf.spill.data_ptr(),
        buf.claim.data_ptr(), buf.meta.data_ptr(), buf.present.data_ptr(),
        _ptrs(buf.out_keys), _PtrArray(*dst),
        buf.placed.data_ptr() if buf.placed is not None else None, passes,
        _stream(valid.device),
    )


def _empty_table(key_cols, val_cols, ops, T: int, device):
    """The table of no rows: nothing present, zero keys, identities."""
    present = torch.zeros(T, dtype=torch.bool, device=device)
    out_keys = [torch.zeros(T, dtype=k.dtype, device=device)
                for k in key_cols]
    out_vals = [identity_table(op, v.dtype, T, device, tuple(v.shape[1:]))
                for v, op in zip(val_cols, ops)]
    return present, out_keys, out_vals, torch.zeros(
        (), dtype=torch.int32, device=device)


def hash_aggregate_plain(valid, key_cols, val_cols, ops, part,
                         nparts: int, R: int, seed: int = 0):
    """The plain version of ``hash_aggregate``: ``hashagg.claim_cascade``
    plus the identity-initialized scatter-accumulate, whole rows for a
    vector column — the JAX package's XLA lowering, slot for slot."""
    from bigslice_tpu_torch.parallel.dense import _scatter_tables
    from bigslice_tpu_torch.parallel.hashagg import claim_cascade
    from bigslice_tpu_torch.parallel.segment import take

    key_cols = list(key_cols)
    val_cols = list(val_cols)
    n = key_cols[0].shape[0]
    device = key_cols[0].device
    T = nparts * R
    if n == 0:
        return _empty_table(key_cols, val_cols, ops, T, device)
    winner, placed, ov = claim_cascade(valid, key_cols, part, nparts, R,
                                       seed)
    idx = torch.where(placed >= 0, placed, T)
    present, tables = _scatter_tables(idx, val_cols, ops, T + 1)
    winc = winner[:T].clamp(max=n - 1)
    out_keys = [take(k, winc) for k in key_cols]
    return present[:T], out_keys, [t[:T] for t in tables], ov


