"""Row-wise combinators: Map, Filter, Flatmap, Head; and the pipelined
slices MapBatches (a host function over whole frames), Scan (a
per-shard sink) and Prefixed (a wider key prefix, stripped by Unwrap).

Each combinator classifies its user function by tier, as the JAX
package does:

- **device**: the function is a tensor function of one row's columns —
  it runs under ``torch.func.vmap`` over whole device columns, as a
  stage of the executor's wave program;
- **host**: arbitrary Python, run per row on the host tier.

The verdict is a trace over meta tensors (shapes and dtypes, no data):
a function that the trace cannot run — data-dependent Python control
flow, ``.item()``, host objects, tensors made without the inputs'
device (``torch.tensor(..., device=x.device)`` is device tier) — is host
tier. So is a function that increments a user counter
(``utils/metrics.py``): traced, its increment would count traces, not
rows. A Map output that is a Python literal (``lambda c: (c, 1)``) is
broadcast to every row, as JAX's vmap does, in the declared ``out=``
dtype (else int32, float32 or bool). The local executor runs a host-tier stage (on the device
executor, its host tier) through the readers here, per row over the
frame's host copy.

The device tier's column functions (``Map.device_apply``,
``Filter.device_mask``, ``Flatmap.device_apply``) serve both the device
executor's wave program and the readers.

Outputs follow the 32-bit-first rule: a device function returning int64
or float64 columns is cast down to int32 or float32.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from bigslice_tpu_torch import sliceio, typecheck
from bigslice_tpu_torch.frame.frame import _DOWNCAST, Frame, _coerce
from bigslice_tpu_torch.ops.base import Slice, make_name, single_dep
from bigslice_tpu_torch.slicetype import (ColType, Schema, numpy_dtype,
                                          torch_dtype)
from bigslice_tpu_torch.utils import metrics as metrics_mod

# Why a traced function touching a counter is refused the device tier.
_METRICS_WHY = ("function increments metrics counters, which only count "
                "correctly on the host tier (a traced increment runs per "
                "trace, not per row)")

# The dtype a Python literal output takes without a declared one (JAX's
# weak types with 64-bit off).
_LITERAL_DTYPES = ((bool, torch.bool), (int, torch.int32),
                   (float, torch.float32))


def _as_schema(out, default_prefix: int = 1) -> Schema:
    if isinstance(out, Schema):
        return out
    cols = list(out)
    return Schema(cols, prefix=min(default_prefix, len(cols)))


def extra_tensors(args: Sequence, device=None) -> list:
    """A Map's extra arguments as tensors on ``device``, cast down to 32
    bits as frame columns are."""
    return [_coerce(a if isinstance(a, torch.Tensor) else
                    torch.as_tensor(a), device) for a in args]


def _meta(t_shape, dtype) -> torch.Tensor:
    return torch.empty(t_shape, dtype=dtype, device="meta")


def _literal_dtype(v, declared) -> Optional[torch.dtype]:
    """The dtype a literal output ``v`` broadcasts to: the declared one,
    else a numpy scalar's own (cast down to 32 bits), else int32,
    float32 or bool; None when ``v`` is no literal."""
    if isinstance(v, np.generic):
        dt = torch.from_numpy(np.asarray(v)).dtype
        dt = _DOWNCAST.get(dt, dt)
    else:
        dt = next((d for t, d in _LITERAL_DTYPES if type(v) is t), None)
    if dt is None:
        return None
    return declared if declared is not None else dt


def meta_outputs(fn: Callable, in_types: Sequence[ColType],
                 extra: Sequence[torch.Tensor] = (), why: list = None,
                 literals: Optional[Sequence] = None,
                 literal_at: Optional[list] = None):
    """``fn`` called on one row of meta tensors (plus the unbatched
    ``extra`` arguments as meta tensors) under a metrics ``TraceProbe``:
    its outputs as a tuple of meta tensors, or None when the call
    raises, touches a counter (the reason appended to ``why``) or
    returns anything but tensors. With ``literals`` (a declared torch
    dtype or None per output), a Python literal output stands as a
    0-d meta tensor of the dtype it broadcasts to, and its index is
    appended to ``literal_at``."""
    probe = metrics_mod.TraceProbe()
    try:
        with metrics_mod.scope_context(probe):
            out = fn(*[_meta(ct.shape, torch_dtype(ct.dtype))
                       for ct in in_types],
                     *[_meta(e.shape, e.dtype) for e in extra])
    except Exception:  # noqa: BLE001 — any failure means "not device tier"
        return None
    if probe.touched:
        if why is not None:
            why.append(_METRICS_WHY)
        return None
    if not isinstance(out, (tuple, list)):
        out = (out,)
    out = list(out)
    for i, o in enumerate(out):
        if isinstance(o, torch.Tensor):
            continue
        declared = (literals[i] if literals is not None
                    and i < len(literals) else None)
        dt = _literal_dtype(o, declared) if literals is not None else None
        if dt is None:
            return None
        out[i] = _meta((), dt)
        if literal_at is not None:
            literal_at.append(i)
    return tuple(out)


def _try_trace(fn: Callable, in_schema: Schema, extra: Sequence = (),
               why: list = None, literals: Optional[Sequence] = None):
    """``(schema, dtypes, literal)``: the output Schema of ``fn`` over
    one row of ``in_schema`` (plus the unbatched ``extra`` arguments),
    the torch dtypes ``fn`` itself returns (a literal's, the dtype it
    broadcasts to) and whether any output is a Python literal; None
    when it must run host tier."""
    if not all(ct.is_device for ct in in_schema):
        return None
    literal_at: list = []
    out = meta_outputs(fn, in_schema, extra_tensors(extra), why=why,
                       literals=literals, literal_at=literal_at)
    if out is None:
        return None
    try:
        cols = [ColType(numpy_dtype(_DOWNCAST.get(o.dtype, o.dtype)),
                        shape=tuple(o.shape)) for o in out]
    except KeyError:  # a dtype the device tier does not hold
        return None
    return (Schema(cols, prefix=min(1, len(cols))), [o.dtype for o in out],
            bool(literal_at))


def _cast_wrapper(fn: Callable, dtypes: Sequence[torch.dtype]) -> Callable:
    """``fn`` with its outputs cast to ``dtypes``; a literal output
    becomes a 0-d tensor on the first argument's device, which vmap
    broadcasts to every row."""

    def wrapper(*args):
        o = fn(*args)
        if not isinstance(o, (tuple, list)):
            o = (o,)
        return tuple(
            v.to(dt) if isinstance(v, torch.Tensor)
            else torch.as_tensor(v, dtype=dt, device=args[0].device)
            for v, dt in zip(o, dtypes))

    return wrapper


class _Pipelined(Slice):
    """Base for single-dep, non-shuffle (fusable) slices; each inherits
    its input's pragmas."""

    def __init__(self, dep_slice: Slice, schema: Schema, name, pragmas=()):
        super().__init__(schema, dep_slice.num_shards, name,
                         pragmas=tuple(pragmas) + tuple(dep_slice.pragmas))
        self.dep_slice = dep_slice

    def deps(self):
        return single_dep(self.dep_slice)


class Map(_Pipelined):
    """Per-record transform: ``fn(*row, *args) -> value | tuple``.

    A device-tier fn runs vmapped over whole columns; a host fn needs
    ``out=`` (a Schema or list of column types). ``args`` are passed
    unbatched as trailing arguments. ``mode`` is "auto" (trace to
    decide), "device" or "host".
    """

    def __init__(self, slice_: Slice, fn: Callable, out=None, mode="auto",
                 args: tuple = ()):
        name = make_name("map")
        self.fn = fn
        self.args = tuple(args)
        traced = None
        why: list = []
        if mode in ("auto", "device"):
            declared = None
            if out is not None:
                declared = [torch_dtype(ct.dtype) if ct.is_device else None
                            for ct in _as_schema(out)]
            traced = _try_trace(fn, slice_.schema, self.args, why=why,
                                literals=declared or ())
        if traced is not None:
            traced, dtypes, literal = traced
            self.mode = "device"
            schema = traced if out is None else _as_schema(out)
            if len(schema) != len(traced):
                raise typecheck.errorf(
                    "map: out= declares %d columns but function returns %d",
                    len(schema), len(traced),
                )
            if not all(ct.is_device for ct in schema):
                raise typecheck.errorf(
                    "map: a device function cannot produce host columns; "
                    "declare mode='host'"
                )
            # Declared out= types are shape-agnostic; the traced trailing
            # shapes are authoritative.
            schema = Schema([ColType(d.dtype, d.tag, t.shape)
                             for d, t in zip(schema, traced)],
                            schema.prefix)
            want = [torch_dtype(ct.dtype) for ct in schema]
            if dtypes != want or literal:
                # The cast wrapper IS the op's function from here on: the
                # executor vmaps self.fn and must see the schema's dtypes
                # (and tensors where fn returns literals).
                self.fn = _cast_wrapper(fn, want)
        else:
            if mode == "device":
                raise typecheck.errorf(
                    "map: %s", why[0] if why else
                    f"function is not a device function over "
                    f"{slice_.schema}")
            if out is None:
                raise typecheck.errorf(
                    "map: host-mode function requires out= column types%s",
                    f" ({why[0]})" if why else "")
            self.mode = "host"
            schema = _as_schema(out)
        super().__init__(slice_, schema, name)

    def device_apply(self, cols) -> list:
        """The device fn over whole columns: vmapped over rows, the
        extra arguments unbatched on the columns' device."""
        extras = extra_tensors(self.args, cols[0].device)
        out = torch.func.vmap(self.fn, in_dims=(0,) * len(cols)
                              + (None,) * len(extras))(*cols, *extras)
        out = list(out) if isinstance(out, (tuple, list)) else [out]
        # A broadcast literal comes back as a stride-0 view: columns are
        # contiguous (the kernels require it).
        return [o if o.is_contiguous() else o.contiguous() for o in out]

    def reader(self, shard, deps):
        def read():
            for f in deps[0]():
                if not len(f):
                    continue
                if self.mode == "device":
                    yield Frame(self.device_apply(list(f.cols)),
                                self.schema)
                else:
                    rows = [self.fn(*r, *self.args) for r in f.rows()]
                    rows = [r if isinstance(r, tuple) else (r,)
                            for r in rows]
                    yield Frame.from_rows(rows, self.schema)

        return read()


class MapBatches(_Pipelined):
    """Batch-level host transform: ``fn(frame) -> Frame | tuple of
    columns`` over whole frames, for host work that vectorizes (numpy
    over whole columns) without per-row Python. ``fn`` receives the
    frame with its columns on the host (device columns as CPU tensors);
    each device column it returns becomes a tensor of the declared
    dtype. ``out`` declares the output schema."""

    def __init__(self, slice_: Slice, fn: Callable, out):
        super().__init__(slice_, _as_schema(out), make_name("mapbatches"))
        self.fn = fn

    def reader(self, shard, deps):
        def read():
            for f in deps[0]():
                if not len(f):
                    continue
                o = self.fn(f.to_host())
                cols = list(o.cols) if isinstance(o, Frame) else list(o)
                yield Frame(_conform(cols, self.schema), self.schema)

        return read()


def _conform(cols, schema: Schema) -> list:
    """``cols`` held to ``schema``: each device column a tensor of the
    declared dtype (the frame's schema never lies about its columns),
    host columns as they are; a column count that differs raises."""
    if len(cols) != len(schema):
        raise typecheck.errorf(
            "batch function returned %d columns but out= declares %d",
            len(cols), len(schema),
        )
    out = []
    for c, ct in zip(cols, schema):
        if ct.is_device:
            t = c if isinstance(c, torch.Tensor) else torch.as_tensor(
                np.asarray(c))
            out.append(t.to(torch_dtype(ct.dtype)))
        else:
            out.append(c)
    return out


class Filter(_Pipelined):
    """Predicate filter: keeps the rows where ``pred(*row)`` is true."""

    def __init__(self, slice_: Slice, pred: Callable, mode="auto"):
        name = make_name("filter")
        self.pred = pred
        traced = None
        if mode in ("auto", "device"):
            traced = _try_trace(pred, slice_.schema)
        if traced is not None:
            traced = traced[0]
            if (len(traced) != 1 or traced[0].dtype.kind != "b"
                    or traced[0].shape != ()):
                raise typecheck.errorf(
                    "filter: predicate must return a scalar bool, got %s",
                    traced,
                )
            self.mode = "device"
        else:
            if mode == "device":
                raise typecheck.errorf(
                    "filter: predicate is not a device function")
            self.mode = "host"
        super().__init__(slice_, slice_.schema, name)

    def device_mask(self, cols) -> torch.Tensor:
        """The device predicate over whole columns: bool[n]."""
        return torch.func.vmap(self.pred)(*cols)

    def reader(self, shard, deps):
        def read():
            for f in deps[0]():
                if not len(f):
                    continue
                if self.mode == "device":
                    idx = torch.nonzero(
                        self.device_mask(list(f.cols))).squeeze(1)
                else:
                    idx = np.fromiter(
                        (i for i, r in enumerate(f.rows())
                         if self.pred(*r)), dtype=np.int64)
                if len(idx):
                    yield f.take(idx)

        return read()


class Flatmap(_Pipelined):
    """1→N transform.

    - **host** (no ``fanout``): ``fn(*row)`` yields output rows — the
      host tier;
    - **device** (``fanout=k``): ``fn(*row) -> (mask, col0, col1, ...)``
      where ``mask`` is bool[k] selecting valid outputs and each column
      is [k]-shaped; vmapped, the fn yields [n, k] planes that flatten
      row-major.
    """

    def __init__(self, slice_: Slice, fn: Callable, out,
                 fanout: Optional[int] = None):
        name = make_name("flatmap")
        self.fn = fn
        self.fanout = fanout
        schema = _as_schema(out)
        if fanout is not None:
            typecheck.check(fanout >= 1, "flatmap: fanout must be >= 1")
            typecheck.check(
                all(ct.is_device for ct in schema),
                "flatmap: fixed-fanout mode requires device column types",
            )
            if not all(ct.is_device for ct in slice_.schema):
                raise typecheck.errorf(
                    "flatmap: fixed-fanout mode requires device inputs")
            self._check_fixed_trace(slice_, fn, schema, fanout)
            self.mode = "device"
        else:
            self.mode = "host"
        super().__init__(slice_, schema, name)

    @staticmethod
    def _check_fixed_trace(slice_, fn, schema, fanout):
        """Construction-time shape check: clear errors at the call site,
        not mid-run."""
        out = meta_outputs(fn, [ColType(ct.dtype) for ct in slice_.schema])
        if out is None:
            raise typecheck.errorf(
                "flatmap: fixed-fanout function is not a device function "
                "over %s", slice_.schema,
            )
        if len(out) != 1 + len(schema):
            raise typecheck.errorf(
                "flatmap: fixed-fanout function must return (mask, %d "
                "columns), got %d outputs", len(schema), len(out),
            )
        for i, o in enumerate(out):
            if tuple(o.shape) != (fanout,):
                raise typecheck.errorf(
                    "flatmap: output %d has shape %s, want (%d,) — every "
                    "output (including the mask) must be fanout-wide",
                    i, tuple(o.shape), fanout,
                )
        if out[0].dtype != torch.bool:
            raise typecheck.errorf(
                "flatmap: first output must be a bool mask, got %s",
                out[0].dtype,
            )

    def device_apply(self, cols):
        """The fixed-fanout fn over whole columns: ``(mask [n, k],
        cols)``, each output column flattened row-major (a row's k
        outputs contiguous) and cast to the schema's dtype."""
        outs = torch.func.vmap(self.fn)(*cols)
        return outs[0], [o.reshape(-1).to(torch_dtype(ct.dtype))
                         for o, ct in zip(outs[1:], self.schema)]

    def reader(self, shard, deps):
        if self.mode == "device":
            return self._read_fixed(deps)
        return self._read_host(deps)

    def _read_host(self, deps):
        def read():
            pending = []
            for f in deps[0]():
                for r in f.rows():
                    for o in self.fn(*r):
                        pending.append(o if isinstance(o, tuple) else (o,))
                    if len(pending) >= sliceio.DEFAULT_CHUNK_ROWS:
                        yield Frame.from_rows(pending, self.schema)
                        pending = []
            if pending:
                yield Frame.from_rows(pending, self.schema)

        return read()

    def _read_fixed(self, deps):
        def read():
            for f in deps[0]():
                if not len(f):
                    continue
                mask, cols = self.device_apply(list(f.cols))
                idx = torch.nonzero(mask.reshape(-1)).squeeze(1)
                if len(idx):
                    yield Frame(cols, self.schema).take(idx)

        return read()


class Head(_Pipelined):
    """The first n rows of each shard."""

    def __init__(self, slice_: Slice, n: int):
        super().__init__(slice_, slice_.schema, make_name("head"))
        self.n = n

    def reader(self, shard, deps):
        def read():
            left = self.n
            for f in deps[0]():
                if left <= 0:
                    break
                take = min(left, len(f))
                if take:
                    yield f.slice(0, take)
                left -= take

        return read()


class Scan(_Pipelined):
    """Terminal per-shard sink: ``fn(shard, reader)`` consumes the
    shard's stream, and the resulting slice is empty.

    By default the remainder the sink did not consume is drained
    afterwards, so upstream side effects (WriterFunc taps) observe the
    whole shard even when the sink returns early. ``drain=False`` leaves
    it unread: the discarded remainder is never computed."""

    def __init__(self, slice_: Slice, fn: Callable, drain: bool = True):
        super().__init__(slice_, slice_.schema, make_name("scan"))
        self.fn = fn
        self.drain = drain

    def reader(self, shard, deps):
        r = deps[0]()
        self.fn(shard, r)
        if self.drain:
            for _ in r:
                pass
        return sliceio.empty_reader()


class _PrefixedSlice(_Pipelined):
    """The same rows with a wider key prefix."""

    def __init__(self, slice_: Slice, prefix: int):
        typecheck.check(prefix >= 1,
                        "prefixed: prefix must include at least one column")
        typecheck.check(
            prefix <= len(slice_.schema),
            "prefixed: prefix %d is greater than number of columns %d",
            prefix, len(slice_.schema),
        )
        super().__init__(slice_, Schema(list(slice_.schema), prefix=prefix),
                         make_name("prefixed"))

    def reader(self, shard, deps):
        def read():
            for f in deps[0]():
                yield Frame(f.cols, self.schema)

        return read()


def Prefixed(slice_: Slice, prefix: int) -> Slice:
    """``slice_`` keyed by its first ``prefix`` columns."""
    return _PrefixedSlice(slice_, prefix)


def Unwrap(slice_: Slice) -> Slice:
    """``slice_`` without its ``Prefixed`` wrappers."""
    from bigslice_tpu_torch.ops.base import unwrap

    return unwrap(slice_)
