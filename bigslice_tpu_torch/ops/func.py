"""Func registry and invocations.

A computation is rooted in a registered function (``@func``): an
*invocation* is (func, args, invocation index), the unit a session
compiles and runs. Every process of one program registers the same
Funcs in the same order, so the registry names code identically across
processes (``registry_digest``, ``func_locations``, ``registry_diff``);
a Func also carries the ``exclusive`` flag, under which its run takes
the session alone. This package keeps its own registry: a Func
registered with the JAX package is unknown here, and the reverse.
"""

from __future__ import annotations

import difflib
import hashlib
import itertools
import threading
from typing import Any, Callable, Sequence, Tuple

from bigslice_tpu_torch import typecheck
from bigslice_tpu_torch.ops.base import Slice

_registry_lock = threading.Lock()
_registry: list = []
#: Invocation indices, shared by every session of the process (a Func's
#: invocation and a plain run draw from the same count).
invocation_counter = itertools.count(1)


class Invocation:
    """A Func applied to arguments, with its invocation index."""

    def __init__(self, func: "Func", args: Tuple[Any, ...], index: int):
        self.func = func
        self.args = args
        self.index = index

    def invoke(self) -> Slice:
        out = self.func.fn(*self.args)
        if not isinstance(out, Slice):
            raise typecheck.TypecheckError(
                f"Func {self.func.name} returned {type(out).__name__}, "
                f"expected a Slice"
            )
        return out

    def __repr__(self):
        return f"Invocation#{self.index}({self.func.name})"


class Func:
    """A registered slice-producing function; registration order is
    its ``index``."""

    def __init__(self, fn: Callable[..., Slice], exclusive: bool = False,
                 name: str = ""):
        self.fn = fn
        self.exclusive = exclusive
        self.name = name or getattr(fn, "__name__", "func")
        with _registry_lock:
            self.index = len(_registry)
            _registry.append(self)

    def invocation(self, *args) -> Invocation:
        return Invocation(self, tuple(args), next(invocation_counter))

    def __call__(self, *args) -> Slice:
        """The slice DAG, built at once (no invocation)."""
        return self.fn(*args)

    def __repr__(self):
        return f"Func#{self.index}({self.name})"


def func(fn: Callable[..., Slice] = None, *, exclusive: bool = False):
    """Register a slice-producing function::

        @bigslice_tpu_torch.func
        def wordcount(path):
            ...
            return counts

    ``@func(exclusive=True)``: each run of it takes the session alone
    (``Session.run``)."""

    def wrap(f):
        return Func(f, exclusive=exclusive)

    if fn is not None:
        return wrap(fn)
    return wrap


def registered() -> Sequence[Func]:
    with _registry_lock:
        return tuple(_registry)


def registry_digest() -> str:
    """A digest of the registry (each Func's index and name, in order):
    processes that registered the same Funcs in the same order agree on
    it."""
    h = hashlib.sha256()
    for f in registered():
        h.update(f"{f.index}:{f.name}\n".encode())
    return h.hexdigest()


def func_locations() -> list:
    """Each Func's registration as ``"file:line: name"``, in registry
    order: the material ``registry_diff`` aligns."""
    out = []
    for f in registered():
        code = getattr(f.fn, "__code__", None)
        loc = (f"{code.co_filename}:{code.co_firstlineno}"
               if code is not None else "<builtin>")
        out.append(f"{loc}: {f.name}")
    return out


def registry_diff(mine: Sequence[str], other: Sequence[str],
                  mine_label: str = "this process",
                  other_label: str = "process 0") -> str:
    """The aligned difference of two ``func_locations`` lists, naming
    each registration only one side has; '' when they are equal."""
    if list(mine) == list(other):
        return ""
    lines = [f"func registrations differ ({other_label} vs "
             f"{mine_label}):"]
    sm = difflib.SequenceMatcher(a=list(other), b=list(mine),
                                 autojunk=False)
    for tag, a0, a1, b0, b1 in sm.get_opcodes():
        if tag == "equal":
            continue
        for i in range(a0, a1):
            lines.append(f"  - [{i}] {other[i]}  (only on {other_label})")
        for j in range(b0, b1):
            lines.append(f"  + [{j}] {mine[j]}  (only on {mine_label})")
    return "\n".join(lines)


def process_count() -> int:
    """The processes of this program: ``torch.distributed``'s world size
    when it is initialised, else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def verify_registry_across_hosts() -> None:
    """Raise on every rank if the processes of this program disagree on
    the registry (reference ops/func.py:168-207), naming the ranks whose
    digest differs from rank 0's and, for each, the registrations only
    one side has. The digests and locations are all-gathered, not
    broadcast: rank 0 must see a mismatch too, or it would sail on into
    a collective the drifted rank never enters. One process agrees with
    itself."""
    n = process_count()
    if n == 1:
        return
    import torch.distributed as dist

    mine = (registry_digest(), func_locations())
    every = [None] * n
    dist.all_gather_object(every, mine)
    ref_digest, ref_locs = every[0]
    bad = [r for r, (d, _) in enumerate(every) if d != ref_digest]
    if not bad:
        return
    detail = "\n".join(
        registry_diff(every[r][1], ref_locs, mine_label=f"rank {r}",
                      other_label="rank 0") for r in bad)
    raise RuntimeError(
        f"bigslice_tpu_torch Func registry differs between processes: "
        f"rank(s) {', '.join(map(str, bad))} disagree with rank 0; "
        f"ensure every process registers the same @func definitions in "
        f"the same order (no conditional registration)\n{detail}")
