"""bigslice_tpu_torch — the PyTorch and CUDA port of bigslice_tpu.

The same Slice algebra, planner, task DAG and evaluator as the JAX
package, with device columns held as torch tensors and the device
path's kernels written by hand in CUDA C++ for Hopper
(``csrc/``). This package imports neither JAX nor ``bigslice_tpu``; its
tests hold it against both.

What it runs today, through the device executor (on ``cuda`` by
default): ``Const`` sources, the device tier of ``Map``, ``Filter``,
``Flatmap`` (fixed fanout) and ``Head``, ``Reduce`` with any
device-traceable combine fn and int or float keys (dense int32 keys,
declared with ``dense_keys=`` or discovered from the data, as a table
of accumulators), ``Reshuffle`` / ``Repartition``, the aggregating
inner join ``JoinAggregate``, ``GroupByKey`` (fixed-capacity groups as
a vector column) and the general ``Cogroup`` (per key, one list per
input value column). The local executor (``LocalExecutor``, also on
``cuda`` by default) runs all of these shard by shard on task threads,
and the host tier besides: host functions, host (string) keys and
columns, frame-level partitioners and the sources ``ScanReader``,
``ReaderFunc`` and ``WriterFunc``. The device executor runs the host
tier on an inner local executor, so ``Session()`` runs every slice.

The rest of the user API: ``Fold`` (a keyed fold whose fn need not be
associative; a device-tier one is a stage of the device executor's
wave program, as many steps as its longest group), ``Reshard`` (a
shuffle to another shard count), ``Prefixed`` / ``Unwrap`` (a wider key
prefix), and on the local executor ``Scan`` (a per-shard sink) and
``MapBatches`` (a host function over whole frames). Computations may
be rooted in registered functions (``@func``, ``Session.run(func,
*args)``; ``@func(exclusive=True)`` takes the session alone), and
slices carry pragmas (``Procs``, ``Exclusive``, ``Materialize``) to
their tasks::

    import bigslice_tpu_torch as bs
    s = bs.Map(bs.Const(4, keys, vals), lambda k, v: (k & 0xFFFF, v))
    res = bs.Session().run(bs.Reduce(s, lambda a, b: a + b))
    rows = res.rows()
    j = bs.JoinAggregate(bs.Const(4, ak, av), bs.Const(4, bk, bv),
                         lambda a, b: a + b, lambda a, b: a + b)
    g = bs.Map(bs.GroupByKey(bs.Const(4, keys, vals), capacity=64),
               lambda k, grp, cnt: (k, grp.sum(), cnt))
    cg = bs.Cogroup(bs.Const(4, ak, av), bs.Const(4, bk, bv))
    from bigslice_tpu_torch.models.wordcount import wordcount
    res = bs.Session(executor=bs.LocalExecutor()).run(
        wordcount(4, "corpus.txt"))
    f = bs.Fold(bs.Const(4, keys, vals), lambda acc, v: acc * 31 + v,
                init=7)
    from bigslice_tpu_torch.models.maxint import int_max_func
    res = bs.Session().run(int_max_func, 4, keys, vals)
    res = bs.Session().run(bs.Reduce(bs.Const(1, keys, vals),
                                     lambda a, b: a + b, dense_keys=1 << 20))
"""

from bigslice_tpu_torch.exec.local import LocalExecutor
from bigslice_tpu_torch.exec.meshexec import MeshExecutor
from bigslice_tpu_torch.exec.session import Result, Session
from bigslice_tpu_torch.frame.frame import Frame, result_shard_rows
from bigslice_tpu_torch.ops.base import (Dep, Exclusive, Materialize,
                                         Pragma, Procs, Slice)
from bigslice_tpu_torch.ops.cogroup import Cogroup
from bigslice_tpu_torch.ops.const import Const
from bigslice_tpu_torch.ops.fold import Fold
from bigslice_tpu_torch.ops.func import Func, Invocation, func
from bigslice_tpu_torch.ops.groupby import GroupByKey
from bigslice_tpu_torch.ops.join import JoinAggregate
from bigslice_tpu_torch.ops.mapops import (Filter, Flatmap, Head, Map,
                                           MapBatches, Prefixed, Scan,
                                           Unwrap)
from bigslice_tpu_torch.ops.reduce import Reduce
from bigslice_tpu_torch.ops.reshuffle import Repartition, Reshard, Reshuffle
from bigslice_tpu_torch.ops.source import ReaderFunc, ScanReader, WriterFunc
from bigslice_tpu_torch.slicetype import ColType, Schema

__all__ = [
    "ColType",
    "Cogroup",
    "Const",
    "Dep",
    "Exclusive",
    "Filter",
    "Flatmap",
    "Fold",
    "Frame",
    "Func",
    "GroupByKey",
    "Head",
    "Invocation",
    "JoinAggregate",
    "LocalExecutor",
    "Map",
    "MapBatches",
    "Materialize",
    "MeshExecutor",
    "Pragma",
    "Prefixed",
    "Procs",
    "ReaderFunc",
    "Reduce",
    "Repartition",
    "Reshard",
    "Reshuffle",
    "Result",
    "Scan",
    "ScanReader",
    "Schema",
    "Session",
    "Slice",
    "Unwrap",
    "WriterFunc",
    "func",
    "result_shard_rows",
]
