"""bigslice_tpu_torch — the PyTorch and CUDA port of bigslice_tpu.

The same Slice algebra, planner, task DAG and evaluator as the JAX
package, with device columns held as torch tensors and the device
path's kernels written by hand in CUDA C++ for Hopper
(``csrc/``). This package imports neither JAX nor ``bigslice_tpu``; its
tests hold it against both.

What it runs today, through the device executor (on ``cuda`` by
default): ``Const`` sources, the device tier of ``Map``, ``Filter``,
``Flatmap`` (fixed fanout) and ``Head``, ``Reduce`` with any
device-traceable combine fn and int or float keys, ``Reshuffle`` /
``Repartition``, the aggregating inner join ``JoinAggregate``,
``GroupByKey`` (fixed-capacity groups as a vector column) and the
general ``Cogroup`` (per key, one list per input value column). The
local executor (``LocalExecutor``, also on ``cuda`` by default) runs all
of these shard by shard on task threads, and the host tier besides:
host functions, host (string) keys and columns, frame-level
partitioners and the sources ``ScanReader``, ``ReaderFunc`` and
``WriterFunc``::

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
"""

from bigslice_tpu_torch.exec.local import LocalExecutor
from bigslice_tpu_torch.exec.meshexec import MeshExecutor
from bigslice_tpu_torch.exec.session import Result, Session
from bigslice_tpu_torch.frame.frame import Frame, result_shard_rows
from bigslice_tpu_torch.ops.base import Dep, Slice
from bigslice_tpu_torch.ops.cogroup import Cogroup
from bigslice_tpu_torch.ops.const import Const
from bigslice_tpu_torch.ops.groupby import GroupByKey
from bigslice_tpu_torch.ops.join import JoinAggregate
from bigslice_tpu_torch.ops.mapops import Filter, Flatmap, Head, Map
from bigslice_tpu_torch.ops.reduce import Reduce
from bigslice_tpu_torch.ops.reshuffle import Repartition, Reshuffle
from bigslice_tpu_torch.ops.source import ReaderFunc, ScanReader, WriterFunc
from bigslice_tpu_torch.slicetype import ColType, Schema

__all__ = [
    "ColType",
    "Cogroup",
    "Const",
    "Dep",
    "Filter",
    "Flatmap",
    "Frame",
    "GroupByKey",
    "Head",
    "JoinAggregate",
    "LocalExecutor",
    "Map",
    "MeshExecutor",
    "ReaderFunc",
    "Reduce",
    "Repartition",
    "Reshuffle",
    "Result",
    "ScanReader",
    "Schema",
    "Session",
    "Slice",
    "WriterFunc",
    "result_shard_rows",
]
