"""bigslice_tpu_torch — the PyTorch and CUDA port of bigslice_tpu.

The same Slice algebra, planner, task DAG and evaluator as the JAX
package, with device columns held as torch tensors and the device
path's kernels written by hand in CUDA C++ for Hopper
(``csrc/``). This package imports neither JAX nor ``bigslice_tpu``; its
tests hold it against both.

The device executor's mesh is one slot on one card, or one
``torch.distributed`` rank a slot, every rank running the same driver
(``exec/spmd.py``'s ``spmd_session()`` after
``utils.distributed.initialize()``; ``python -m
bigslice_tpu_torch.tools.run -launch N program.py`` starts N ranks).

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

String keys at scale take dictionary encoding (``frame/dictenc.py``,
``frame/strparse.py`` and the native host kernels of ``native/``): the
host encodes once, the count runs on the card. A slice's per-shard
output may be kept across sessions in files (``Cache``,
``CachePartial``, ``ReadCache``), and a tar file is a source
(``TarSlice``)::

    from bigslice_tpu_torch.models.urls import domain_count_encoded
    rows = domain_count_encoded(bs.Session(), 4, "urls.txt")
    res = bs.Session().run(bs.Cache(bs.Reduce(bs.Const(4, keys, vals),
                                              lambda a, b: a + b),
                                    "cache/counts"))

Global sequence attention is a combinator too (``SelfAttend`` over a
slice of three device vector columns q, k, v): on one device slot the
device executor runs it as the ring or Ulysses over S = 1 shard, and
over more shards, or over more than one rank, on its host tier's
broadcast reader::

    o = bs.Session().run(bs.SelfAttend(bs.Const(1, q, k, v), causal=True,
                                       heads=2))

Data lands and leaves through Arrow and Parquet (``ParquetReader``,
``Result.to_arrow``, ``to_pandas``, ``write_parquet``; ``pyarrow`` and
``fsspec`` are imported at first use), and stores, the spill exchange
and caches take any fsspec URL prefix (``memory://``, ``gs://``)::

    s = bs.ParquetReader(4, "memory://data/*.parquet",
                         out=[np.int32, np.int32])
    res = bs.Session().run(bs.Reduce(s, lambda a, b: a + b))
    res.write_parquet("memory://out/counts")
    from bigslice_tpu_torch.models.kmeans import kmeans
    centroids = kmeans(bs.Session(), points, k=16, iters=5)
"""

import importlib

__version__ = "0.1.0"

#: Each public name and the module that defines it, imported at first
#: use (PEP 562): ``import bigslice_tpu_torch`` alone loads neither torch
#: nor the executors, so a process that needs one light module (a parse
#: worker of ``frame/strparse.py``) stays light.
_EXPORTS = {
    "Cache": "ops.cache",
    "CachePartial": "ops.cache",
    "Cogroup": "ops.cogroup",
    "ColType": "slicetype",
    "Const": "ops.const",
    "Dep": "ops.base",
    "Exclusive": "ops.base",
    "Filter": "ops.mapops",
    "Flatmap": "ops.mapops",
    "Fold": "ops.fold",
    "Frame": "frame.frame",
    "Func": "ops.func",
    "func": "ops.func",
    "GroupByKey": "ops.groupby",
    "Head": "ops.mapops",
    "Invocation": "ops.func",
    "JoinAggregate": "ops.join",
    "LocalExecutor": "exec.local",
    "Map": "ops.mapops",
    "MapBatches": "ops.mapops",
    "Materialize": "ops.base",
    "MeshExecutor": "exec.meshexec",
    "ParquetReader": "ops.parquet",
    "Pragma": "ops.base",
    "Prefixed": "ops.mapops",
    "Procs": "ops.base",
    "ReadCache": "ops.cache",
    "ReaderFunc": "ops.source",
    "Reduce": "ops.reduce",
    "Repartition": "ops.reshuffle",
    "Reshard": "ops.reshuffle",
    "Reshuffle": "ops.reshuffle",
    "Result": "exec.session",
    "result_shard_rows": "frame.frame",
    "Scan": "ops.mapops",
    "ScanReader": "ops.source",
    "Schema": "slicetype",
    "SelfAttend": "ops.attention",
    "Session": "exec.session",
    "Slice": "ops.base",
    "TarSlice": "archive",
    "Unwrap": "ops.mapops",
    "WriterFunc": "ops.source",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value
