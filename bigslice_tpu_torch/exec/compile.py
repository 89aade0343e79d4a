"""The planner: slice DAG → task graph with pipeline fusion.

- *Pipelining*: chains of slices without shuffle dependencies fuse into
  a single task per shard (``pipeline``).
- *Memoization*: compilation is memoized per (slice, partitioning), so
  diamond-shaped DAGs share tasks.
- *Result reuse*: a ``Result`` of a prior run reuses its computed
  tasks; a consumer that needs them partitioned gets ``_shuffle``
  adapter tasks (``_compile_result``).
- *Combiner plumbing*: a consumer's combiner is wired into its
  *producer* tasks' partitioners for map-side combining; with machine
  combiners, the producers of one shuffle share a ``combine_key``.
- *Coded combines*: with a coded planner (``BIGSLICE_CODED=combine``,
  ``exec/codedplan.py``) a combining producer set of k shards becomes
  k + r striped coverage members (``_compile_coded``); unset, the graph
  is unchanged.

The task graph for a pipeline equals the JAX package's, name for name
(``graph_string``).
"""

from __future__ import annotations

import itertools
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from bigslice_tpu_torch import sliceio
from bigslice_tpu_torch.exec.task import (
    Partitioner,
    Task,
    TaskDep,
    TaskName,
    iter_tasks,
)
from bigslice_tpu_torch.ops.base import Slice, unwrap


def pipeline(slice_: Slice) -> List[Slice]:
    """The fusable chain starting at slice_ (outermost first); it stops
    at a ``Result`` (also under ``Prefixed``), whose tasks are reused,
    and before a ``Materialize``d slice, whose output is stored."""
    out: List[Slice] = []
    while True:
        if _is_result(unwrap(slice_)):
            return out
        out.append(slice_)
        deps = slice_.deps()
        if len(deps) != 1:
            return out
        if deps[0].shuffle or deps[0].slice.materialize:
            return out
        slice_ = deps[0].slice


def _is_result(slice_: Slice) -> bool:
    from bigslice_tpu_torch.exec.session import Result

    return isinstance(slice_, Result)


_compiler_serial = itertools.count(1)


class Compiler:
    def __init__(self, inv_index: int, shuffle_mode: Optional[str] = None,
                 machine_combiners: bool = False, coded=None):
        self.inv_index = inv_index
        # The coded k-of-n planner (exec/codedplan.py), frozen per
        # compilation: the session resolves BIGSLICE_CODED once a run.
        # None = unset, and the graph is today's (reference
        # exec/compile.py:66).
        self.coded = coded
        # Machine combiners: the producer tasks of one combining shuffle
        # share one combiner buffer (the local executor's
        # ``_machine_combine``), keyed by the stamped ``combine_key``.
        self.machine_combiners = machine_combiners
        # The shuffle-plan knob (exec/shuffleplan.py), frozen per
        # compilation: the session resolves BIGSLICE_SHUFFLE once per run
        # and stamps it on every task, so one run's boundaries never
        # straddle a change of the environment. "" is the frozen-unset
        # stamp (planner disengaged); None means no stamping compiler,
        # and the executor reads the environment itself.
        self.shuffle_mode = shuffle_mode
        # Monotonic serial (not id(self): ids recycle after GC and could
        # merge op groups from different compilations).
        self.serial = next(_compiler_serial)
        self._memo: Dict[Tuple, List[Task]] = {}
        self._op_names: Dict[str, int] = {}

    def compile(self, slice_: Slice,
                part: Optional[Partitioner] = None) -> List[Task]:
        """Compile ``slice_`` into one task per shard whose outputs are
        partitioned per ``part``."""
        if part is None:
            part = Partitioner(num_partition=1)
        # The memo key captures the full output-partitioning config, so
        # consumers with different partitioners never share producers.
        comb = part.combiner
        key = (
            id(slice_),
            part.num_partition,
            part.combine_key,
            id(part.partition_fn) if part.partition_fn is not None else None,
            id(comb.fn) if comb is not None else None,
        )
        if key in self._memo:
            return self._memo[key]

        chain = pipeline(slice_)
        if not chain:
            tasks = self._compile_result(unwrap(slice_), slice_, part)
            self._memo[key] = tasks
            return tasks
        innermost = chain[-1]
        num_tasks = slice_.num_shards

        # A shuffle dep's producer tasks partition their output into
        # num_tasks partitions and take the consumer's combiner
        # (map-side combining).
        dep_task_lists: List[Tuple[List[Task], object, Partitioner]] = []
        for dep_index, dep in enumerate(innermost.deps()):
            if dep.shuffle:
                dcomb = _frame_combiner(innermost, dep_index)
                combine_key = ""
                if self.machine_combiners and dcomb is not None:
                    # Deterministic per (dep slice, partitioning, fn):
                    # equivalent consumers share producers and buffer.
                    combine_key = (
                        f"mc-{self.inv_index}-{self.serial}-"
                        f"{id(dep.slice)}-{num_tasks}-{id(dcomb.fn)}"
                    )
                dep_part = Partitioner(
                    num_partition=num_tasks,
                    partition_fn=dep.partitioner,
                    combiner=dcomb,
                    combine_key=combine_key,
                )
            else:
                dep_part = Partitioner(num_partition=1)
            dep_task_lists.append(
                (self.compile(dep.slice, dep_part), dep, dep_part))

        op_name = "_".join(s.name.op for s in reversed(chain))
        loc = chain[0].name
        if loc.file:
            op_name = f"{op_name}@{os.path.basename(loc.file)}:{loc.line}"
        if loc.index:
            op_name = f"{op_name}#{loc.index}"
        # Distinct partition configs of one slice get distinct names, so
        # their store entries never clobber each other.
        seen = self._op_names.setdefault(op_name, 0)
        self._op_names[op_name] = seen + 1
        if seen:
            op_name = f"{op_name}~{seen}"

        place_out = _device_output(part, slice_.schema)

        def deps_for_shard(shard: int) -> List[TaskDep]:
            """The deps of the uncoded task at ``shard``, which are also
            a coded member's deps for unit ``shard``."""
            deps: List[TaskDep] = []
            for dep_tasks, dep, dep_part in dep_task_lists:
                if dep.shuffle:
                    # A coded producer set carries its CoverageGroup on
                    # every member: the consumer reads the k-of-n view.
                    grp = (getattr(dep_tasks[0], "coded_group", None)
                           if dep_tasks else None)
                    deps.append(TaskDep(tuple(dep_tasks), shard,
                                        expand=dep.expand,
                                        combine_key=dep_part.combine_key,
                                        coded=grp))
                else:
                    # Aligned read: shard i reads dep shard i's partition 0.
                    deps.append(TaskDep((dep_tasks[shard],), 0))
            return deps

        grp = None
        if (self.coded is not None and part.combiner is not None
                and not part.combine_key):
            # A coded boundary candidate: a map-side combine no machine
            # combiner shares (group_for declines k < 2).
            grp = self.coded.group_for(self.inv_index, op_name, num_tasks)
        if grp is not None:
            tasks = self._compile_coded(grp, chain, part, slice_, key,
                                        op_name, deps_for_shard, place_out)
            self._memo[key] = tasks
            return tasks

        tasks: List[Task] = []
        for shard in range(num_tasks):
            task = Task(
                name=TaskName(self.inv_index, op_name, shard, num_tasks),
                do=_make_do(chain, shard, place_out),
                deps=deps_for_shard(shard),
                partitioner=part,
                schema=slice_.schema,
                procs=slice_.procs,
                exclusive=slice_.exclusive,
            )
            # Structural metadata for the executor, which runs all shards
            # of a fused chain as one op group.
            task.chain = chain
            # Shuffle-plan stamps: the frozen knob, and why this
            # boundary can never spill (a machine-combined one re-combines
            # to one row a key, which spilled partials cannot honour).
            task.shuffle_mode = self.shuffle_mode
            task.spill_ineligible = (
                "machine-combiner buffer" if part.combine_key else None)
            task.group_key = (self.inv_index, op_name, self.serial, key)
            tasks.append(task)
        self._memo[key] = tasks
        return tasks

    def _compile_coded(self, grp, chain, part, slice_, key, op_name,
                       deps_for_shard, place_out) -> List[Task]:
        """The ``n = k + r`` striped coverage members of one coded
        boundary (reference exec/compile.py:303-351). Member ``i``
        computes units ``grp.covers(i)``, unit ``u`` being the uncoded
        task at shard ``u``'s work (its do closure, deps, partitioner
        and combiner), and stores each unit under
        ``grp.cover_name(u, i)``."""
        tasks: List[Task] = []
        for i in range(grp.n):
            deps: List[TaskDep] = []
            units = []
            for u in grp.covers(i):
                lo = len(deps)
                deps.extend(deps_for_shard(u))
                # (unit, do, dep_lo, dep_hi): the executor slices the
                # member's dep factories back apart per unit.
                units.append((u, _make_do(chain, u, place_out), lo,
                              len(deps)))
            task = Task(
                name=TaskName(self.inv_index, f"{op_name}~k{grp.k}r{grp.r}",
                              i, grp.n),
                do=_coded_body_unused,
                deps=deps,
                partitioner=part,
                schema=slice_.schema,
                procs=slice_.procs,
                exclusive=slice_.exclusive,
            )
            task.chain = chain
            task.coded_group = grp
            task.coded_units = units
            # The plan's stamp on the members alone (consumers keep
            # their configuration).
            task.partition_config = (f"coded:k{grp.k}r{grp.r}",)
            task.shuffle_mode = self.shuffle_mode
            # Per-unit outputs live under cover names the spill exchange
            # does not track: coverage members always run whole.
            task.spill_ineligible = "coded coverage partials"
            task.group_key = (self.inv_index, op_name, self.serial, key)
            tasks.append(task)
        grp.tasks = tuple(tasks)
        return tasks

    def _compile_result(self, result, slice_: Slice,
                        part: Partitioner) -> List[Task]:
        """Reuse a prior run's tasks; insert ``_shuffle`` adapter tasks
        when the consumer needs them partitioned or combined. ``slice_``
        is ``result`` or a ``Prefixed`` over it, whose schema the
        adapters take."""
        prior = list(result.tasks)
        if part.num_partition == 1 and part.combiner is None:
            return prior
        base_op = f"{prior[0].name.op}_shuffle" if prior else "_shuffle"
        seen = self._op_names.setdefault(base_op, 0)
        self._op_names[base_op] = seen + 1
        if seen:
            base_op = f"{base_op}~{seen}"
        place_out = _device_output(part, slice_.schema)

        def identity_do(dep_factories, place=None):
            reader = dep_factories[0]()
            return _placed(reader, place) if place_out else reader

        return [
            Task(name=TaskName(self.inv_index, base_op, shard, len(prior)),
                 do=identity_do, deps=[TaskDep((ptask,), 0)],
                 partitioner=part, schema=slice_.schema)
            for shard, ptask in enumerate(prior)
        ]


def _frame_combiner(consumer: Slice, dep_index: int = 0):
    # Consumers with per-dep combiners (JoinAggregate: each side reduces
    # with its own fn) expose a frame_combiners tuple parallel to deps().
    fcs = getattr(consumer, "frame_combiners", None)
    if fcs is not None:
        return fcs[dep_index]
    comb = consumer.combiner()
    if comb is None:
        return None
    fc = getattr(consumer, "frame_combiner", None)
    if fc is not None:
        return fc
    from bigslice_tpu_torch.ops.reduce import FrameCombiner

    return FrameCombiner(comb.fn, consumer.deps()[dep_index].slice.schema)


def _is_device_stage(s: Slice) -> bool:
    from bigslice_tpu_torch.ops.mapops import Filter, Flatmap, Map

    return (isinstance(s, (Map, Filter, Flatmap))
            and getattr(s, "mode", "") == "device")


def _device_input(s: Slice, dep_index: int = 0) -> bool:
    """Does stage ``s`` consume its input ``dep_index`` on the device: a
    device Map/Filter/Flatmap, a device combine (Reduce, either side of
    a JoinAggregate), a device Fold or the device group (GroupByKey)?
    Every other reader is a host consumer (Cogroup, MapBatches, Scan,
    host functions) or passes its frames through (Reshuffle, Reshard,
    Repartition, Prefixed, Head)."""
    from bigslice_tpu_torch.ops.fold import Fold
    from bigslice_tpu_torch.ops.groupby import GroupByKey
    from bigslice_tpu_torch.ops.join import JoinAggregate
    from bigslice_tpu_torch.ops.reduce import Reduce

    if isinstance(s, Reduce):
        return s.frame_combiner.device
    if isinstance(s, Fold):
        return s.device
    if isinstance(s, JoinAggregate):
        return s.frame_combiners[dep_index].device
    return isinstance(s, GroupByKey) or _is_device_stage(s)


def _device_output(part: Partitioner, schema) -> bool:
    """Does a task's output go through a device router (the routing
    hash over device keys, or a per-row device partitioner) or a device
    map-side combiner?"""
    from bigslice_tpu_torch.frame import ops as frame_ops
    from bigslice_tpu_torch.ops.reshuffle import RowPartitioner

    if part.combiner is not None and part.combiner.device:
        return True
    if part.num_partition <= 1 and part.combiner is None:
        return False  # streamed: no routing
    fn = part.partition_fn
    if fn is None:
        return all(frame_ops.device_key(ct) for ct in schema.key)
    return isinstance(fn, RowPartitioner)


def _placed(reader, place):
    for f in reader:
        yield place(f)


def _make_do(chain: Sequence[Slice], shard: int, place_out: bool = False):
    """Compose the chain's readers into one task body
    ``do(dep_factories, place=None) -> Reader``. Re-entrant: each call
    builds fresh readers, so lost-task reruns are safe.

    ``place`` (the local executor's ``Frame.to`` of its device) is the
    placement rule, applied here and nowhere else: a frame moves to the
    device only where a device consumer reads it (``_device_input``:
    a dependency's frames, or a stage's output feeding the next stage)
    and at the task's output when ``place_out`` (a device router or
    combiner follows, ``_device_output``). A host chain's frames stay
    on the host, so a host stage's numeric columns never make a round
    trip through the card. At the first device stage (from the
    innermost) the stream is re-chunked to ``sliceio.DEVICE_BATCH_ROWS``,
    once per chain; chains with a Head skip it."""
    from bigslice_tpu_torch.ops.mapops import Head

    stages = list(reversed(chain))  # innermost first
    bounded = any(isinstance(s, Head) for s in chain)

    def boundary(r):
        return sliceio.rebatch(r, sliceio.DEVICE_BATCH_ROWS)

    def do(dep_factories, place=None):
        def placed(reader, on):
            return _placed(reader, place) if on and place else reader

        dep_factories = [
            lambda f=f, i=i: placed(f(), _device_input(stages[0], i))
            for i, f in enumerate(dep_factories)]
        inserted = bounded
        if not inserted and _is_device_stage(stages[0]) and dep_factories:
            base = dep_factories[0]
            dep_factories = [lambda b=base: boundary(b())] + list(
                dep_factories[1:])
            inserted = True
        reader = stages[0].reader(shard, dep_factories)
        for s in stages[1:]:
            reader = placed(reader, _device_input(s))
            if not inserted and _is_device_stage(s):
                reader = boundary(reader)
                inserted = True
            r_prev = reader
            reader = s.reader(shard, [lambda r=r_prev: r])
        return placed(reader, place_out)

    return do


def _coded_body_unused(dep_factories, place=None):
    # A coverage member runs unit by unit (LocalExecutor._execute_coded):
    # reaching the task-level body means an executor missed that branch.
    raise RuntimeError(
        "coded coverage task body must run via _execute_coded, not task.do")


def compile_slice(slice_: Slice, inv_index: int = 1) -> List[Task]:
    """Compile an invocation's slice into root tasks (one per shard),
    outputs unpartitioned."""
    return Compiler(inv_index).compile(slice_, Partitioner(num_partition=1))


def graph_string(roots: Sequence[Task], locations: bool = True) -> str:
    """Deterministic text rendering of a task graph, for golden tests.
    ``locations=False`` strips file:line/index qualifiers so the text
    does not depend on call-site line numbers."""

    def clean(s: str) -> str:
        if locations:
            return s
        # Strip "@file.ext:line(#idx)" but keep the "@num_shard:shard"
        # task suffix (which has no dot).
        return re.sub(r"@[\w\-]+\.[\w\-]+:\d+(#\d+)?", "", s)

    lines = []
    for t in iter_tasks(roots):
        deps = []
        for d in t.deps:
            names = ",".join(clean(str(x.name)) for x in d.tasks)
            mark = "~" if d.expand else ""
            deps.append(f"[p{d.partition}{mark} <- {names}]")
        part = ""
        if t.num_partition > 1:
            part = f" part={t.num_partition}"
            if t.combiner is not None:
                part += "+combine"
        lines.append(f"{clean(str(t.name))}{part} deps={' '.join(deps) or '-'}")
    return "\n".join(lines) + "\n"
