"""The planner: slice DAG → task graph with pipeline fusion.

- *Pipelining*: chains of slices without shuffle dependencies fuse into
  a single task per shard (``pipeline``).
- *Memoization*: compilation is memoized per (slice, partitioning), so
  diamond-shaped DAGs share tasks.
- *Combiner plumbing*: a consumer's combiner is wired into its
  *producer* tasks' partitioners for map-side combining.

The task graph for a pipeline equals the JAX package's, name for name
(``graph_string``). Reuse of a prior run's ``Result`` as an input is
not part of this package yet.
"""

from __future__ import annotations

import itertools
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from bigslice_tpu_torch.exec.task import (
    Partitioner,
    Task,
    TaskDep,
    TaskName,
    iter_tasks,
)
from bigslice_tpu_torch.ops.base import Slice


def pipeline(slice_: Slice) -> List[Slice]:
    """The fusable chain starting at slice_ (outermost first)."""
    out: List[Slice] = []
    while True:
        out.append(slice_)
        deps = slice_.deps()
        if len(deps) != 1:
            return out
        if deps[0].shuffle:
            return out
        slice_ = deps[0].slice


_compiler_serial = itertools.count(1)


class Compiler:
    def __init__(self, inv_index: int, shuffle_mode: Optional[str] = None):
        self.inv_index = inv_index
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
            id(part.partition_fn) if part.partition_fn is not None else None,
            id(comb.fn) if comb is not None else None,
        )
        if key in self._memo:
            return self._memo[key]

        chain = pipeline(slice_)
        innermost = chain[-1]
        num_tasks = slice_.num_shards

        # A shuffle dep's producer tasks partition their output into
        # num_tasks partitions and take the consumer's combiner
        # (map-side combining).
        dep_task_lists: List[Tuple[List[Task], object]] = []
        for dep_index, dep in enumerate(innermost.deps()):
            if dep.shuffle:
                dep_part = Partitioner(
                    num_partition=num_tasks,
                    partition_fn=dep.partitioner,
                    combiner=_frame_combiner(innermost, dep_index),
                )
            else:
                dep_part = Partitioner(num_partition=1)
            dep_task_lists.append((self.compile(dep.slice, dep_part), dep))

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

        tasks: List[Task] = []
        for shard in range(num_tasks):
            deps: List[TaskDep] = []
            for dep_tasks, dep in dep_task_lists:
                if dep.shuffle:
                    deps.append(TaskDep(tuple(dep_tasks), shard,
                                        expand=dep.expand))
                else:
                    # Aligned read: shard i reads dep shard i's partition 0.
                    deps.append(TaskDep((dep_tasks[shard],), 0))
            task = Task(
                name=TaskName(self.inv_index, op_name, shard, num_tasks),
                do=_make_do(chain, shard),
                deps=deps,
                partitioner=part,
                schema=slice_.schema,
            )
            # Structural metadata for the executor, which runs all shards
            # of a fused chain as one op group.
            task.chain = chain
            # Shuffle-plan stamps: the frozen knob, and why this
            # boundary can never spill (None: the port has no machine
            # combiner, the one ineligible case).
            task.shuffle_mode = self.shuffle_mode
            task.spill_ineligible = None
            task.group_key = (self.inv_index, op_name, self.serial, key)
            tasks.append(task)
        self._memo[key] = tasks
        return tasks


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


def _make_do(chain: Sequence[Slice], shard: int):
    """Compose the chain's readers into one task body. Re-entrant: each
    call builds fresh readers, so lost-task reruns are safe."""
    stages = list(reversed(chain))  # innermost first

    def do(dep_factories):
        reader = stages[0].reader(shard, dep_factories)
        for s in stages[1:]:
            r_prev = reader
            reader = s.reader(shard, [lambda r=r_prev: r])
        return reader

    return do


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
