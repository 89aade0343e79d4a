"""The device executor: op groups streamed through the device in waves.

Tasks of one compiled op (all shards of a fused chain) form a *group*;
the executor runs a group as one device program per *wave*. This
package drives one device slot (``nmesh == 1``), so a group of S shards
runs as S waves of one shard each — the JAX package's S > N wave
streaming with N = 1.

A wave program runs the chain's stages over the staged columns, with
row validity carried as a bool mask and one compaction at the end:

- ``map``, ``flatmap``, ``filter``, ``head``: the row-wise combinators,
  their functions under ``torch.func.vmap``;
- ``combine`` (a Reduce's reduce side): hash aggregation
  (``hashagg.make_hash_combine``, the ``hash_aggregate`` kernel) for
  combine fns that classify as add/max/min over non-float keys, else
  the sort + segmented scan (``segment.make_segmented_reduce_masked``);
- ``shuffle`` (the output partitioner): with a combiner, the fused hash
  combine + shuffle (``hashagg.make_hash_combine_shuffle``) or the fused
  sort combine + shuffle (``shuffle.make_combine_shuffle_fn``); without
  one (Reshuffle, Repartition), the sort shuffle
  (``shuffle.make_shuffle_fn``). Every hash-routed row goes through the
  ``hash_partition`` kernel. The S partitions ride one device as W = S
  subids of a leading int32 column, and the waves' outputs merge into
  one device-resident output; each consumer wave reads its own subid's
  rows (split once per output, ``_subid_wave_view``);
- ``join`` (a JoinAggregate, the one two-input stage): each input is
  its side's shuffled rows; the hash join
  (``hashagg.make_hash_join_align``: one claim cascade over both sides)
  when both sides' fns classify over non-float keys, else each side's
  segmented reduce and the tagged-sort alignment
  (``join.make_align``);
- ``groupby`` (a GroupByKey): the sort, each group's [capacity] window
  of values and its true count (``groupby.make_group_by_key_masked``).
  Vector columns ([n, capacity]) ride every later stage, the merge, the
  subid split and the readback like scalar ones.

A wave whose hash table could not place every row is rerun on the sort
path, and its op stays there (``hash_off``); a shuffle whose buckets
overflowed is rerun with four times the slack, up to the slack that
cannot overflow; a strict GroupByKey whose group exceeds its capacity
raises ``ValueError``. Outputs stay on the device; results are read
back per shard through the store bridge (``_BridgedStore``).

What the JAX package runs elsewhere raises here, naming the op
(``LoweringNotPorted``): host-tier functions and columns, the dense
join (``dense_keys=``), and operators that are not ported. No partial
result is returned.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import torch

from bigslice_tpu_torch.exec import store as store_mod
from bigslice_tpu_torch.exec.task import Task, TaskName, TaskState
from bigslice_tpu_torch.frame.frame import Frame
from bigslice_tpu_torch.ops.const import Const
from bigslice_tpu_torch.ops.groupby import GroupByKey
from bigslice_tpu_torch.ops.join import JoinAggregate
from bigslice_tpu_torch.ops.mapops import (Filter, Flatmap, Head, Map,
                                           extra_tensors)
from bigslice_tpu_torch.ops.reduce import LoweringNotPorted, Reduce
from bigslice_tpu_torch.ops.reshuffle import Reshuffle, RowPartitioner
from bigslice_tpu_torch.parallel import groupby as groupby_mod
from bigslice_tpu_torch.parallel import hashagg, segment
from bigslice_tpu_torch.parallel import join as join_mod
from bigslice_tpu_torch.parallel import shuffle as shuffle_mod
from bigslice_tpu_torch.parallel.jitutil import bucket_size
from bigslice_tpu_torch.parallel.segment import compact_by_mask, take
from bigslice_tpu_torch.slicetype import torch_dtype

__all__ = ["DeviceGroupOutput", "LoweringNotPorted", "MeshExecutor"]

#: The operators a task chain may hold on this executor.
_DEVICE_OPS = (Const, Map, Filter, Flatmap, Head, Reduce, Reshuffle,
               JoinAggregate, GroupByKey)


def _op_base(op: str) -> str:
    """Strip the compiler's #N repeated-invocation suffix: the sort-path
    fallback and slack adaptation describe the pipeline SITE (file:line
    op), which iterative programs re-invoke under suffixed names."""
    return op.split("#", 1)[0]


class DepLost(Exception):
    """A dependency's output is missing; its producers must re-run."""

    def __init__(self, *producers: Task):
        self.producers = producers
        super().__init__(
            "lost dependency output of " +
            ", ".join(str(p.name) for p in producers)
        )


class DeviceGroupOutput:
    """A group's output resident on the device: columns of
    ``nmesh * capacity`` rows (device d's rows at ``[d*capacity, ...)``,
    front-packed) plus int32 per-device valid counts. When
    ``partitioned``, device p holds partition p; a ``subid`` output
    (more partitions than devices) carries a leading int32 column: its
    partition p lives on device ``p % nmesh`` with subid
    ``p // nmesh``."""

    def __init__(self, cols, counts, capacity: int, schema,
                 partitioned: bool, subid: bool = False, nmesh: int = 1):
        self.cols = cols
        self.counts = counts
        self.capacity = capacity
        self.schema = schema
        self.partitioned = partitioned
        self.subid = subid
        self.nmesh = nmesh
        self._chunks = None
        self._chunks_lock = threading.Lock()
        # Per-consumer-wave views of a subid output (_subid_wave_view).
        self._wave_views = None
        self._views_lock = threading.Lock()

    def host_chunks(self) -> List[List[torch.Tensor]]:
        """Per column, per device, the valid rows on the host (memoized:
        every (task, partition) read would otherwise copy again)."""
        with self._chunks_lock:
            if self._chunks is None:
                counts = self.counts.cpu().tolist()
                cap = self.capacity
                self._chunks = [
                    [c[d * cap : d * cap + counts[d]].to("cpu", copy=True)
                     for d in range(self.nmesh)]
                    for c in self.cols
                ]
            return self._chunks


class WavedGroupOutput:
    """Per-wave outputs of an unpartitioned group with more shards than
    devices: shard s lives in wave s // nmesh at device s % nmesh."""

    def __init__(self, waves: List[DeviceGroupOutput], nmesh: int):
        self.waves = waves
        self.nmesh = nmesh


class _BridgedStore(store_mod.MemoryStore):
    """The frame store, extended to serve device-resident group outputs:
    a read that misses the frame tier materializes from the device."""

    def __init__(self, owner: "MeshExecutor"):
        super().__init__()
        self.owner = owner

    def read(self, name, partition):
        try:
            return super().read(name, partition)
        except store_mod.Missing:
            frames = self.owner._frames_by_name(name, partition)
            if frames is None:
                raise
            return iter(frames)

    def committed(self, name, partition):
        return (super().committed(name, partition)
                or self.owner._has_device_output(name))


class _GroupState:
    def __init__(self, num_shard: int):
        self.num_shard = num_shard
        self.tasks: Dict[int, Task] = {}


class MeshExecutor:
    """Runs op groups on one device. ``device`` defaults to ``cuda``:
    construction raises when there is no GPU, and otherwise builds the
    kernel library and runs its probe kernel (once per process).
    ``device="cpu"`` runs the same programs through the kernels' plain
    versions."""

    name = "mesh"

    def __init__(self, device=None):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "MeshExecutor: no CUDA device is available; pass "
                "device='cpu' to run on the CPU"
            )
        if device.type == "cuda":
            # Fail at construction, not mid-run: the kernel library must
            # build for this card and its probe kernel run right (once
            # per process).
            from bigslice_tpu_torch.parallel import cuda_kernels

            if not cuda_kernels.kernels_available():
                raise RuntimeError(
                    "MeshExecutor: the CUDA kernels are not available "
                    "(nvcc not found, or the probe kernel returned wrong "
                    "values)"
                )
        self.device = device
        # One device slot: a group of S shards streams as S waves.
        self.nmesh = 1
        self.store = _BridgedStore(self)
        self._lock = threading.Lock()
        # One wave program on the device at a time.
        self._wave_mutex = threading.RLock()
        self._groups: Dict[Tuple, _GroupState] = {}
        # Every group that has launched, by key: all its shards' tasks.
        self._members: Dict[Tuple, List[Task]] = {}
        self._outputs: Dict[Tuple, object] = {}
        self._task_index: Dict[TaskName, Tuple[Tuple, Task]] = {}
        # Ops whose hash table overflowed: back on the sort path for good,
        # which handles any key distribution.
        self._hash_off: set = set()
        # Per-op shuffle slack adapted by the overflow ladder.
        self._slack_memo: Dict[str, float] = {}

    # -- submission -------------------------------------------------------

    def submit(self, task: Task) -> None:
        try:
            self._check_lowering(task)
        except LoweringNotPorted as e:
            task.set_state(TaskState.ERR, e)
            return
        key = task.group_key
        with self._lock:
            members = self._members.get(key)
            if members is not None:
                # A resubmission (lost output) of a group that launched
                # before: the program spans every shard, so re-run the
                # whole group now and settle only this task.
                launch = (members, [task])
            else:
                g = self._groups.get(key)
                if g is None:
                    g = self._groups[key] = _GroupState(task.name.num_shard)
                g.tasks[task.name.shard] = task
                launch = None
                if len(g.tasks) == g.num_shard:
                    del self._groups[key]
                    members = [g.tasks[s] for s in range(g.num_shard)]
                    self._members[key] = members
                    launch = (members, members)
        if launch is not None:
            threading.Thread(target=self._run_group, args=(key, *launch),
                             daemon=True).start()

    def reader(self, task: Task, partition: int):
        return self.store.read(task.name, partition)

    def discard(self, task: Task) -> None:
        with self._lock:
            self._outputs.pop(task.group_key, None)
            self._task_index.pop(task.name, None)
        self.store.discard(task.name)

    def _check_lowering(self, task: Task) -> None:
        """Raise ``LoweringNotPorted`` naming the op when this package
        cannot run ``task`` on the device: an operator that is not
        ported, a host-tier function, host columns, or a join that
        declares ``dense_keys=``."""
        op = task.name.op
        if task.chain is None:
            raise LoweringNotPorted(f"{op}: task has no slice chain")
        for s in task.chain:
            name = type(s).__name__
            if not isinstance(s, _DEVICE_OPS):
                raise LoweringNotPorted(
                    f"{op}: operator {name} is not ported")
            fcs = ((s.frame_combiner,) if isinstance(s, Reduce)
                   else s.frame_combiners if isinstance(s, JoinAggregate)
                   else ())
            if getattr(s, "mode", "device") != "device" or not all(
                    fc.device for fc in fcs):
                raise LoweringNotPorted(
                    f"{op}: {name} runs a host-tier function: the host "
                    f"tier is not ported")
            if isinstance(s, JoinAggregate) and s.dense_keys is not None:
                raise LoweringNotPorted(
                    f"{op}: JoinAggregate declares dense_keys=: the dense "
                    f"join is not ported")
            if not all(ct.is_device for ct in s.schema):
                raise LoweringNotPorted(
                    f"{op}: host-tier columns: the host tier is not "
                    f"ported")
        if task.num_partition > 1:
            part = task.partitioner
            pf = part.partition_fn
            if pf is not None and not isinstance(pf, RowPartitioner):
                raise LoweringNotPorted(
                    f"{op}: a host-tier partitioner: the host tier is not "
                    f"ported")
            if part.combiner is not None and not part.combiner.device:
                raise LoweringNotPorted(
                    f"{op}: a host-tier combine fn: the host tier is not "
                    f"ported")

    # -- group orchestration ----------------------------------------------

    def _run_group(self, key, tasks: List[Task],
                   arrived: List[Task]) -> None:
        """Run the group of ``tasks`` (every shard) and settle the
        ``arrived`` ones, which this run claims."""
        claimed = [t for t in arrived
                   if t.transition_if(TaskState.WAITING, TaskState.RUNNING)]
        try:
            self._execute_group(key, tasks)
            with self._lock:
                for t in tasks:
                    self._task_index[t.name] = (key, t)
            for t in claimed:
                t.mark_ok()
        except DepLost as e:
            for p in e.producers:
                p.mark_lost(e)
            for t in claimed:
                t.mark_lost(e)
        except Exception as e:  # noqa: BLE001 — settles as the task's error
            for t in claimed:
                t.set_state(TaskState.ERR, e)

    def _execute_group(self, key, tasks: List[Task]) -> None:
        task0 = tasks[0]
        N = self.nmesh
        wave_tasks = [tasks[w * N : (w + 1) * N]
                      for w in range((len(tasks) + N - 1) // N)]
        if len(tasks) > N:
            # Wave streaming: ceil(S/N) waves of N shards. Partitioned
            # outputs merge across waves (wave contributions are just
            # more producers); unpartitioned ones keep per-wave shard
            # identity.
            outs = self._execute_waves(wave_tasks)
            if task0.num_partition > 1:
                out = self._merge_outputs(outs, task0)
            else:
                out = WavedGroupOutput(outs, N)
        else:
            out = self._execute_wave(tasks, 0)
        with self._lock:
            self._outputs[key] = out

    def _execute_waves(self, wave_tasks: List[List[Task]]
                       ) -> List[DeviceGroupOutput]:
        """Run a waved group serially, one wave after another."""
        return [self._execute_wave(wt, w) for w, wt in enumerate(wave_tasks)]

    def _execute_wave(self, tasks: List[Task], wave: int
                      ) -> DeviceGroupOutput:
        inputs = self._group_inputs(tasks, wave)
        with self._wave_mutex:
            return self._execute_wave_on(tasks, wave, inputs)

    def _execute_wave_on(self, tasks: List[Task], wave: int,
                         inputs) -> DeviceGroupOutput:
        task0 = tasks[0]
        opbase = _op_base(task0.name.op)
        stages = self._stages_for(task0)
        has_shuffle = any(kind == "shuffle" for kind, _ in stages)
        while True:
            slack = self._wave_slack(task0)
            out_counts, overflow, badrange, hashov, gbover, out_cols = \
                self._program(task0, stages, slack)(wave, inputs)
            overflow, badrange, hashov, gbover = torch.stack(
                [overflow, badrange, hashov, gbover]).tolist()
            if gbover > 0:
                # A strict GroupByKey's capacity overflow: a user error
                # on its own channel, never a slack or hash retry.
                raise ValueError(
                    f"groupbykey: group(s) exceed the declared capacity by "
                    f"up to {gbover} rows in group {task0.name.op} "
                    f"(on_overflow='error'); raise capacity or use Cogroup "
                    f"for discovered capacities")
            if badrange > 0:
                # A user error, not skew: no slack retry.
                raise ValueError(
                    f"partitioner returned ids outside "
                    f"[0, {task0.num_partition}) in group {task0.name.op}")
            if hashov > 0:
                # The hash table could not place every row: discard the
                # result and rerun the wave with this op on the sort path
                # for good.
                with self._lock:
                    self._hash_off.add(opbase)
                continue
            if not has_shuffle or overflow == 0:
                break
            # slack == ndest makes overflow impossible: a source sends at
            # most its capacity to one destination lane.
            full_slack = float(max(2, min(task0.num_partition, self.nmesh)))
            if slack >= full_slack:
                raise RuntimeError(
                    f"shuffle overflow in group {task0.name.op} even at "
                    f"full slack")
            self._slack_memo[opbase] = min(slack * 4, full_slack)
        return DeviceGroupOutput(
            list(out_cols), out_counts,
            int(out_cols[0].shape[0]) // self.nmesh, task0.schema,
            partitioned=task0.num_partition > 1,
            subid=has_shuffle and task0.num_partition > self.nmesh,
            nmesh=self.nmesh,
        )

    @property
    def hash_off(self) -> frozenset:
        """The op sites (``op@file:line``) whose hash table overflowed:
        they run on the sort path for the rest of this executor's life."""
        with self._lock:
            return frozenset(self._hash_off)

    def _wave_slack(self, task0: Task) -> float:
        """The shuffle's bucket slack for this op: the adapted value, or
        1.0 with a map-side combiner (combining bounds each destination's
        rows by the shard's distinct keys) and 2.0 without."""
        has_combiner = (task0.num_partition > 1
                        and task0.partitioner.combiner is not None)
        return self._slack_memo.get(_op_base(task0.name.op),
                                    1.0 if has_combiner else 2.0)

    def _hash_combine_ops(self, opbase: str, fc):
        """The classified ops when the hash lowering serves this combiner,
        None for the sort lowering: the combiner's own verdict
        (``FrameCombiner.hash_ops``) unless the op's table overflowed
        before."""
        if opbase in self._hash_off:
            return None
        return fc.hash_ops()

    def _hash_join_ops(self, opbase: str, s: JoinAggregate):
        """(ops_a, ops_b) when the sortless hash join serves this join
        stage, None for the sort path: one gate per side, the SAME gate
        as the combine and shuffle stages, so float keys and fns that do
        not classify take the sort path, as does a join whose claim
        cascade overflowed before."""
        ops_a = self._hash_combine_ops(opbase, s.frame_combiners[0])
        ops_b = self._hash_combine_ops(opbase, s.frame_combiners[1])
        if ops_a is None or ops_b is None:
            return None
        return ops_a, ops_b

    # -- the per-wave device program --------------------------------------

    @staticmethod
    def _stages_for(task: Task) -> List[tuple]:
        """Flatten the chain (innermost→outermost) + output partitioner
        into device stages (kind, slice or task). A Const contributes
        no stage (its shards are the staged input), nor does a Reshuffle
        (it reads its shuffled input as it is). A JoinAggregate, the
        innermost slice of its chain, is the first stage."""
        kinds = ((Map, "map"), (Flatmap, "flatmap"), (Filter, "filter"),
                 (Head, "head"), (Reduce, "combine"),
                 (JoinAggregate, "join"), (GroupByKey, "groupby"))
        stages: List[tuple] = []
        for s in reversed(task.chain):
            for cls, kind in kinds:
                if isinstance(s, cls):
                    stages.append((kind, s))
        if task.num_partition > 1:
            stages.append(("shuffle", task))
        return stages

    def _join_prelude(self, opbase: str, s: JoinAggregate, masks,
                      col_sets):
        """The two-input join stage: finish each side's keyed reduction
        (this wave holds every row of its keys, since both producers
        routed by the same hash) and keep the keys present in both.
        Classified fns over non-float keys take one shared claim cascade
        (``hashagg.make_hash_join_align``); others two segmented reduces
        and the tagged-sort alignment (``join.make_align``). Returns
        (mask, cols, hash overflow)."""
        fc_a, fc_b = s.frame_combiners
        nk = s.prefix
        cols_a, cols_b = col_sets
        jops = self._hash_join_ops(opbase, s)
        if jops is not None:
            align = hashagg.make_hash_join_align(nk, jops[0], jops[1])
            mask, cols, hov = align(masks[0], cols_a, masks[1], cols_b)
            return mask, cols, hov
        sides = []
        for fc, m, cols in ((fc_a, masks[0], cols_a),
                            (fc_b, masks[1], cols_b)):
            core = segment.make_segmented_reduce_masked(
                nk, fc.nvals, segment.canonical_combine(fc.fn, fc.nvals))
            sides.extend(core(m, tuple(cols[:nk]), tuple(cols[nk:])))
        mask, cols = join_mod.make_align(nk, fc_a.nvals, fc_b.nvals)(*sides)
        return mask, cols, torch.zeros((), dtype=torch.int32,
                                       device=self.device)

    def _program(self, task: Task, stages: List[tuple], slack: float):
        """The wave program: ``stepped(wave, inputs) -> (out_counts,
        overflow, badrange, hashov, gbover, cols)``. Validity rides as a
        bool mask between stages; one final compaction establishes the
        front-packed output contract. Subid-carrying inputs keep only
        this wave's rows; a join reads two inputs, every other chain
        one."""
        opbase = _op_base(task.name.op)
        nmesh = self.nmesh
        device = self.device
        vmap = torch.func.vmap

        def stepped(wave: int, inputs):
            masks, col_sets = [], []
            for cols, counts, has_subid in inputs:
                cols = list(cols)
                size = cols[0].shape[0]
                m = torch.arange(size, device=device) < counts[0]
                if has_subid:
                    m = m & (cols[0] == wave)
                    cols = cols[1:]  # strip the subid column
                masks.append(m)
                col_sets.append(cols)
            zero = torch.zeros((), dtype=torch.int32, device=device)
            # A strict GroupByKey's overflow rides a channel of its own
            # (gbover), as does the hash lowerings' (hashov).
            overflow = badrange = hashov = gbover = zero
            run_stages = stages
            if stages and stages[0][0] == "join":
                mask, cols, hashov = self._join_prelude(
                    opbase, stages[0][1], masks, col_sets)
                run_stages = stages[1:]
            else:
                mask, cols = masks[0], col_sets[0]
            for kind, s in run_stages:
                if kind == "map":
                    extras = extra_tensors(s.args, device)
                    out = vmap(s.fn, in_dims=(0,) * len(cols)
                               + (None,) * len(extras))(*cols, *extras)
                    cols = list(out) if isinstance(out, (tuple, list)) \
                        else [out]
                elif kind == "flatmap":
                    # Fixed fanout k: [n, k] planes (mask first) flatten
                    # row-major, each row's outputs contiguous.
                    outs = vmap(s.fn)(*cols)
                    mask = (mask[:, None] & outs[0]).reshape(-1)
                    cols = [o.reshape(-1).to(torch_dtype(ct.dtype))
                            for o, ct in zip(outs[1:], s.schema)]
                elif kind == "filter":
                    mask = mask & vmap(s.pred)(*cols)
                elif kind == "head":
                    # The first n valid rows of the shard, by running
                    # count.
                    rank = torch.cumsum(mask.to(torch.int32), 0,
                                        dtype=torch.int32)
                    mask = mask & (rank <= s.n)
                elif kind == "combine":
                    fc = s.frame_combiner
                    keys, vals = cols[: fc.nkeys], cols[fc.nkeys :]
                    hops = self._hash_combine_ops(opbase, fc)
                    if hops is not None:
                        core = hashagg.make_hash_combine(
                            fc.nkeys, fc.nvals, hops)
                        mask, keys, vals, hov = core(mask, tuple(keys),
                                                     tuple(vals))
                        hashov = hashov + hov
                    else:
                        core = segment.make_segmented_reduce_masked(
                            fc.nkeys, fc.nvals,
                            segment.canonical_combine(fc.fn, fc.nvals))
                        mask, keys, vals = core(mask, tuple(keys),
                                                tuple(vals))
                    cols = list(keys) + list(vals)
                elif kind == "groupby":
                    core = groupby_mod.make_group_by_key_masked(
                        s.prefix, s.capacity)
                    mask, keys, groups, counts = core(
                        mask, tuple(cols[: s.prefix]), cols[s.prefix])
                    if s.on_overflow == "error":
                        gbover = gbover + torch.where(
                            mask, torch.clamp(counts - s.capacity, min=0),
                            0).sum().to(torch.int32)
                    cols = list(keys) + [groups, counts]
                else:  # shuffle
                    part = s.partitioner
                    fc = part.combiner
                    pf = part.partition_fn
                    pfn = (pf.device_fn(s.num_partition)
                           if pf is not None else None)
                    hops = (self._hash_combine_ops(opbase, fc)
                            if fc is not None and pf is None else None)
                    if hops is not None:
                        # Fused hash combine + exchange of table regions.
                        body = hashagg.make_hash_combine_shuffle(
                            nmesh, fc.nkeys, fc.nvals, hops,
                            nparts=s.num_partition,
                        )
                        mask, hov, cols = body(mask, *cols)
                        hashov = hashov + hov
                    else:
                        if fc is not None:
                            # One sort serves the combine and the routing.
                            body = shuffle_mod.make_combine_shuffle_fn(
                                nmesh, fc.nkeys, fc.nvals,
                                segment.canonical_combine(fc.fn, fc.nvals),
                                slack=slack, nparts=s.num_partition,
                                partition_fn=pfn,
                            )
                        else:
                            body = shuffle_mod.make_shuffle_fn(
                                nmesh, s.schema.prefix, cols[0].shape[0],
                                slack=slack, nparts=s.num_partition,
                                partition_fn=pfn,
                            )
                        mask, ov, nb, cols = body(mask, *cols)
                        overflow = overflow + ov
                        badrange = badrange + nb
                    cols = list(cols)
            if all(kind == "map" for kind, _ in stages) and not any(
                    i[2] for i in inputs):
                # Map-only chain: the mask is untouched, counts carry over.
                return (inputs[0][1], overflow, badrange, hashov, gbover,
                        tuple(cols))
            out_n, cols = compact_by_mask(mask, cols)
            return out_n.reshape(1), overflow, badrange, hashov, gbover, cols

        return stepped

    # -- cross-wave merge and the consumer-side subid split ----------------

    def _merge_outputs(self, outs: List[DeviceGroupOutput],
                       task0: Task) -> DeviceGroupOutput:
        """Merge all waves' partitioned outputs into one (concat +
        recompact); consumers treat the merged rows as multiple producer
        contributions and re-combine them."""
        if len(outs) == 1:
            return outs[0]
        ncols = len(outs[0].cols)
        mask = torch.cat([
            torch.arange(o.capacity, device=self.device) < o.counts[0]
            for o in outs
        ])
        merged = [torch.cat([o.cols[j] for o in outs])
                  for j in range(ncols)]
        n, packed = compact_by_mask(mask, merged)
        return DeviceGroupOutput(
            list(packed), n.reshape(1), sum(o.capacity for o in outs),
            task0.schema, partitioned=True, subid=outs[0].subid,
            nmesh=self.nmesh,
        )

    def _subid_wave_view(self, out: DeviceGroupOutput, task0: Task,
                         wave: int) -> Optional[DeviceGroupOutput]:
        """Consumer wave ``wave``'s compacted view of a wave-partitioned
        output, built once per output for all W waves, so wave w
        processes only its own partition's rows."""
        W = (task0.name.num_shard + self.nmesh - 1) // self.nmesh
        if W <= 1 or out.cols is None:
            return None
        with out._views_lock:
            if out._wave_views is None or out._wave_views[0] != W:
                out._wave_views = (W, self._build_wave_views(out, W))
            views = out._wave_views[1]
        return views[wave] if wave < len(views) else None

    def _build_wave_views(self, out: DeviceGroupOutput,
                          W: int) -> List[DeviceGroupOutput]:
        valid = torch.arange(out.capacity, device=self.device) < out.counts[0]
        subid = out.cols[0]
        # The views' capacity is the observed largest subid: the counts
        # ARE the data, so no overflow ladder is needed.
        per = torch.bincount(subid[valid].to(torch.int64), minlength=W)
        capr = bucket_size(int(per.max()) if per.numel() else 1)
        views = []
        for w in range(W):
            idx = torch.nonzero(valid & (subid == w)).squeeze(1)
            k = idx.shape[0]
            cols_w = []
            for c in out.cols[1:]:
                buf = torch.zeros((capr,) + tuple(c.shape[1:]),
                                  dtype=c.dtype, device=self.device)
                buf[:k] = take(c, idx)
                cols_w.append(buf)
            views.append(DeviceGroupOutput(
                cols_w,
                torch.tensor([k], dtype=torch.int32, device=self.device),
                capr, out.schema, partitioned=True, subid=False,
                nmesh=self.nmesh,
            ))
        return views

    # -- staging ------------------------------------------------------------

    def _group_inputs(self, tasks: List[Task], wave: int = 0):
        """[(cols, counts, has_subid)] — one entry per dep, or one upload
        of the innermost source's shards."""
        task0 = tasks[0]
        if not task0.deps:
            shard_lists = [
                [f for f in t.chain[-1].reader(t.name.shard, []) if len(f)]
                for t in tasks
            ]
            return [self._upload(shard_lists, task0.chain[-1].schema)]
        return [self._dep_input(tasks, i, wave)
                for i in range(len(task0.deps))]

    def _dep_input(self, tasks: List[Task], dep_idx: int, wave: int = 0):
        """One dep's staged input: a device-resident producer output is
        chained zero-copy; a store-resident one is read and uploaded."""
        task0 = tasks[0]
        dep0 = task0.deps[dep_idx]
        with self._lock:
            out = self._outputs.get(dep0.tasks[0].group_key)
        if isinstance(out, WavedGroupOutput):
            if len(dep0.tasks) == 1:
                # Aligned dep on a waved producer: consumer wave w
                # aligns with producer wave w.
                wout = out.waves[wave]
                return wout.cols, wout.counts, False
            out = None
        if out is not None and out.partitioned:
            # Device-resident shuffle output: partition p on device
            # p % nmesh. A waved consumer reads its subid's view.
            if out.subid and task0.name.num_shard > self.nmesh:
                view = self._subid_wave_view(out, task0, wave)
                if view is not None:
                    return view.cols, view.counts, False
            return out.cols, out.counts, out.subid
        if out is not None and len(dep0.tasks) == 1:
            return out.cols, out.counts, False
        # Store-resident dep: read each shard's frames and upload.
        per_shard = []
        for t in tasks:
            dep = t.deps[dep_idx]
            frames = []
            for p in dep.tasks:
                try:
                    frames.extend(self.store.read(p.name, dep.partition))
                except store_mod.Missing as e:
                    raise DepLost(p) from e
            per_shard.append(frames)
        return self._upload(per_shard, dep0.tasks[0].schema)

    def _upload(self, shard_lists, schema):
        """Stage per-shard frame lists onto the device: (cols, counts,
        False), each shard padded to a power-of-two capacity."""
        frames = [Frame.concat(fl) if fl else None for fl in shard_lists]
        while len(frames) < self.nmesh:
            frames.append(None)
        counts = [len(f) if f is not None else 0 for f in frames]
        capacity = bucket_size(max(counts + [1]))
        cols = []
        for j, ct in enumerate(schema):
            buf = torch.zeros((self.nmesh * capacity,) + ct.shape,
                              dtype=torch_dtype(ct.dtype), device=self.device)
            for d, f in enumerate(frames):
                if f is not None:
                    start = d * capacity
                    buf[start : start + counts[d]] = f.cols[j].to(self.device)
            cols.append(buf)
        counts_t = torch.tensor(counts, dtype=torch.int32, device=self.device)
        return cols, counts_t, False

    # -- frame materialization for result reads ------------------------------

    def _has_device_output(self, name: TaskName) -> bool:
        with self._lock:
            return name in self._task_index

    def _frames_by_name(self, name: TaskName,
                        partition: int) -> Optional[List[Frame]]:
        with self._lock:
            entry = self._task_index.get(name)
            if entry is None:
                return None
            key, task = entry
            out = self._outputs.get(key)
        if out is None:
            return None
        shard = task.name.shard
        if isinstance(out, WavedGroupOutput):
            if partition != 0:
                return []
            chunks = out.waves[shard // out.nmesh].host_chunks()
            cols = [c[shard % out.nmesh] for c in chunks]
        else:
            chunks = out.host_chunks()
            if out.partitioned:
                # Device p holds partition p merged over every producer
                # shard: attribute it all to producer shard 0.
                if shard != 0:
                    return []
                cols = shuffle_mod.partition_cols(chunks, partition,
                                                  out.nmesh, out.subid)
            else:
                if partition != 0:
                    return []
                cols = [c[shard] for c in chunks]
        if not len(cols[0]):
            return []
        return [Frame(cols, task.schema)]
