"""The device executor: op groups streamed through the device in waves.

Tasks of one compiled op (all shards of a fused chain) form a *group*;
the executor runs a group as one device program per *wave*, over the N
slots of its mesh (``parallel/meshutil.py``): one slot on one card, or
one ``torch.distributed`` rank a slot, every rank running the same
driver. A group of S shards runs ceil(S / N) waves; shard s runs on slot
``s % N`` in wave ``s // N``, and each rank stages, computes and holds
its own slot's rows only (the JAX package's S > N wave streaming).

Across ranks the executor keeps the JAX package's SPMD contract
(reference exec/spmd.py): one dispatcher thread launches device groups
in the session's plan order (``plan_groups``), every decision that
chooses the next collective comes from a value gathered over the mesh
(each wave's overflow, badrange, hash-overflow and group-by signals and
its output rows, the dense bound probe, a merge's and a Cogroup's
capacity), and the outputs a host reads are gathered to every rank in
launch order (``plan_gather``, ``DeviceGroupOutput.gather``). A
host-tier task runs once, on its owner rank, and the other ranks fetch
its outputs when they read them (``exec/hostdist.py``; machine-combined
groups run on every rank). With one slot none of it issues a
collective.

A wave program runs the chain's stages over the staged columns, with
row validity carried as a bool mask and one compaction at the end:

- ``map``, ``flatmap``, ``filter``, ``head``: the row-wise combinators,
  their functions under ``torch.func.vmap``;
- ``combine`` (a Reduce's reduce side): with a dense bound (declared
  ``dense_keys=``, or discovered), a [K] table of accumulators
  (``dense.make_dense_combine``); else hash aggregation
  (``hashagg.make_hash_combine``, the ``hash_aggregate`` kernel) for
  combine fns that classify as add/max/min over non-float keys, else
  the sort + segmented scan (``segment.make_segmented_reduce_masked``);
- ``shuffle`` (the output partitioner): with a combiner, the fused hash
  combine + shuffle (``hashagg.make_hash_combine_shuffle``) or the fused
  sort combine + shuffle (``shuffle.make_combine_shuffle_fn``); without
  one (Reshuffle, Repartition), the sort shuffle
  (``shuffle.make_shuffle_fn``). A dense bound takes precedence over the
  hash lowering: with one partition a device it is the fused dense
  combine-shuffle (``dense.make_dense_combine_shuffle``), else the sort.
  Every hash-routed row goes through the ``hash_partition`` kernel. The
  S partitions ride one device as W = S subids of a leading int32
  column, and the waves' outputs merge into one device-resident output;
  each consumer wave reads its own subid's rows (split once per output,
  ``_subid_wave_view``);
- ``join`` (a JoinAggregate, the one two-input stage): each input is
  its side's shuffled rows; the hash join
  (``hashagg.make_hash_join_align``: one claim cascade over both sides)
  when both sides' fns classify over non-float keys, else each side's
  segmented reduce and the tagged-sort alignment
  (``join.make_align``); a dense-declared join of one shard a device
  takes a rank-indexed table a side (``dense.make_dense_join``);
- ``groupby`` (a GroupByKey): the sort, each group's [capacity] window
  of values and its true count (``groupby.make_group_by_key_masked``).
  Vector columns ([n, capacity]) ride every later stage, the merge, the
  subid split and the readback like scalar ones;
- ``fold`` (a device-tier Fold): the stable sort by key and the
  sequential fold of each key's rows in arrival order, one step a rank
  of every group at once (``segment.make_sequential_fold_masked``), so
  as many steps as the wave's longest group, or with a dense bound and
  an add/max/min fn one [K] table (``dense.make_dense_fold``); a Fold's
  input shuffle has no map-side combine;
- ``cogroup`` (a Cogroup, the only stage of its chain): one tagged sort
  over the union of its N inputs' shuffled rows and a rank-scatter into
  per-input [keys, G] matrices with exact counts
  (``cogroup.make_cogroup_align``); the readback decodes them into the
  contract's object lists (``cogroup.ragged_from_padded``);
- ``attend`` (a SelfAttend, the innermost slice of its chain, over a
  group of no more shards than device slots): Ulysses
  (``ulysses.masked_local_body``) when heads divide the slots, heads >
  1 and no ``block_q`` is set (or ``method="ulysses"``), else the ring
  (``ringattention.masked_local_body``), over the producer's
  unpartitioned device output read zero-copy; the choice lands in
  ``attend_methods``. A producer without such an output (it ran on the
  host tier) sends the group to the host tier's broadcast reader
  (``_AttendHostFallback``).

A wave's output is front-packed into ``bucket_size`` of its surviving
rows, never the size of the table or buffer they came from.

A wave whose hash table could not place every row is rerun on the sort
path, and its op stays there (``hash_off``); a shuffle whose buckets
overflowed is rerun with four times the slack, up to the slack that
cannot overflow; a strict GroupByKey whose group exceeds its capacity
raises ``ValueError``. A Cogroup needs no retry: each wave scatters at
``bucket_size`` of its own largest group, counted first, and its op
records the widest (``cogroup_caps``). Outputs stay on the device;
results are read back per shard through the store bridge
(``_BridgedStore``).

Waves stream through a pipeline (``_execute_waves``): wave 0 stages on
the group's thread; a prefetcher thread stages waves 1..n-1
(``prefetch_depth`` ahead) while earlier waves compute, and on ``cuda``
up to ``prefetch_depth`` dispatched waves stay in flight before their
signals are read back (``_dispatch_wave``/``_settle_wave``). Staging
assembles each column once into a host buffer from the arena
(``exec/staging.py``: pinned and recycled on ``cuda``) and copies it to
the card with ``non_blocking`` copies on the executor's copy stream; the
wave program's stream waits on the event recorded behind them. A wave
whose estimated working set exceeds ``device_budget_bytes`` runs as K
exact row slices (``_try_execute_wave_split``); with a map-side
combiner the wave's running merge joins each next slice's rows ahead
of its combine, so it holds one row a key. Under
``BIGSLICE_SHUFFLE=spill`` (or ``auto`` over the spill budget) a shuffle
boundary's map waves write their partitions through a ``FileStore``
instead of merging on the device (``exec/shuffleplan.py``), and
consumers stream them back through the arena.

Auto-dense discovery (``auto_dense``, on by default as in the JAX
package): a Reduce or Fold over one int32 key whose fn classifies, and
whose first wave's keys (one ``torch.aminmax`` over the staged key
column and one readback, ``_key_range``) are non-negative with
``kmax + 1 <= MAX_DENSE_KEYS`` and at most twice the wave's capacity,
is declared dense at that bound. A key outside a declared bound counts
into the badrange signal: from a discovered bound it retracts the
declaration, puts the site in ``auto_dense_off`` and reruns the whole
group on the range-agnostic lowerings; from a user's bound it raises
``ValueError``.

What the device path cannot lower runs on the host tier, an inner
``LocalExecutor`` over the same store and device (``_eligible``,
``local``): host-tier functions (a Fold's included), host columns and
keys, frame-level partitioners, a Cogroup fused with other stages,
feeding a shuffle, over host or vector inputs or machine-combined, and
the operators only the local executor runs (``Scan``, ``MapBatches``,
the sources). Host consumers read device outputs through the store
bridge; device consumers stage host outputs through the arena.

The robustness plane is the JAX package's: the chaos seams
``mesh.dispatch`` (each group dispatch), ``staging.assemble`` and
``shuffle.upload`` (each staged wave, retried with ``fileio``'s bounded
backoff over the same host data); an *infra* failure (a CUDA
out-of-memory error, or the injected ``InjectedInfraError``) puts the
op on probation for ``PROBATION_SECS`` and marks its tasks LOST, so the
evaluator resubmits them to the host tier, while a sticky CUDA error
(an illegal address, a launch failure, a device-side assert) is the
task's fatal error; cancellation is checked before a group dispatches
and between its waves, never inside a launch; with an adaptive planner
(``BIGSLICE_ADAPTIVE``) the skew policy splits a flagged consumer wave
into row slices and the cost policy sets the wave budget from the
card's memory.

The program cache (``serve/programcache.py``): with a telemetry hub,
each wave program is looked up in the executor's session-local table
by its stage functions' ids (weakref-guarded), and its first call at
each argument signature probes the process-wide tier under a content
digest (``_served_program``): a hit there is a program some earlier
Session of the process built. A program is rebuilt on every call all
the same: nothing is compiled, so the table and the tier hold its
identity and accounting.
"""

from __future__ import annotations

import contextlib
import os
import queue as queue_mod
import shutil
import tempfile
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from bigslice_tpu_torch.exec import shuffleplan
from bigslice_tpu_torch.exec import staging
from bigslice_tpu_torch.exec.evaluate import (PHASE_WAVE_COMPUTE,
                                              PHASE_WAVE_PREFETCH,
                                              notify_phase)
from bigslice_tpu_torch.exec import store as store_mod
from bigslice_tpu_torch.exec.local import LocalExecutor
from bigslice_tpu_torch.exec.task import (Task, TaskCancelled, TaskName,
                                          TaskState)
from bigslice_tpu_torch.frame import codec as codec_mod
from bigslice_tpu_torch.frame.frame import Frame
from bigslice_tpu_torch.ops.attention import SelfAttend
from bigslice_tpu_torch.ops.cogroup import Cogroup
from bigslice_tpu_torch.ops.const import Const
from bigslice_tpu_torch.ops.fold import Fold
from bigslice_tpu_torch.ops.groupby import GroupByKey
from bigslice_tpu_torch.ops.join import JoinAggregate
from bigslice_tpu_torch.ops.mapops import (Filter, Flatmap, Head, Map,
                                           _PrefixedSlice)
from bigslice_tpu_torch.ops.reduce import Reduce
from bigslice_tpu_torch.ops.reshuffle import (Reshard, Reshuffle,
                                              RowPartitioner)
from bigslice_tpu_torch.parallel import cogroup as cogroup_mod
from bigslice_tpu_torch.parallel import cuda_kernels
from bigslice_tpu_torch.parallel import dense as dense_mod
from bigslice_tpu_torch.parallel import groupby as groupby_mod
from bigslice_tpu_torch.parallel import hashagg, segment
from bigslice_tpu_torch.parallel import join as join_mod
from bigslice_tpu_torch.parallel import meshutil
from bigslice_tpu_torch.parallel import ringattention
from bigslice_tpu_torch.parallel import shuffle as shuffle_mod
from bigslice_tpu_torch.parallel import ulysses
from bigslice_tpu_torch.parallel.jitutil import bucket_size
from bigslice_tpu_torch.parallel.segment import compact_to_bucket, take
from bigslice_tpu_torch.slicetype import torch_dtype
from bigslice_tpu_torch.utils import devicetelemetry, faultinject, fileio

__all__ = ["COGROUP_DEFAULT_CAP", "DeviceGroupOutput", "HostLostError",
           "MeshExecutor", "PROBATION_SECS"]

#: The least group capacity a Cogroup op records (the JAX package's
#: starting capacity, which its ladder grows).
COGROUP_DEFAULT_CAP = 8

#: Up to this many subids a device, a shuffle's per-partition counts are
#: one masked count each (a scatter-add over few bins serializes on its
#: atomics).
_FEW_SUBIDS = 32


class _AttendHostFallback(Exception):
    """A SelfAttend group's dep has no unpartitioned device-resident
    output for the attend stage to read (its producer ran on the host
    tier): the group runs on the host tier, whose broadcast reader has
    the same global semantics."""


class HostLostError(RuntimeError):
    """A host of the device plane was lost: a peer rank died or stopped
    beating mid-gang, or the chaos plane's ``hostloss`` kind; or, over
    ranks, this rank fell out of step with its peers (a device group or
    a gather failed here). Raised by name: this package has no elastic
    mesh recovery, so it is the task's fatal error; the recovery is to
    restart the driver on every rank."""


class UngatheredOutputError(RuntimeError):
    """A host read reached a device output of a multi-rank mesh that the
    plan kept on the devices (reference exec/meshexec.py:113-119): the
    gather is a collective, which must not run lazily from a reader
    thread. The store bridge turns it into ``Missing``."""


# What a collective raises when a peer is gone, by runtime marker (a
# user error that merely mentions a peer must not match).
_DIST_ERR_MARKERS = (
    "connection closed by peer", "connection reset by peer",
    "gloo alltoall failed", "gloo allgather failed",
    "gloo allreduce failed", "gloo all-reduce failed",
    "gloo all-gather failed", "socket timeout", "nccl communicator was "
    "aborted", "ncclremoteerror",
)


def _looks_like_host_loss(e: BaseException) -> bool:
    """A lost peer: the keepalive's ``PeerLostError`` anywhere in the
    chain, or a collective's peer-loss marker."""
    from bigslice_tpu_torch.utils.distributed import PeerLostError

    for err in _exception_chain(e):
        if isinstance(err, (PeerLostError, HostLostError)):
            return True
        text = repr(err).lower()
        if any(m in text for m in _DIST_ERR_MARKERS):
            return True
    return False


#: How long an op whose device path failed with an infra error runs on
#: the host tier before the device path is tried again (reference
#: exec/meshexec.py:188).
PROBATION_SECS = 30.0

# The runtime's error types that are infra, matched by class name along
# the MRO: torch.cuda.OutOfMemoryError (torch.OutOfMemoryError in newer
# releases) — the allocator could not serve a request, and the context
# stays usable.
_INFRA_ERROR_TYPE_NAMES = frozenset({"OutOfMemoryError"})

# What torch prints for the same class, for errors that reach us as
# strings ("CUDA out of memory. Tried to allocate ...", "CUDA error: out
# of memory"), and the injected marker.
_INFRA_ERR_MARKERS = (
    "resource_exhausted", "cuda out of memory", "cuda error: out of memory",
)

# Sticky CUDA errors poison the context for the rest of the process: the
# host tier runs on the same card and would fail again, so these are
# never infra, whatever else the chain says.
_STICKY_ERR_MARKERS = (
    "illegal memory access", "an illegal instruction",
    "unspecified launch failure", "device-side assert",
    "misaligned address", "cudaerrorlaunchfailure",
    "cudaerrorillegaladdress", "uncorrectable ecc",
    "hardware stack error", "unknown error",
)


def _exception_chain(e: BaseException, contexts: bool = True):
    """The failure chain, cycle-safe: explicit causes, a TaskError's
    ``cause``, and (by default) implicit ``__context__`` links."""
    seen = set()
    stack = [e]
    while stack:
        err = stack.pop()
        if err is None or id(err) in seen:
            continue
        seen.add(id(err))
        yield err
        cause = getattr(err, "cause", None)
        if isinstance(cause, BaseException):
            stack.append(cause)
        stack.append(err.__cause__)
        if contexts:
            stack.append(err.__context__)


def _is_infra_error_type(err: BaseException) -> bool:
    return any(c.__name__ in _INFRA_ERROR_TYPE_NAMES
               for c in type(err).__mro__)


def _looks_like_infra_error(e: BaseException) -> bool:
    """Is the failure of the infra class (reference exec/meshexec.py:
    228-264): retryable on the host tier, unlike a user error, which
    fails the same everywhere? A sticky CUDA error anywhere in the chain
    says no; then the type (an out-of-memory error anywhere in the
    chain), then torch's and the injection's markers. Implicit contexts
    are not followed: an infra error that was handled hangs off the
    ``__context__`` of whatever the handler raised next."""
    chain = list(_exception_chain(e, contexts=False))
    if any(m in repr(err).lower() for err in chain
           for m in _STICKY_ERR_MARKERS):
        return False
    if any(_is_infra_error_type(err) for err in chain):
        return True
    return any(m in repr(err).lower() for err in chain
               for m in _INFRA_ERR_MARKERS)


#: Entries of an executor's session-local program table (reference
#: exec/meshexec.py:101).
_PROGRAM_CACHE_MAX = 64


class _ProgramEntry:
    """One session-local program table entry: the program's cross-session
    digest (None: never shared), its repr-stable spec, the seconds its
    first ``_program`` took, and the argument signatures its calls have
    had in this executor (each probes the process-wide tier once)."""

    __slots__ = ("serve_key", "spec", "build_s", "sigs")

    def __init__(self, serve_key, spec, build_s: float):
        self.serve_key = serve_key
        self.spec = spec
        self.build_s = build_s
        self.sigs: set = set()


def _device_key(device: torch.device) -> Tuple[str, Optional[int]]:
    """A device with its index made explicit (``cuda`` is the current
    card's), so that ``cuda`` and ``cuda:0`` compare equal."""
    if device.type == "cuda" and device.index is None:
        return "cuda", torch.cuda.current_device()
    return device.type, device.index


def _op_base(op: str) -> str:
    """Strip the compiler's #N repeated-invocation suffix: the sort-path
    fallback and slack adaptation describe the pipeline SITE (file:line
    op), which iterative programs re-invoke under suffixed names."""
    return op.split("#", 1)[0]


def _dtype_name(dtype) -> str:
    """A column dtype's numpy name ("int32"), as the JAX package names
    the kernel selector's sites."""
    try:
        return str(np.dtype(dtype))
    except TypeError:
        return str(dtype)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _wide_row_bytes(values) -> int:
    """Bytes a row of the value columns (``ColType``s) that K2's wide
    route scatters after the kernel (``cuda_kernels.aggregate_routes``);
    0 when the kernel holds them all."""
    shapes = [tuple(ct.shape) for ct in values]
    _, wide = cuda_kernels.aggregate_routes(
        shapes, [torch_dtype(ct.dtype) for ct in values])
    return sum(np.dtype(values[i].dtype).itemsize
               * cuda_kernels.value_lanes(shapes[i]) for i in wide)


def _output_bytes(out) -> int:
    """Device bytes a group output holds (tensor metadata, no sync)."""
    if isinstance(out, WavedGroupOutput):
        return sum(_output_bytes(w) for w in out.waves)
    cols = getattr(out, "cols", None)
    if not cols:
        return 0
    return sum(_nbytes(c) for c in cols) + _nbytes(out.counts)


def _donate(inputs, out: "DeviceGroupOutput") -> Tuple[int, int, int, int]:
    """Torch's counterpart of buffer donation: free the storage of every
    tensor a settled wave owned (staged for it alone), so that the
    caching allocator hands the blocks to the next wave's staging at
    once, whatever Python references remain. A storage the output still
    uses (a map-only chain passes its input counts through) is kept; a
    producer output chained zero-copy is never owned, so never freed.
    Returns the bytes and storages owned (offered), then the bytes and
    storages freed (the honored subset, as XLA's aliased buffers are of
    the donated ones)."""
    keep = {t.untyped_storage().data_ptr()
            for t in list(out.cols) + [out.counts]}
    owned, freed = {}, {}
    for i in inputs:
        if not i.owned:
            continue
        for t in list(i.cols) + [i.counts]:
            st = t.untyped_storage()
            ptr = st.data_ptr()
            if ptr in owned:
                continue
            owned[ptr] = st.nbytes()
            if ptr not in keep:
                freed[ptr] = owned[ptr]
                st.resize_(0)
    return (sum(owned.values()), len(owned), sum(freed.values()),
            len(freed))


class _AutoDenseRetry(Exception):
    """A discovered dense-key bound was proven wrong by a later wave's
    badrange signal: the declaration was retracted and the whole group
    must rerun on the range-agnostic lowerings (``_execute_group``)."""


class DepLost(Exception):
    """A dependency's output is missing; its producers must re-run."""

    def __init__(self, *producers: Task):
        self.producers = producers
        super().__init__(
            "lost dependency output of " +
            ", ".join(str(p.name) for p in producers)
        )


class DeviceGroupOutput:
    """A group's output resident on this rank's device: its slot's
    columns of ``capacity`` rows (front-packed; the capacity is the same
    on every rank) plus an int32[1] valid count. When ``partitioned``,
    slot p holds partition p; a ``subid`` output (more partitions than
    slots) carries a leading int32 column: its partition p lives on slot
    ``p % nmesh`` with subid ``p // nmesh``."""

    def __init__(self, cols, counts, capacity: int, schema,
                 partitioned: bool, subid: bool = False, nmesh: int = 1):
        self.cols = cols
        self.counts = counts
        self.capacity = capacity
        self.schema = schema
        self.partitioned = partitioned
        self.subid = subid
        self.nmesh = nmesh
        # Rows of each partition, as host ints, when the telemetry hub
        # asked the program for them (read with the wave's signals).
        self.part_rows: Optional[List[int]] = None
        self._chunks = None
        self._chunks_lock = threading.Lock()
        # Per-consumer-wave views of a subid output (_subid_wave_view).
        self._wave_views = None
        self._views_lock = threading.Lock()

    def _local_chunk(self) -> List[torch.Tensor]:
        """Per column, this slot's valid rows on the host."""
        n = int(self.counts[0])
        return [c[:n].to("cpu", copy=True) for c in self.cols]

    def gather(self, mesh: meshutil.Mesh) -> None:
        """Every slot's valid rows to this rank's host (a collective:
        the dispatcher calls it in launch order on every rank, never a
        reader thread; reference exec/meshexec.py:301-324)."""
        with self._chunks_lock:
            if self._chunks is None and self.cols is not None:
                every = mesh.all_gather_object(self._local_chunk())
                self._chunks = [[every[d][j] for d in range(self.nmesh)]
                                for j in range(len(self.cols))]

    @property
    def gathered(self) -> bool:
        """Host-readable without a collective: one slot, or gathered."""
        return self.nmesh == 1 or self._chunks is not None

    def host_chunks(self) -> List[List[torch.Tensor]]:
        """Per column, per slot, the valid rows on the host (memoized:
        every (task, partition) read would otherwise copy again). On a
        mesh of ranks only after ``gather``."""
        with self._chunks_lock:
            if self._chunks is None:
                if self.nmesh > 1:
                    raise UngatheredOutputError(
                        "device group output is resident on the ranks' "
                        "devices by plan; a host read would need an "
                        "unplanned collective gather")
                self._chunks = [[c] for c in self._local_chunk()]
            return self._chunks

    def drop_device(self) -> None:
        """Keep the rows on the host only: materialize the host chunks,
        then drop the device tensors (the spill plan's result plane)."""
        self.host_chunks()
        self.cols = None
        self.counts = None
        with self._views_lock:
            self._wave_views = None

    def release(self) -> None:
        """Forget the rows on the device AND the host (a spilled wave:
        they live in the spill store alone)."""
        self.cols = None
        self.counts = None
        with self._chunks_lock:
            self._chunks = None
        with self._views_lock:
            self._wave_views = None


class StagedInput(NamedTuple):
    """One dep's input to a wave program. ``owned``: staged by this
    executor for this wave alone (donated at settle), as opposed to a
    producer output chained zero-copy, which is never owned. ``ready``:
    the CUDA event behind its copies on the copy stream, which the wave
    program's stream waits on (None when nothing is in flight).
    ``subid``: a wave-partitioned output read whole (the subid split
    off): its leading int32 column names each row's partition, and the
    program keeps the rows of its own wave."""

    cols: List[torch.Tensor]
    counts: torch.Tensor
    capacity: int
    owned: bool
    ready: Optional[object]
    subid: bool = False


class _WaveEntry:
    """A dispatched wave awaiting settle: its inputs (kept alive until
    settle, for a rerun) and the program's unsynced results, or the
    output of a wave settled at dispatch (a budget split)."""

    __slots__ = ("tasks", "wave", "inputs", "first", "done")

    def __init__(self, tasks, wave, inputs, first=None, done=None):
        self.tasks = tasks
        self.wave = wave
        self.inputs = inputs
        self.first = first
        self.done = done


class WavedGroupOutput:
    """Per-wave outputs of an unpartitioned group with more shards than
    devices: shard s lives in wave s // nmesh at device s % nmesh."""

    def __init__(self, waves: List[DeviceGroupOutput], nmesh: int):
        self.waves = waves
        self.nmesh = nmesh

    def gather(self, mesh: meshutil.Mesh) -> None:
        for w in self.waves:
            w.gather(mesh)

    @property
    def gathered(self) -> bool:
        return all(w.gathered for w in self.waves)


class _GatherEntry:
    """A late-gather debt in the dispatch plan (reference
    exec/meshexec.py:443-455): an output that ran before, still on the
    devices, which a newly planned run reads on the host. Its collective
    runs on the dispatcher, in plan order."""

    __slots__ = ("key",)

    def __init__(self, key):
        self.key = key


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
            try:
                frames = self.owner._frames_by_name(name, partition)
            except UngatheredOutputError as e:
                err = self.owner._gang_error
                if err is not None:
                    # A gather failed on this rank: fatal, not Missing.
                    raise HostLostError(str(err)) from err
                # Read outside the planned gathers: the retriable store
                # contract, not a sticky error.
                raise store_mod.Missing(f"{name} p{partition}") from e
            if frames is None:
                # A host task another rank owns (exec/hostdist.py):
                # fetched through the store, then held here.
                hd = self.owner._hostdist
                if hd is not None:
                    fetched = hd.fetch(name, partition)
                    if fetched is not None:
                        super().put(name, partition, fetched)
                        return super().read(name, partition)
                    why = hd.miss_reason.get((str(name), partition))
                    if why is not None:
                        raise store_mod.Missing(
                            f"{name} p{partition}: fetched from its owner: "
                            f"{why}")
                raise
            return iter(frames)

    def committed(self, name, partition):
        return (super().committed(name, partition)
                or self.owner._has_device_output(name))


class _GroupState:
    def __init__(self, num_shard: int):
        self.num_shard = num_shard
        self.tasks: Dict[int, Task] = {}
        self.launched = False


class MeshExecutor:
    """Runs op groups on one device. ``device`` defaults to ``cuda``:
    construction raises when there is no GPU, and otherwise builds the
    kernel library, runs its probe kernel (once per process) and creates
    the copy stream staging uses. ``device="cpu"`` runs the same
    programs through the kernels' plain versions.

    The wave pipeline's knobs are the JAX package's, each with its
    environment name:

    - ``prefetch_depth`` (``BIGSLICE_PREFETCH_DEPTH``, default 1): waves
      staged ahead by the prefetcher thread, and on ``cuda`` waves left
      in flight before their signals are read; 0 is the serial loop.
    - ``donate_buffers`` (``BIGSLICE_DONATE_BUFFERS``, default on): the
      storage of a wave's owned staged inputs is freed at its settle
      (``_donate``), so that the caching allocator reuses the blocks for
      the next wave; off leaves them to Python's references.
    - ``device_budget_bytes`` (``BIGSLICE_DEVICE_BUDGET_BYTES``, default
      none): a wave whose estimated working set exceeds it runs as K row
      slices, the prefetch depth shrinks so that (1 + depth) waves fit
      it, and the subid split builds one consumer wave's view at a time
      when all W views would not fit it.
    - ``staging_arena`` (``BIGSLICE_STAGING_ARENA``, default on): the
      host arena and one assembled copy per column; off is the
      per-shard upload.

    None of them chooses between a kernel and its plain version: the
    device alone does that.

    Two lowering switches, also the JAX package's: ``hash_aggregate``
    (default on) lets add/max/min combines
    and joins over non-float keys take the hash lowering (the
    ``hash_aggregate`` kernel); off pins them to the sort path.
    ``subid_split`` (default on) splits a
    wave-partitioned output once into each consumer wave's rows; off
    hands each consumer wave the whole output, which its program masks
    by subid.

    ``auto_dense`` (default on, the JAX package's default) lets a
    group's first wave declare a dense key bound (the module's
    docstring); off pins the hash and sort lowerings. ``fallback_procs``
    bounds the task threads of the host tier, ``local``: a
    ``LocalExecutor`` on this executor's store and device.

    ``mesh`` (``parallel/meshutil.Mesh``, default the one-slot mesh of
    ``device``): with ``utils.distributed.global_mesh()``, one slot a
    rank, ``nmesh`` the world size and the device the mesh's. Over more
    than one rank the dispatch is ordered (``ordered_dispatch``: one
    dispatcher thread launches groups in the session's plan order;
    reference exec/meshexec.py:548, :770), the keepalive is checked
    before every group, any failure of a device group or of a gather is
    fatal on this rank (``HostLostError``: its peers cannot follow a
    decision only this rank made; restart the program on every rank,
    or give an elastic session a coordinated ``mesh_provider``), the subid
    split, kernel selection's measured probe and the adaptive planner's
    measured budgets stay off (each would decide differently on each
    rank), host-tier tasks run once on their owner rank
    (``exec/hostdist.py``), and a spilled boundary gathers each map wave
    so that every rank spills every partition. A 2-D mesh
    (``Mesh(shape=(D, I))``) routes every shuffle through the two-stage
    exchange (``parallel/hier.py``). ``resize`` moves the executor onto
    another mesh between runs (elastic sessions)."""

    name = "mesh"

    def __init__(self, device=None, prefetch_depth: Optional[int] = None,
                 donate_buffers: Optional[bool] = None,
                 device_budget_bytes: Optional[int] = None,
                 staging_arena: Optional[bool] = None,
                 fallback_procs: Optional[int] = None,
                 auto_dense: bool = True,
                 hash_aggregate: bool = True,
                 subid_split: bool = True,
                 mesh: Optional[meshutil.Mesh] = None):
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(
                    f"MeshExecutor: device {device} is not the mesh's "
                    f"{mesh.device}")
            device = mesh.device
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "MeshExecutor: no CUDA device is available; pass "
                "device='cpu' to run on the CPU"
            )
        self._copy_stream = None
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
            # Host-to-device staging copies run here, beside the wave
            # programs on the compute stream (no fallback: a failure
            # raises).
            self._copy_stream = torch.cuda.Stream(device)
        self.device = device
        self.mesh = mesh if mesh is not None else meshutil.Mesh(None, device)
        self.nmesh = self.mesh.size
        self.slot = self.mesh.rank
        self.multiprocess = self.nmesh > 1
        # Over ranks the launch order must be the same everywhere.
        self.ordered_dispatch = self.multiprocess
        if prefetch_depth is None:
            env = os.environ.get("BIGSLICE_PREFETCH_DEPTH")
            prefetch_depth = int(env) if env else 1
        self.prefetch_depth = max(0, int(prefetch_depth))
        if donate_buffers is None:
            env = os.environ.get("BIGSLICE_DONATE_BUFFERS")
            donate_buffers = (env not in ("0", "false", "off")) if env \
                else True
        self.donate_buffers = bool(donate_buffers)
        if device_budget_bytes is None:
            env = os.environ.get("BIGSLICE_DEVICE_BUDGET_BYTES")
            device_budget_bytes = int(env) if env else None
        self.device_budget_bytes = device_budget_bytes
        self.staging_arena = staging.StagingArena(
            enabled=staging_arena, mode=staging.staging_mode(device))
        self.stage_threads = staging.stage_threads_default()
        self.auto_dense = bool(auto_dense)
        self.hash_aggregate = bool(hash_aggregate)
        self.subid_split = bool(subid_split)
        self.store = _BridgedStore(self)
        # The host tier: the same store (host outputs land in its frame
        # tier, device outputs serve through it) and the same device.
        self.local = LocalExecutor(procs=fallback_procs, store=self.store,
                                   device=device)
        self._lock = threading.Lock()
        # One wave program's dispatch or settle at a time.
        self._wave_mutex = threading.RLock()
        self._groups: Dict[Tuple, _GroupState] = {}
        self._group_runs = 0
        # Every group that has launched, by key: all its shards' tasks.
        self._members: Dict[Tuple, List[Task]] = {}
        # One lock a launched group: its runs take turns.
        self._group_turns: Dict[Tuple, threading.Lock] = {}
        self._outputs: Dict[Tuple, object] = {}
        self._task_index: Dict[TaskName, Tuple[Tuple, Task]] = {}
        # The session-local program table (reference :714): session key
        # (with the stage functions' ids) -> (_ProgramEntry, weakrefs to
        # those functions). It holds accounting, not programs: a wave
        # program is rebuilt on every call (``_program``).
        self._programs: Dict[Tuple, Tuple[_ProgramEntry, tuple]] = {}
        # Ops whose hash table overflowed: back on the sort path for good,
        # which handles any key distribution.
        self._hash_off: set = set()
        # Per-op shuffle slack adapted by the overflow ladder.
        self._slack_memo: Dict[str, float] = {}
        # Per-op Cogroup group capacities: the widest its waves built.
        self._cogroup_caps: Dict[str, int] = {}
        # op base -> the attend stage's lowering ("ring" or "ulysses").
        self.attend_methods: Dict[str, str] = {}
        # Op sites whose discovered dense bound a later wave proved
        # wrong: never probed again.
        self._auto_dense_off: set = set()
        # op base -> K of its last budget-split wave; op base -> the
        # last shuffle plan (BIGSLICE_SHUFFLE set).
        self.split_runs: Dict[str, int] = {}
        self.shuffle_plans: Dict[str, shuffleplan.ShufflePlan] = {}
        # Staging seconds: all of it, and the part a group thread waited
        # for (the rest the pipeline hid behind compute).
        self._stage_clock = {"staged_s": 0.0, "exposed_s": 0.0, "waves": 0}
        # The spill exchange's FileStore, made at the first spilled
        # boundary (BIGSLICE_SPILL_DIR, else a private temp directory
        # that close() removes).
        self._spill: Optional[store_mod.FileStore] = None
        self._spill_tmp: Optional[str] = None
        self.session = None
        # The Session attaches its planners here when their knobs engage
        # (exec/adaptive.py, exec/codedplan.py); None runs today's path.
        self.adaptive = None
        self.coded = None
        # The kernel selector (parallel/kernelselect.py), attached by the
        # Session when BIGSLICE_KERNEL_SELECT engages a mode (reference
        # exec/meshexec.py:644-649). None: the hash, sort and dense
        # routing below is today's, and no selection code runs.
        self.kernel_select = None
        # Per-op probation after an infra failure (op base -> monotonic
        # end), and the resubmissions it sent to the host tier.
        self._probation: Dict[str, float] = {}
        self._probation_runs: Dict[str, int] = {}
        # The tasks the running group thread claimed: its cancellation
        # checks read their requests.
        self._claimed = threading.local()
        # The staging breakdown's sink of the wave a thread stages.
        self._stage_tls = threading.local()
        # Over ranks: the first failure of a device group or a gather on
        # this rank. The ranks are out of step from then on, so every
        # later group and host read of a device output fails with it.
        self._gang_error: Optional[HostLostError] = None
        # The keepalive over the process group's store: a wedged peer is
        # caught before this rank enters a collective it would never
        # leave (reference :746-751).
        self._keepalive = None
        # Over ranks, host-tier tasks run once on an owner rank and
        # exchange outputs through the group's store (reference
        # :747-760).
        self._hostdist = None
        if self.multiprocess:
            from bigslice_tpu_torch.exec.hostdist import HostTaskExchange
            from bigslice_tpu_torch.utils.distributed import get_keepalive

            self._keepalive = get_keepalive()
            hd = HostTaskExchange(self, keepalive=self._keepalive)
            if hd.active:
                self._hostdist = hd
        # Ordered dispatch (reference :770-796): the plan of group keys
        # (and late-gather debts), what each planned group's members are,
        # the run token that planned it, the complete groups waiting for
        # their turn, the groups that went to the host tier, and the
        # consumer-driven gather marks.
        self._plan: List = []
        self._plan_set: set = set()
        self._plan_members: Dict = {}
        self._plan_token: Dict = {}
        self._ready_set: set = set()
        self._launches: Dict = {}
        self._cancelled: set = set()
        self._ready_cond = threading.Condition(self._lock)
        self._dispatcher: Optional[threading.Thread] = None
        self._gather_analyzed: Dict = {}
        self._gather_marked: Dict = {}
        self._gather_pending: set = set()

    def start(self, session) -> None:
        """Bind the session whose telemetry hub and monitor this
        executor reports into (``Session`` calls it), for its host tier
        too."""
        self.session = session
        self.local.start(session)

    def resource_stats(self) -> dict:
        """Host memory, the card's allocator stats, the bytes of the
        device-resident group outputs, and the executor's gauges
        (adapted shuffle slack, budget-split runs, sites on the sort
        path): the status display's resource lines."""
        from bigslice_tpu_torch.utils import resources as resources_mod

        with self._lock:
            outs = list(self._outputs.values())
            gauges = {
                "shuffle_slack": dict(self._slack_memo),
                "split_runs": dict(self.split_runs),
                "hash_off": sorted(self._hash_off),
            }
        return {
            "host_rss_bytes": resources_mod.host_rss_bytes(),
            "devices": resources_mod.device_memory(
                [self.device] if self.device.type == "cuda" else []),
            "resident_output_bytes": sum(_output_bytes(o) for o in outs),
            "gauges": gauges,
        }

    # -- submission -------------------------------------------------------

    @property
    def probation(self) -> Dict[str, dict]:
        """The ops put on probation by an infra failure: op base ->
        ``{"remaining_s", "host_runs"}`` (the resubmissions it sent to
        the host tier)."""
        now = time.monotonic()
        with self._lock:
            return {op: {"remaining_s": max(0.0, until - now),
                         "host_runs": self._probation_runs.get(op, 0)}
                    for op, until in self._probation.items()}

    def device_group_count(self) -> int:
        """Device group programs run so far (each launch of a group,
        reruns included)."""
        with self._lock:
            return self._group_runs

    def resize(self, mesh: meshutil.Mesh) -> List[Task]:
        """Elasticity (reference exec/meshexec.py:1147-1200): move the
        executor onto ``mesh`` between runs. Shard counts and mesh size
        are decoupled (waves), so a compiled graph runs unchanged on it.
        Committed outputs are salvaged to the host (later consumers
        stage them from there, never zero-copy); an output that cannot
        be read any more (device-only over ranks, or its device gone)
        has its tasks marked LOST, and the evaluator recomputes them on
        the new mesh (a launched group reruns whole, settling the
        members then waiting; a group that failed re-forms from its
        resubmitted members). The per-mesh state goes: the program
        table, the adapted shuffle slack, probation and the latched gang
        error. Returns the tasks marked LOST. Call it between runs only (the elastic
        session drains first); ``mesh`` must be on this executor's
        device."""
        if _device_key(mesh.device) != _device_key(self.device):
            raise ValueError(f"resize: the mesh's device {mesh.device} is "
                             f"not this executor's {self.device}")
        lost: List[Tuple[Task, BaseException]] = []
        with self._lock:
            # A group that launched and failed (no output) re-forms from
            # its resubmitted members on the new mesh, one launch for
            # all of them.
            for key in [k for k in self._members if k not in self._outputs]:
                del self._members[key]
            for key in list(self._outputs):
                out = self._outputs[key]
                try:
                    if isinstance(out, shuffleplan.SpilledGroupOutput):
                        continue  # in the spill store, not on a device
                    for w in getattr(out, "waves", None) or [out]:
                        w.drop_device()
                except Exception as e:  # noqa: BLE001 — gone with the mesh
                    del self._outputs[key]
                    for name, (k2, t) in list(self._task_index.items()):
                        if k2 == key:
                            del self._task_index[name]
                            if t.state == TaskState.OK:
                                lost.append((t, RuntimeError(
                                    f"output of {name} lost in mesh "
                                    f"resize: {e!r}")))
            self._programs.clear()
            self._slack_memo.clear()
            self._probation.clear()
            self._gang_error = None
            self.mesh = mesh
            self.nmesh = mesh.size
            self.slot = mesh.rank
            self.multiprocess = self.nmesh > 1
            self.ordered_dispatch = self.multiprocess
            if not self.multiprocess:
                self._hostdist = None
                self._keepalive = None
        for t, err in lost:  # outside the lock: transitions notify
            t.mark_lost(err)
        return [t for t, _ in lost]

    def speculate(self, task: Task, on_outcome=None) -> bool:
        """A speculative duplicate of a RUNNING task (exec/adaptive.py),
        delegated to the host tier, whose stamp limits it to tasks its
        own pool runs: a device group has no duplicate to race."""
        return self.local.speculate(task, on_outcome=on_outcome)

    def submit(self, task: Task) -> None:
        if not self._eligible(task):
            # The whole group shares the verdict (it is a function of
            # the chain, deps and partitioner), so a resubmitted task
            # returns to the tier that made its output.
            if self.ordered_dispatch and task.group_key is not None:
                # It never runs on the devices: unblock the plan.
                with self._lock:
                    self._cancelled.add(task.group_key)
                    self._ready_cond.notify_all()
            self._submit_host(task)
            return
        key = task.group_key
        if self.multiprocess:
            with self._lock:
                rerun = key in self._members
            if rerun:
                # Over ranks a launched group never reruns: its peers,
                # which did not lose its output, would never enter the
                # rerun's collectives.
                task.set_state(TaskState.ERR, self._out_of_step(
                    f"a rerun of device group {task.name.op} (its output "
                    f"was lost on this rank)"))
                return
        planned = False
        with self._lock:
            members = self._members.get(key)
            if members is not None:
                # A resubmission (lost output) of a group that launched
                # before: the program spans every shard, so re-run the
                # whole group and settle the members then waiting (the
                # lost members of one group arrive together; one rerun
                # settles them all).
                launch = (members, None)
            else:
                g = self._groups.get(key)
                if g is None:
                    g = self._groups[key] = _GroupState(task.name.num_shard)
                g.tasks[task.name.shard] = task
                launch = None
                if len(g.tasks) == g.num_shard and not g.launched:
                    g.launched = True
                    del self._groups[key]
                    members = [g.tasks[s] for s in range(g.num_shard)]
                    self._members[key] = members
                    launch = (members, members)
                    # A planned group waits for its turn on the
                    # dispatcher; an unplanned one (no planning session)
                    # runs at once.
                    planned = self.ordered_dispatch and key in self._plan_set
                    if planned:
                        self._ready_set.add(key)
                        self._launches[key] = launch
            if self.ordered_dispatch:
                self._ready_cond.notify_all()
        if launch is not None and not planned:
            threading.Thread(target=self._run_group, args=(key, *launch),
                             daemon=True).start()

    def _submit_host(self, task: Task) -> None:
        """A host-tier task by compile-time classification (the same on
        every rank): owner-routed over ranks (a non-owner resolves
        through the exchange's poller), local otherwise (reference
        :970-983). Fallbacks decided at run time (a flushed plan entry,
        the attend stage's host reader) run locally."""
        if self._hostdist is not None and self._hostdist.submit(task):
            return
        self.local.submit(task)

    def release_run_outputs(self, roots: List[Task]) -> None:
        """After a successful run: the store hygiene of the distributed
        host tasks (``hostdist.release_run``)."""
        if self._hostdist is not None:
            self._hostdist.release_run(roots)

    def abort_run_outputs(self, roots: List[Task], err) -> None:
        """After a failed run: resolve the peers waiting on this rank's
        host tasks (``hostdist.abort_run``)."""
        if self._hostdist is not None:
            self._hostdist.abort_run(roots, err)

    # -- ordered dispatch (reference exec/meshexec.py:805-999) -------------

    def plan_groups(self, entries, token=None) -> None:
        """Register the launch order of the run's device groups (the
        session calls it before evaluation): ``entries`` is an ordered
        sequence of ``(group_key, member_tasks)``, groups whose members
        are all OK left out. ``token`` names the run for
        ``finish_run``."""
        if not self.ordered_dispatch:
            return
        with self._lock:
            for k, members in entries:
                if k is not None and k not in self._plan_set:
                    self._plan.append(k)
                    self._plan_set.add(k)
                    self._plan_members[k] = tuple(members)
                    self._plan_token[k] = token
            self._start_dispatcher()
            self._ready_cond.notify_all()

    def _start_dispatcher(self) -> None:
        if self._dispatcher is None:
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, daemon=True,
                name="mesh-dispatch")
            self._dispatcher.start()

    def plan_gather(self, roots, token=None) -> None:
        """Consumer-driven gather (reference :829-880), called by the
        session before ``plan_groups``: mark the run's groups whose
        outputs a host reads (the roots, producers of host-tier
        consumers, producers a device consumer reads through the store
        bridge). Everything else stays on the ranks' devices. An output
        that ran before, still on the devices, which this run newly
        reads on the host becomes a late-gather debt at the plan's
        front. Compile-time state only, so every rank marks the same
        groups."""
        if not self.ordered_dispatch:
            return
        from bigslice_tpu_torch.exec.task import iter_tasks

        need: Dict = {}  # insertion-ordered: the same on every rank
        analyzed = []
        for t in iter_tasks(roots):
            if t.group_key is not None:
                analyzed.append(t.group_key)
            if t.state == TaskState.OK:
                continue
            for d in t.deps:
                pkey = d.tasks[0].group_key
                if pkey is not None and self._consumer_reads_host(t, d):
                    need[pkey] = None
        for rt in roots:
            if rt.group_key is not None:
                need[rt.group_key] = None
        with self._lock:
            for k in analyzed:
                self._gather_analyzed[k] = token
            for k in need:
                self._gather_marked[k] = token
            queued = False
            for k in need:
                out = self._outputs.get(k)
                if (out is not None and not getattr(out, "gathered", True)
                        and k not in self._gather_pending):
                    entry = _GatherEntry(k)
                    self._plan.append(entry)
                    self._plan_set.add(entry)
                    self._plan_token[entry] = token
                    self._gather_pending.add(k)
                    queued = True
            if queued:
                self._start_dispatcher()
                self._ready_cond.notify_all()

    def _consumer_reads_host(self, consumer: Task, dep) -> bool:
        """Does ``consumer`` read ``dep``'s output through the store
        bridge? ``_dep_input``'s zero-copy conditions, from compile-time
        facts (reference :882-902)."""
        if not self._eligible(consumer, count=False):
            return True
        if dep.tasks[0].num_partition > 1:
            return False  # partition-addressed on the slots
        return len(dep.tasks) != 1

    def finish_run(self, token=None, failed: bool = True) -> None:
        """The session's evaluation ended (reference :904-975): drop
        this run's plan entries that will never be submitted, flushing a
        partly arrived group's tasks to the host tier, and its gather
        marks. An aborted run's unpaid gather debts are dropped; a
        successful run's stay for the dispatcher (its result scan waits
        on them)."""
        if not self.ordered_dispatch:
            return
        flush = []
        with self._lock:
            keep = []
            for k in self._plan:
                if self._plan_token.get(k) != token:
                    keep.append(k)
                    continue
                if isinstance(k, _GatherEntry):
                    if not failed:
                        keep.append(k)
                        continue
                    self._plan_set.discard(k)
                    self._plan_token.pop(k, None)
                    self._gather_pending.discard(k.key)
                    continue
                g = self._groups.get(k)
                if g is not None and not g.launched:
                    g.launched = True
                    del self._groups[k]
                    flush.extend(g.tasks.values())
                if k in self._ready_set:
                    # Complete, never dispatched: its tasks still wait.
                    self._ready_set.discard(k)
                    flush.extend(self._launches.pop(k)[1])
                self._plan_set.discard(k)
                self._plan_members.pop(k, None)
                self._plan_token.pop(k, None)
                self._cancelled.discard(k)
            self._plan = keep
            for d in (self._gather_analyzed, self._gather_marked):
                for k in [k for k, t in d.items() if t == token]:
                    del d[k]
            self._ready_cond.notify_all()
        for t in flush:
            self.local.submit(t)

    def _pop_head(self, head) -> None:
        self._plan.pop(0)
        self._plan_set.discard(head)
        self._plan_members.pop(head, None)
        self._plan_token.pop(head, None)

    def _dispatch_loop(self) -> None:
        """The one dispatcher (reference :1378-1452): launch the plan's
        head once every member is accounted for (arrived, or OK from an
        earlier run), pay gather debts in their place, skip groups that
        went to the host tier. State decides, never a clock: the timed
        wait only polls."""
        while True:
            launch = gather = None
            with self._lock:
                while True:
                    while not self._plan:
                        self._ready_cond.wait()
                    head = self._plan[0]
                    if isinstance(head, _GatherEntry):
                        self._pop_head(head)
                        gather = (head.key, self._outputs.get(head.key))
                        break
                    if head in self._cancelled:
                        self._pop_head(head)
                        self._cancelled.discard(head)
                        continue
                    if head in self._ready_set:
                        self._pop_head(head)
                        self._ready_set.discard(head)
                        launch = (head,) + self._launches.pop(head)
                        break
                    g = self._groups.get(head)
                    arrived = g.tasks if g is not None else {}
                    pending = [t for t in self._plan_members.get(head, ())
                               if t.name.shard not in arrived
                               and t.state != TaskState.OK]
                    if not pending:
                        full = list(self._plan_members.get(head, ()))
                        self._pop_head(head)
                        if g is not None and arrived and not g.launched:
                            # Partly OK from an earlier run: the program
                            # spans every shard; the arrived ones settle.
                            g.launched = True
                            del self._groups[head]
                            full.sort(key=lambda t: t.name.shard)
                            self._members[head] = full
                            launch = (head, full, list(arrived.values()))
                            break
                        continue
                    self._ready_cond.wait(timeout=0.05)
            if gather is not None:
                key, out = gather
                try:
                    if out is not None:
                        out.gather(self.mesh)
                except Exception as e:  # noqa: BLE001 — latched: the
                    # readers of any device output fail with it
                    self._out_of_step(f"the gather of device group "
                                      f"{key[1]}", e)
                finally:
                    with self._lock:
                        self._gather_pending.discard(key)
                        self._ready_cond.notify_all()
                continue
            try:
                self._run_group(*launch)
            except Exception as e:  # noqa: BLE001 — keep the only
                # dispatcher alive; _run_group settles its tasks
                self._out_of_step(f"device group {launch[0][1]}", e)

    def reader(self, task: Task, partition: int):
        return self.store.read(task.name, partition)

    def discard(self, task: Task) -> None:
        with self._lock:
            out = self._outputs.pop(task.group_key, None)
            self._task_index.pop(task.name, None)
        if isinstance(out, shuffleplan.SpilledGroupOutput):
            out.discard()  # retire the group's spill entries
        self.local.discard(task)

    def close(self) -> None:
        """Delete this rank's published host-task outputs from the
        group's store, and remove the private spill directory (a
        ``BIGSLICE_SPILL_DIR`` named by the caller, a directory or a URL
        base such as ``memory://spill``, is theirs to keep)."""
        if self._hostdist is not None:
            self._hostdist.close()
        with self._lock:
            tmp, self._spill_tmp = self._spill_tmp, None
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

    def _spill_store(self) -> store_mod.FileStore:
        with self._lock:
            if self._spill is None:
                base = os.environ.get("BIGSLICE_SPILL_DIR")
                if not base:
                    base = tempfile.mkdtemp(prefix="bigslice-spill-")
                    self._spill_tmp = base
                self._spill = store_mod.FileStore(base)
            return self._spill

    def staging_seconds(self) -> dict:
        """Staging time summed over every staged wave since construction
        (or ``reset_staging_seconds``): ``staged_s`` all of it,
        ``exposed_s`` the part a group thread waited for, ``hidden_s``
        the rest (overlapped with compute), and ``waves``."""
        with self._lock:
            out = dict(self._stage_clock)
        out["hidden_s"] = max(0.0, out["staged_s"] - out["exposed_s"])
        return out

    def reset_staging_seconds(self) -> None:
        with self._lock:
            self._stage_clock.update(staged_s=0.0, exposed_s=0.0, waves=0)

    def _note_staging(self, task0: Task, wave: int, staged_s: float,
                      exposed_s: float,
                      breakdown: Optional[dict] = None) -> None:
        with self._lock:
            c = self._stage_clock
            c["staged_s"] += staged_s
            c["exposed_s"] += exposed_s
            c["waves"] += 1
        # The hub hears the same two numbers, so its overlap figures
        # equal staging_seconds() over the same waves, and the breakdown
        # of where the staging time went.
        self._telemetry_staging(task0, wave, staged_s, exposed_s,
                                breakdown)

    # -- telemetry seams (utils/telemetry.py) -------------------------------
    #
    # Best-effort: a telemetry failure never fails a wave. Each costs
    # host arithmetic only; the per-partition rows ride the signals that
    # each wave's settle reads back anyway (``_issue_signals``), so the
    # hub adds no host sync. Without a hub every seam returns at once.

    def _telemetry_hub(self):
        return getattr(self.session, "telemetry", None)

    def _device_telemetry(self):
        return getattr(self._telemetry_hub(), "device", None)

    def _emit_phase(self, task: Task, phase: str, wave: int) -> None:
        """A wave-pipeline phase (inputs staged on the prefetcher, or
        the program dispatched) through the session's monitor chain and
        eventer."""
        sess = self.session
        if sess is None:
            return
        notify_phase(sess.monitor, task, phase, wave)
        try:
            sess._event(f"bigslice:{phase}", op=task.name.op, wave=wave,
                        inv=task.name.inv_index)
        except Exception:  # noqa: BLE001 — an eventer never fails a wave
            pass

    def _launch_sink(self, task0: Task):
        """The kernel-launch listener of ``task0``'s op (None without a
        hub): each counted launch adds its declared cost to the op."""
        dev = self._device_telemetry()
        if dev is None:
            return None
        op, inv = task0.name.op, task0.name.inv_index

        def sink(name, cost):
            dev.record_launch(op, inv, name, cost)

        return sink

    def _telemetry_staging(self, task0: Task, wave: int, dur_s: float,
                           exposed_s: float,
                           breakdown: Optional[dict] = None) -> None:
        """One wave's staging seconds, the part the group thread waited
        for, and the read/decode/assemble/upload breakdown (the parts
        are timed inside the staging, so they sum to at most it)."""
        hub = self._telemetry_hub()
        if hub is None:
            return
        try:
            hub.record_wave_staging(task0.name.op, task0.name.inv_index,
                                    wave, dur_s, exposed_s,
                                    breakdown=breakdown)
        except Exception:  # noqa: BLE001
            pass

    def _telemetry_compute(self, task0: Task, wave: int,
                           dur_s: float) -> None:
        """One wave's dispatch-to-settle time, then the watermark: the
        wave just settled, its buffers at their fullest."""
        hub = self._telemetry_hub()
        if hub is None:
            return
        try:
            hub.record_wave_compute(task0.name.op, task0.name.inv_index,
                                    wave, dur_s)
        except Exception:  # noqa: BLE001
            pass
        self._telemetry_hbm(task0, wave)

    def _telemetry_hbm(self, task0: Task, wave: Optional[int]) -> None:
        """A device-memory watermark: the caching allocator's stats on
        ``cuda``; on the CPU the bytes of the outputs this executor
        holds."""
        dev = self._device_telemetry()
        if dev is None:
            return

        def live_bytes():
            with self._lock:
                outs = list(self._outputs.values())
            return sum(_output_bytes(o) for o in outs)

        dev.sample_hbm(self.device, op=task0.name.op,
                       inv=task0.name.inv_index, wave=wave,
                       live_bytes=live_bytes)

    def _telemetry_donation(self, task0: Task, inputs,
                            out: "DeviceGroupOutput") -> None:
        """``_donate`` with its effectiveness recorded: the bytes of the
        storages the wave owned against the bytes it freed (a storage
        its output still uses stays). Host arithmetic only: no
        allocator read."""
        expected, nbuf, freed, nfreed = _donate(inputs, out)
        dev = self._device_telemetry()
        if dev is None or not nbuf:
            return
        try:
            dev.record_donation(task0.name.op, task0.name.inv_index,
                                expected, freed, nbuf, nfreed)
        except Exception:  # noqa: BLE001
            pass

    def _telemetry_exchange(self, task0: Task, wave: int, inputs,
                            slack: float) -> None:
        """One wave's exchange from its static structure: each of the N
        slots sends a bucket of ``send_capacity`` rows to each of the
        N - 1 others, over the mesh's backend. On one slot the exchange
        seam is the identity: no message leaves the card."""
        dev = self._device_telemetry()
        if dev is None or task0.num_partition <= 1:
            return
        try:
            N = self.nmesh
            rowbytes = sum(torch_dtype(ct.dtype).itemsize
                           for ct in task0.schema) or 4
            cap = max((i.capacity for i in inputs), default=1)
            waved = task0.num_partition > N
            send_cap = shuffle_mod.send_capacity(
                cap, N if waved else min(task0.num_partition, N), slack)
            flat_bytes = send_cap * (rowbytes + (4 if waved else 0))
            if self.mesh.is_hier:
                from bigslice_tpu_torch.parallel import hier

                # The bodies' own capacity plan (reference :1999-2023):
                # I - 1 ICI buckets and D - 1 DCN buckets a rank, and
                # what the flat exchange would send across DCN.
                D, I = self.mesh.ndcn, self.mesh.nici
                plan = hier.exchange_plan(D, I, task0.num_partition, cap,
                                          slack)
                ici, dcn = N * (I - 1), N * (D - 1)
                dcn_bytes = dcn * plan["cap2"] * (
                    rowbytes + 4 * plan["stage2_extra_cols"])
                dev.record_exchange(
                    task0.name.op, task0.name.inv_index, wave,
                    messages=ici + dcn,
                    nbytes=ici * plan["cap1"] * (
                        rowbytes + 4 * plan["stage1_extra_cols"])
                    + dcn_bytes,
                    backend=self.mesh.backend, dcn_messages=dcn,
                    dcn_bytes=dcn_bytes, flat_dcn_messages=dcn * I,
                    flat_dcn_bytes=dcn * I * flat_bytes)
                return
            msgs = N * (N - 1)
            dev.record_exchange(
                task0.name.op, task0.name.inv_index, wave, messages=msgs,
                nbytes=msgs * flat_bytes, backend=self.mesh.backend)
        except Exception:  # noqa: BLE001
            pass

    def _record_shuffle(self, task0: Task, out) -> None:
        """A partitioned group's rows (and bytes) a partition: out of
        the map side's combine, summed over its waves, from the counts
        each wave's signals carried; a spilled boundary's from the spill
        manifest."""
        hub = self._telemetry_hub()
        try:
            if hub is None:
                return
            rowbytes = sum(torch_dtype(ct.dtype).itemsize
                           * max(1, int(np.prod(ct.shape)))
                           for ct in task0.schema) or 4
            if isinstance(out, shuffleplan.SpilledGroupOutput):
                rows = out.exchange.partition_rows()
            else:
                rows = out.part_rows
            if rows and self.multiprocess:
                # Each rank reports the partitions its slot holds, at
                # their global places: the fleet merge sums the ranks'
                # vectors into the whole one (reference :2090-2104).
                idx = list(range(self.slot, len(rows), self.nmesh))
                if idx:
                    hub.record_shuffle(
                        task0.name.op, task0.name.inv_index,
                        [rows[p] for p in idx],
                        [rows[p] * rowbytes for p in idx], indices=idx,
                        rank=self.slot)
            elif rows:
                hub.record_shuffle(task0.name.op, task0.name.inv_index,
                                   rows, [r * rowbytes for r in rows])
        except Exception:  # noqa: BLE001
            pass
        finally:
            # The op's rows a partition just changed: the selector's
            # re-selection consult (reference exec/meshexec.py:2105-2108).
            self._kernel_reselect(task0)

    def _kernel_reselect(self, task0: Task) -> None:
        """The kernel selector compares the op's rows a partition with
        the snapshot its decisions were based on and drops those that
        shifted (reference exec/meshexec.py:2110-2134); through the
        adaptive planner when one is attached. Over ranks it is skipped
        (reference :2118-2124): a lowering that diverged between ranks
        would deadlock the exchange."""
        sel = self.kernel_select
        if sel is None or self.multiprocess:
            return
        opb = _op_base(task0.name.op)
        sel.current_inv = task0.name.inv_index
        try:
            if self.adaptive is not None:
                self.adaptive.observe_kernel_wave(sel, opb,
                                                  hub_op=task0.name.op)
            else:
                sel.observe_wave(opb, hub_op=task0.name.op)
        except Exception:  # noqa: BLE001 — advisory, never a wave error
            pass

    def _record_shuffle_plan(self, task0: Task, plan, out) -> None:
        """A boundary's exchange decision and, when spilled, what the
        spill exchange wrote."""
        dev = self._device_telemetry()
        if dev is None:
            return
        try:
            kwargs = {}
            if out is not None:
                kwargs = dict(
                    spill_bytes=out.exchange.spill_bytes,
                    spill_rows=out.exchange.spill_rows,
                    partitions=out.exchange.partitions_written(),
                    map_waves=out.map_waves,
                )
            dev.record_shuffle_plan(
                task0.name.op, task0.name.inv_index, plan.kind,
                plan.reason, est_bytes=plan.est_bytes,
                budget_bytes=plan.budget_bytes, **kwargs)
        except Exception:  # noqa: BLE001
            pass

    @property
    def auto_dense_off(self) -> frozenset:
        """The op sites whose discovered dense bound was retracted."""
        with self._lock:
            return frozenset(self._auto_dense_off)

    def _eligible(self, task: Task, count: bool = True) -> bool:
        """Whether the device path runs ``task``; the rest runs on the
        host tier. The JAX package's rule (its ``_eligible``), less what
        this package has not (SPMD): not a coded group and not on
        probation; device columns throughout, scalar keys where a
        shuffle routes them, a per-row (device) partitioner and a device
        combiner; device-tier Map/Filter/Flatmap, Reduce and Fold; a
        GroupByKey or JoinAggregate (both sides' fns device, both
        inputs device scalars) only as the chain's innermost slice; a
        SelfAttend only as the chain's innermost slice and over no more
        shards than device slots (it spans the whole sequence in one
        program, which waves would cut); a Cogroup alone in its chain, unshuffled, over device
        scalar inputs and not machine-combined (its own output is host
        lists, the readback's decode); and nothing else — Scan,
        MapBatches and the sources run on the host tier.

        Over ranks no op goes on probation (a failed group is fatal
        there); a SelfAttend over S <= N shards runs the multi-slot
        attend stage (the ring's K/V rotation, Ulysses' two
        all_to_alls). ``count`` False (the gather planner) leaves the
        probation tally alone."""
        if task.chain is None:
            return False
        if getattr(task, "coded_group", None) is not None or any(
                getattr(d, "coded", None) is not None for d in task.deps):
            # A coverage member runs unit by unit with per-unit store
            # names, and its consumer reads the masked view: both are
            # the host tier's (reference exec/meshexec.py:1231-1238).
            return False
        opb = _op_base(task.name.op)
        with self._lock:
            until = self._probation.get(opb)
            if until is not None:
                if time.monotonic() < until:
                    # On probation (reference exec/meshexec.py:1240-1246).
                    if count:
                        self._probation_runs[opb] = \
                            self._probation_runs.get(opb, 0) + 1
                    return False
                del self._probation[opb]
        last = task.chain[-1]
        part = task.partitioner
        if isinstance(last, SelfAttend) and task.name.num_shard > self.nmesh:
            # S > N: the stage spans the whole sequence in one program.
            return False
        if isinstance(last, Cogroup):
            if part.combine_key or any(d.combine_key for d in task.deps):
                return False
            return (len(task.chain) == 1 and task.num_partition == 1
                    and all(ct.is_device and ct.shape == ()
                            for sl in last.slices for ct in sl.schema))
        if not all(ct.is_device for ct in task.schema):
            return False
        if task.num_partition > 1:
            if not all(ct.shape == () for ct in task.schema.key):
                return False
            pf = part.partition_fn
            if pf is not None and not isinstance(pf, RowPartitioner):
                return False  # a frame-level host partitioner
            if part.combiner is not None and not part.combiner.device:
                return False
        for s in task.chain:
            if isinstance(s, (Const, _PrefixedSlice, Reshuffle, Reshard)):
                if not all(ct.is_device for ct in s.schema):
                    return False
            elif isinstance(s, (Map, Filter, Flatmap)):
                if s.mode != "device":
                    return False
            elif isinstance(s, Reduce):
                if not s.frame_combiner.device:
                    return False
            elif isinstance(s, Fold):
                if not s.device:
                    return False
            elif isinstance(s, (GroupByKey, SelfAttend)):
                # Its own op typechecks its inputs (device scalars, or
                # the device vectors q, k, v).
                if s is not last:
                    return False
            elif isinstance(s, JoinAggregate):
                if (s is not last
                        or not all(fc.device for fc in s.frame_combiners)
                        or not all(ct.is_device and ct.shape == ()
                                   for d in s.deps()
                                   for ct in d.slice.schema)):
                    return False
            elif not isinstance(s, Head):
                return False
        return True

    # -- group orchestration ----------------------------------------------

    def _run_group(self, key, tasks: List[Task],
                   arrived: Optional[List[Task]]) -> None:
        """Run the group of ``tasks`` (every shard) and settle the
        ``arrived`` ones, which this run claims; ``None`` (a rerun)
        claims every member then WAITING. Runs of one group take turns,
        so concurrent resubmissions never run it twice at once."""
        with self._lock:
            turn = self._group_turns.setdefault(key, threading.Lock())
        with turn:
            claimed = [t for t in (tasks if arrived is None else arrived)
                       if t.transition_if(TaskState.WAITING,
                                          TaskState.RUNNING)]
            if claimed:
                self._run_claimed(key, tasks, claimed)

    def _run_claimed(self, key, tasks: List[Task],
                     claimed: List[Task]) -> None:
        """Dispatch the group and settle ``claimed``: OK, CANCELLED,
        LOST (a lost dep, or an infra error: probation), or ERR. Over
        ranks every failure is ERR (``_out_of_step``)."""
        self._claimed.tasks = claimed
        try:
            if self._gang_error is not None:
                raise self._gang_error
            # Cancellation before dispatch (reference exec/meshexec.py:
            # 1504-1510); between waves in _execute_waves.
            self._check_cancel()
            if faultinject.ENABLED:
                # Chaos seam (reference exec/meshexec.py:1515-1524):
                # 'slow' is absorbed, 'infra' takes the probation ladder
                # below, 'hostloss' surfaces as HostLostError.
                fault = faultinject.absorb_slow(
                    faultinject.fire("mesh.dispatch"))
                if fault is not None:
                    err = faultinject.injected_error(fault)
                    if fault.kind == "hostloss":
                        err = HostLostError(
                            f"host lost during group {tasks[0].name.op} "
                            f"({fault.describe()})")
                        err.fault, err.fault_site = fault, fault.site
                    raise err
            if self._keepalive is not None:
                # A wedged peer fails this group fast instead of
                # hanging it in a collective (reference :1511-1514).
                self._keepalive.check()
            elif faultinject.ENABLED:
                # The keepalive's chaos site, in one process too.
                from bigslice_tpu_torch.utils.distributed import (
                    check_injected_peer_loss)

                check_injected_peer_loss()
            with meshutil.active(self.mesh):
                self._execute_group(key, tasks)
            with self._lock:
                for t in tasks:
                    self._task_index[t.name] = (key, t)
                out = self._outputs.get(key)
                device_only = (key in self._gather_analyzed
                               and key not in self._gather_marked)
            if self.multiprocess and out is not None and not device_only:
                # In launch order, before any consumer can start: the
                # outputs a host reads are on every rank's host
                # (reference :1530-1540). Unplanned groups gather.
                out.gather(self.mesh)
            for t in claimed:
                t.mark_ok()
        except Exception as e:  # noqa: BLE001 — settles as the tasks' state
            if self.multiprocess and not isinstance(e, _AttendHostFallback):
                # A rerun, probation or a host-tier retry would be this
                # rank's decision alone, and its peers would wait in a
                # collective it never enters: fatal on this rank.
                err = self._out_of_step(f"device group {tasks[0].name.op}",
                                        e)
                for t in claimed:
                    t.set_state(TaskState.ERR, err)
            else:
                self._settle_failure(tasks, claimed, e)
        finally:
            self._claimed.tasks = ()

    def _settle_failure(self, tasks: List[Task], claimed: List[Task],
                        e: Exception) -> None:
        """Settle the claimed tasks of a failed group (one process; over
        ranks only the attend stage's host reader comes here)."""
        if isinstance(e, TaskCancelled):
            # A cooperative stop: resubmittable, not fatal.
            for t in claimed:
                t.transition_if(TaskState.RUNNING, TaskState.CANCELLED)
        elif isinstance(e, DepLost):
            for p in e.producers:
                # A producer that is not OK is being recomputed already.
                if p.state == TaskState.OK:
                    p.mark_lost(e)
            for t in claimed:
                t.mark_lost(e)
        elif isinstance(e, _AttendHostFallback):
            # No device output for the attend stage to read: the group
            # runs the host tier's broadcast reader (the JAX package's
            # rule; a failure of the stage itself is never sent there).
            # Over ranks too: the producer's tier is a compile-time fact,
            # so every rank raises it before any collective.
            for t in claimed:
                t.set_state(TaskState.WAITING)
                self.local.submit(t)
        elif _looks_like_infra_error(e):
            # The infra class (reference exec/meshexec.py:1615-1628): the
            # op's device path goes on probation and its tasks are LOST,
            # so the evaluator resubmits them to the host tier until
            # probation ends. MAX_CONSECUTIVE_LOST still bounds a loop.
            with self._lock:
                self._probation[_op_base(tasks[0].name.op)] = (
                    time.monotonic() + PROBATION_SECS)
            for t in claimed:
                t.mark_lost(e)
        else:
            for t in claimed:
                t.set_state(TaskState.ERR, e)

    def _out_of_step(self, what: str,
                     cause: Optional[BaseException] = None) -> HostLostError:
        """Over ranks: ``what`` failed on this rank, so the ranks are
        out of step (its peers may wait in a collective this rank will
        never enter). Latch the first such error, which every later
        group and host read of a device output raises, and return it
        (reference :1578-1584 for a lost peer)."""
        if isinstance(cause, HostLostError):
            err = cause
        elif cause is not None and _looks_like_host_loss(cause):
            err = HostLostError(
                f"peer process lost during {what}: restart the driver "
                f"on every rank; cause: {cause!r}")
        else:
            err = HostLostError(
                f"{what} failed on rank {self.slot}, so the ranks are "
                f"out of step: restart the driver on every rank"
                + (f"; cause: {cause!r}" if cause is not None else ""))
        if err is not cause:
            err.__cause__ = cause
        with self._lock:
            if self._gang_error is None:
                self._gang_error = err
            return self._gang_error

    def _check_cancel(self) -> None:
        """Raise TaskCancelled if a task this group thread claimed was
        asked to stop (all members share a deadline's request)."""
        for t in getattr(self._claimed, "tasks", ()):
            t.check_cancel()

    def _execute_group(self, key, tasks: List[Task]) -> None:
        with self._lock:
            self._group_runs += 1
        while True:
            try:
                out = self._execute_group_waves(tasks)
                break
            except _AutoDenseRetry:
                # Nothing was committed (outputs assign only on
                # success): the whole group reruns, re-staging every wave
                # from its producers, with one more bound retracted.
                continue
        with self._lock:
            self._outputs[key] = out
        if tasks[0].num_partition > 1:
            self._record_shuffle(tasks[0], out)
        # The group's output is in place (merged, if waved): the last
        # watermark of its work.
        self._telemetry_hbm(tasks[0], None)

    def _execute_group_waves(self, tasks: List[Task]):
        task0 = tasks[0]
        N = self.nmesh
        wave_tasks = [tasks[w * N : (w + 1) * N]
                      for w in range((len(tasks) + N - 1) // N)]
        # The shuffle-plan seam: None (BIGSLICE_SHUFFLE unset) leaves the
        # in-program path untouched.
        plan = inputs0 = None
        if task0.num_partition > 1 or len(tasks) > N:
            plan, inputs0 = self._shuffle_plan(task0, wave_tasks)
            if plan is not None:
                with self._lock:
                    self.shuffle_plans[_op_base(task0.name.op)] = plan
        spill = plan is not None and plan.kind == "spill"
        if task0.num_partition > 1 and spill:
            out = self._execute_group_spill(task0, wave_tasks, plan,
                                            inputs0)
            self._record_shuffle_plan(task0, plan, out)
            return out
        if task0.num_partition > 1 and plan is not None:
            self._record_shuffle_plan(task0, plan, None)
        if len(tasks) <= N:
            return self._execute_wave(tasks, 0, inputs0)
        # Wave streaming: ceil(S/N) waves of N shards. Partitioned outputs
        # merge across waves (wave contributions are just more
        # producers); unpartitioned ones keep per-wave shard identity.
        sink = None
        offloaded: List[DeviceGroupOutput] = []
        if task0.num_partition <= 1 and spill:
            # The spill plan's result plane: a waved unpartitioned group
            # (the reduce side's own output) keeps each settled wave on
            # the host only, so its outputs never accumulate on the
            # device either. Readers go through host chunks already.
            def sink(w: int, wout: DeviceGroupOutput) -> None:
                if self.multiprocess:
                    wout.gather(self.mesh)  # every rank, in wave order
                wout.drop_device()
                offloaded.append(wout)
        outs = self._execute_waves(task0, wave_tasks, inputs0=inputs0,
                                   sink=sink)
        if sink is not None:
            outs = offloaded
        if task0.num_partition > 1:
            return self._merge_outputs(outs, task0)
        return WavedGroupOutput(outs, N)

    # -- the shuffle-plan seam (the out-of-core spill exchange) -----------

    def _shuffle_plan(self, task0: Task, wave_tasks):
        """This boundary's exchange (``exec/shuffleplan.py``):
        ``(plan, staged wave-0 inputs or None)``. ``auto`` stages wave 0
        to price the boundary — its staged bytes times the wave count,
        held against the spill budget — and hands the inputs on, so that
        wave 0 never stages twice. ``(None, None)`` when the knob is
        unset."""
        mode = getattr(task0, "shuffle_mode", None)
        if mode is None:  # no stamping compiler: read the environment
            mode = shuffleplan.plan_mode()
        if not mode:
            return None, None
        ineligible = shuffleplan.spill_ineligible(task0)
        budget = shuffleplan.spill_budget_bytes(
            self.device_budget_bytes, self.nmesh,
            device_telemetry=self._device_telemetry())
        est = inputs0 = None
        if self.multiprocess and mode == "auto" and ineligible is None:
            # Every rank must choose alike: the least budget of any rank
            # (-1: none known) ...
            least = -self.mesh.pmax_host(
                [-1 if budget is None else -budget])[0]
            budget = None if least < 0 else least
        if mode == "auto" and ineligible is None and budget is not None:
            inputs0 = self._stage_exposed(wave_tasks[0], 0)
            est = len(wave_tasks) * sum(
                _nbytes(c) for i in inputs0 for c in list(i.cols) + [i.counts])
            if self.multiprocess:
                # ... against the largest rank's estimate.
                est = self.mesh.pmax_host([est])[0]
        return shuffleplan.choose(mode, est, budget, ineligible), inputs0

    def _execute_group_spill(self, task0: Task, wave_tasks, plan, inputs0):
        """The out-of-core exchange: each map wave runs the fused
        combine + route program as before; then its partitions are
        pulled to the host and written through the spill store (one BSF4
        entry per (wave, partition), the writes fanned out on the staging
        pool) and the wave's tensors released, so that the device holds
        one wave's working set, never the merged output. Consumers read
        the partitions back through the store bridge in their own wave
        loop and re-combine them, as they re-combine a merged output's
        wave contributions: the same rows in the same wave-major
        order."""
        nparts = task0.num_partition
        schema = task0.schema
        exchange = shuffleplan.SpillExchange(
            self._spill_store(), task0.name, len(wave_tasks), nparts)

        def spill_sink(w: int, wout: DeviceGroupOutput) -> None:
            if self.multiprocess:
                # Every rank writes every partition to its own store (a
                # collective, on every rank in wave order).
                wout.gather(self.mesh)
            parts = shuffle_mod.partition_chunks(
                wout.host_chunks(), nparts, wout.nmesh, wout.subid)
            staging.map_shards(
                lambda p: exchange.put_partition(w, p, parts[p], schema),
                range(nparts), self.stage_threads)
            wout.release()

        self._execute_waves(task0, wave_tasks, inputs0=inputs0,
                            sink=spill_sink)
        return shuffleplan.SpilledGroupOutput(
            exchange, schema, nparts, self.nmesh, plan,
            map_waves=len(wave_tasks))

    # -- the wave pipeline ------------------------------------------------

    def _stage_exposed(self, tasks: List[Task], wave: int
                       ) -> List[StagedInput]:
        """Stage a wave on this thread: all of its time is exposed."""
        t0 = time.perf_counter()
        with self._staging_breakdown() as stats:
            inputs = self._group_inputs(tasks, wave)
        dt = time.perf_counter() - t0
        self._note_staging(tasks[0], wave, dt, dt, stats)
        return inputs

    @contextlib.contextmanager
    def _staging_breakdown(self):
        """The breakdown of the wave this thread stages: its reads and
        uploads add their seconds to it (``_stage_stat``)."""
        stats: dict = {}
        self._stage_tls.stats = stats
        try:
            yield stats
        finally:
            self._stage_tls.stats = None

    def _stage_stat(self, key: str, dt: float) -> None:
        """Add one part (``read_s``, ``decode_s``, ``assemble_s``,
        ``upload_s``) to the breakdown of the wave this thread stages,
        if one is being recorded."""
        stats = getattr(self._stage_tls, "stats", None)
        if stats is not None:
            stats[key] = stats.get(key, 0.0) + dt

    def _wave_budget(self, task0: Task) -> Tuple[Optional[int], bool]:
        """The per-device wave working-set budget the split and the
        prefetch clip hold estimates against (reference
        exec/meshexec.py:2160-2176): the static ``device_budget_bytes``
        when set (an explicit knob wins), else the adaptive cost
        policy's measured ``hbm_budget()`` × headroom. Returns
        ``(budget, adaptive)``; ``adaptive`` marks a measured budget."""
        if self.device_budget_bytes:
            return self.device_budget_bytes, False
        planner = self.adaptive
        if planner is not None and not self.multiprocess:
            # A measured budget differs on each rank: over ranks only
            # the static knob splits a wave.
            b = planner.cost_wave_budget(_op_base(task0.name.op),
                                         inv=task0.name.inv_index)
            if b:
                return b, True
        return None, False

    def _adaptive_skew_split(self, tasks: List[Task], wave: int, inputs):
        """The skew policy's wave-boundary consult (reference
        exec/meshexec.py:2178-2197): a skew-flagged producer op in the
        wave's deps runs the wave as K row slices through
        ``_execute_wave_sliced``, whose merge equals the unsplit wave's.
        None runs it unsplit. The budget split's preconditions: one
        input, no subid, a row-local chain ending in a shuffle."""
        planner = self.adaptive
        task0 = tasks[0]
        if (planner is None or self.multiprocess
                or task0.num_partition <= 1
                or len(inputs) != 1 or inputs[0].subid
                or not self._splittable_chain(task0)):
            return None
        K = planner.skew_split_k(
            [d.tasks[0].name.op for d in task0.deps], inputs[0].capacity,
            inv=task0.name.inv_index)
        if K <= 1:
            return None
        return self._execute_wave_sliced(tasks, wave, inputs, K)

    def _effective_prefetch_depth(self, task0: Task, inputs,
                                  nwaves: int) -> int:
        """The depth this group runs at: the knob, clipped so that
        (1 + depth) wave working sets fit the wave budget — prefetch must
        not bust the budget the wave split enforces."""
        depth = min(self.prefetch_depth, nwaves - 1)
        if depth <= 0:
            return 0
        budget, adaptive = self._wave_budget(task0)
        if budget:
            est = self._wave_bytes_estimate(task0, inputs)
            depth0 = depth
            while depth > 0 and (1 + depth) * est > budget:
                depth -= 1
            if adaptive and depth < depth0:
                self.adaptive.note_cost_action(
                    "prefetch_clip", _op_base(task0.name.op),
                    inv=task0.name.inv_index, depth=depth,
                    configured=depth0, budget_bytes=budget)
        return depth

    def _execute_waves(self, task0: Task, wave_tasks: List[List[Task]],
                       inputs0=None, sink=None) -> List[DeviceGroupOutput]:
        """Run a waved group, serially (depth 0) or through the pipeline.
        Wave 0 stages on this thread either way (the depth decision needs
        its size), unless the shuffle planner staged it already
        (``inputs0``). ``sink``, when given, receives each settled wave's
        output in wave order instead of the returned list (then [])."""
        if inputs0 is None:
            inputs0 = self._stage_exposed(wave_tasks[0], 0)
        depth = self._effective_prefetch_depth(task0, inputs0,
                                               len(wave_tasks))
        if depth > 0:
            return self._execute_waves_pipelined(task0, wave_tasks, inputs0,
                                                 depth, sink)
        outs: List[DeviceGroupOutput] = []
        for w in range(len(wave_tasks)):
            if w:
                # Between-waves cancellation (reference
                # exec/meshexec.py:2254-2257).
                self._check_cancel()
            # Wave 0's inputs are handed on, not held across the loop.
            inputs, inputs0 = inputs0, None
            out = self._execute_wave(wave_tasks[w], w, inputs)
            del inputs
            if sink is not None:
                sink(w, out)
            else:
                outs.append(out)
        return outs

    def _execute_waves_pipelined(self, task0: Task,
                                 wave_tasks: List[List[Task]], inputs0,
                                 depth: int, sink=None
                                 ) -> List[DeviceGroupOutput]:
        """The pipelined loop: a prefetcher thread stages waves
        1..n-1 (``depth`` ahead, through a bounded queue) while earlier
        waves compute, and on ``cuda`` up to ``depth`` dispatched waves
        stay in flight before their signals are read back. Every
        dispatch and settle stays on this thread, in wave order. A
        staging error re-raises here in wave order, never as a switch to
        the serial loop. On ``cpu`` the window is 0: each wave settles
        right after its dispatch (the program runs eagerly), and staging
        overlaps the next wave's compute."""
        nwaves = len(wave_tasks)
        staged: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
        stop = threading.Event()

        def stage():
            for w in range(1, nwaves):
                if stop.is_set():
                    return
                try:
                    t0 = time.perf_counter()
                    # Read-ahead hints stay just ahead of staging (the
                    # store's warm cache is small).
                    self._hint_store_prefetch(wave_tasks, w + 1,
                                              w + 1 + depth)
                    with self._staging_breakdown() as stats:
                        item = (self._group_inputs(wave_tasks[w], w), None,
                                time.perf_counter() - t0, stats)
                    self._emit_phase(task0, PHASE_WAVE_PREFETCH, w)
                except BaseException as e:  # noqa: BLE001 — re-raised in
                    # wave order on the group thread
                    item = (None, e, 0.0, None)
                while not stop.is_set():
                    try:
                        staged.put(item, timeout=0.1)
                        break
                    except queue_mod.Full:
                        continue
                if item[1] is not None:
                    return

        stager = threading.Thread(target=stage, daemon=True,
                                  name="meshwave-prefetch")
        stager.start()
        window = depth if self.device.type == "cuda" else 0
        outs: List[DeviceGroupOutput] = []
        inflight: deque = deque()

        def deliver(w: int, out: DeviceGroupOutput, t_disp: float) -> None:
            # Outside the wave mutex: a sink's host work (the spill
            # writes) must not hold the wave slot.
            if sink is not None:
                sink(w, out)
            else:
                outs.append(out)
            # Dispatch to settle: with waves in flight this counts queue
            # time too, but the sum is the window staging hides behind.
            self._telemetry_compute(task0, w, time.perf_counter() - t_disp)

        try:
            inputs = inputs0
            for w in range(nwaves):
                if w:
                    # Between-waves cancellation (reference
                    # exec/meshexec.py:2362-2364): the finally below
                    # stops the stager; staged waves already returned
                    # their arena buffers behind their copies' events.
                    self._check_cancel()
                    t0 = time.perf_counter()
                    inputs, err, staged_s, stats = staged.get()
                    if err is not None:
                        raise err
                    # Exposed: what this thread sat waiting for of the
                    # stager's work; the rest was hidden behind compute.
                    self._note_staging(
                        task0, w, staged_s,
                        min(time.perf_counter() - t0, staged_s), stats)
                self._emit_phase(task0, PHASE_WAVE_COMPUTE, w)
                settled = []
                with self._wave_mutex:
                    inflight.append((self._dispatch_wave(wave_tasks[w], w,
                                                         inputs),
                                     time.perf_counter()))
                    inputs = None
                    while len(inflight) > window:
                        e, t_disp = inflight.popleft()
                        settled.append((e.wave, self._settle_wave(e),
                                        t_disp))
                for s in settled:
                    deliver(*s)
                del settled
            while inflight:
                with self._wave_mutex:
                    e, t_disp = inflight.popleft()
                    s = (e.wave, self._settle_wave(e), t_disp)
                deliver(*s)
            return outs
        finally:
            stop.set()
            while True:  # drain, so that a parked put() never wedges
                try:
                    staged.get_nowait()
                except queue_mod.Empty:
                    break
            stager.join()

    def _hint_store_prefetch(self, wave_tasks: List[List[Task]],
                             lo: int, hi: int) -> None:
        """Advisory read-ahead for waves [lo, hi)'s store-resident dep
        partitions: a spilled boundary's partitions warm in the spill
        store's cache while earlier waves compute; other store tiers
        here hold frames in memory and ignore the hint."""
        for wt in wave_tasks[lo:hi]:
            for t in wt:
                for dep in t.deps:
                    for p in dep.tasks:
                        spilled = self._spilled_output_for(p.name)
                        if spilled is not None:
                            if p.name.shard == 0:
                                spilled.exchange.prefetch(dep.partition)
                        elif not self._has_device_output(p.name):
                            self.store.prefetch(p.name, dep.partition)

    def _spilled_output_for(self, name: TaskName):
        """The SpilledGroupOutput serving ``name``'s group, or None."""
        with self._lock:
            entry = self._task_index.get(name)
            out = self._outputs.get(entry[0]) if entry is not None else None
        return out if isinstance(out, shuffleplan.SpilledGroupOutput) \
            else None

    def _execute_wave(self, tasks: List[Task], wave: int,
                      inputs=None) -> DeviceGroupOutput:
        """One wave, dispatched and settled at once (the serial path)."""
        if inputs is None:
            inputs = self._stage_exposed(tasks, wave)
        t_run = time.perf_counter()
        with self._wave_mutex:
            out = self._settle_wave(self._dispatch_wave(tasks, wave, inputs))
        self._telemetry_compute(tasks[0], wave, time.perf_counter() - t_run)
        return out

    def _await_inputs(self, inputs) -> None:
        """Order the wave program after its inputs' copies: the current
        (compute) stream waits on each staged input's event, and each
        tensor the copy stream allocated records the compute stream, so
        that the caching allocator does not hand its block to a later
        copy while this wave may still read it."""
        if self.device.type != "cuda":
            return
        compute = torch.cuda.current_stream(self.device)
        for i in inputs:
            if i.ready is not None:
                compute.wait_event(i.ready)
                for t in list(i.cols) + [i.counts]:
                    t.record_stream(compute)

    def _dispatch_wave(self, tasks: List[Task], wave: int,
                       inputs) -> _WaveEntry:
        """Launch the wave's program without reading its signals; a wave
        over the budget runs its row slices here, settled (each slice is
        a wave of its own). Returns the entry ``_settle_wave`` takes."""
        task0 = tasks[0]
        self._await_inputs(inputs)
        self._maybe_auto_dense(task0, inputs, wave)
        with cuda_kernels.launch_sink(self._launch_sink(task0)):
            budget, adaptive = self._wave_budget(task0)
            if (budget and task0.num_partition > 1 and len(inputs) == 1
                    and not inputs[0].subid
                    and self._splittable_chain(task0)
                    and self._wave_bytes_estimate(task0, inputs) > budget):
                split = self._try_execute_wave_split(tasks, wave, inputs,
                                                     budget)
                if split is not None:
                    if adaptive:
                        opb = _op_base(task0.name.op)
                        self.adaptive.note_cost_action(
                            "wave_split", opb, inv=task0.name.inv_index,
                            k=self.split_runs.get(opb), budget_bytes=budget)
                    return _WaveEntry(tasks, wave, None, done=split)
            split = self._adaptive_skew_split(tasks, wave, inputs)
            if split is not None:
                return _WaveEntry(tasks, wave, None, done=split)
            stages = self._stages_for(task0)
            slack = self._wave_slack(task0)
            result = self._program(task0, stages, slack)(wave, inputs)
            self._telemetry_exchange(task0, wave, inputs, slack)
            first = (result, slack, self._issue_signals(result))
        return _WaveEntry(tasks, wave, inputs, first=first)

    def _issue_signals(self, result):
        """Start reading a program's four signals (overflow, badrange,
        hash overflow, groupby overflow) back to the host, and over ranks
        its output rows too; returns a callable that gives them as ints.
        On ``cuda`` the copy lands in pinned memory behind an event, so
        that reading one wave's signals waits for that wave's work, not
        for a later wave already queued behind it."""
        parts = result[6] if len(result) > 6 else None
        sig = [x.to(torch.int64) for x in result[1:5]]
        if self.multiprocess:
            sig.append(result[0].reshape(-1)[0].to(torch.int64))
        sig = torch.stack(sig)
        if parts is not None:
            # The partitions' row counts (asked for by the telemetry
            # hub) ride the same copy: no read of their own.
            sig = torch.cat([sig, parts.to(torch.int64)])
        if self.device.type != "cuda":
            return sig.tolist
        host = torch.empty(sig.shape[0], dtype=torch.int64,
                           pin_memory=True)
        host.copy_(sig, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def read():
            done.synchronize()
            return host.tolist()

        return read

    def _settle_wave(self, entry: _WaveEntry) -> DeviceGroupOutput:
        """Read the dispatched wave's signals and run the ladder (a rerun
        reuses the inputs the entry kept alive), then donate the wave's
        owned inputs."""
        if entry.done is not None:
            return entry.done
        task0 = entry.tasks[0]
        try:
            with cuda_kernels.launch_sink(self._launch_sink(task0)):
                out = self._execute_wave_on(entry.tasks, entry.wave,
                                            entry.inputs, first=entry.first)
            if self.donate_buffers:
                self._telemetry_donation(task0, entry.inputs, out)
            return out
        finally:
            entry.inputs = entry.first = None

    def _execute_wave_on(self, tasks: List[Task], wave: int,
                         inputs, first=None, carry=None) -> DeviceGroupOutput:
        task0 = tasks[0]
        opbase = _op_base(task0.name.op)
        stages = self._stages_for(task0)
        has_shuffle = any(kind == "shuffle" for kind, _ in stages)
        with self._wave_mutex:
            while True:
                if first is not None:
                    # A dispatched attempt: read ITS signals; the loop
                    # reruns only on the ladder's retries.
                    result, slack, signals = first
                    first = None
                else:
                    slack = self._wave_slack(task0)
                    result = self._program(task0, stages, slack)(
                        wave, inputs, carry)
                    signals = self._issue_signals(result)
                out_counts, out_cols = result[0], result[5]
                sig = signals()
                nsig = 4
                if self.multiprocess:
                    # Every rank decides from the same numbers: the
                    # signals and partition rows summed, the output rows
                    # at their largest (the JAX package's psums).
                    every = self.mesh.all_gather(sig)
                    sig = [sum(v) for v in zip(*every)]
                    rows_max = max(r[4] for r in every)
                    nsig = 5
                overflow, badrange, hashov, gbover = sig[:4]
                part_rows = sig[nsig:] or None
                if gbover > 0:
                    # A strict GroupByKey's capacity overflow: a user
                    # error on its own channel, never a slack or hash
                    # retry.
                    raise ValueError(
                        f"groupbykey: group(s) exceed the declared capacity "
                        f"by up to {gbover} rows in group {task0.name.op} "
                        f"(on_overflow='error'); raise capacity or use "
                        f"Cogroup for discovered capacities")
                if badrange > 0:
                    auto = self._declared_auto(task0)
                    if auto is not None:
                        # The probe was wrong (a later wave holds keys
                        # wave 0 never showed): retract, keep the site
                        # (and the probing site) off for good, rerun the
                        # whole group.
                        auto.retract_dense()
                        auto._auto_declared = False
                        with self._lock:
                            self._auto_dense_off.add(opbase)
                            if auto._auto_site:
                                self._auto_dense_off.add(auto._auto_site)
                        self._forget_selection(opbase, auto._auto_site)
                        raise _AutoDenseRetry()
                    # A user error, not skew: no slack retry.
                    raise ValueError(
                        f"partitioner returned ids outside "
                        f"[0, {task0.num_partition}), or keys outside the "
                        f"declared dense_keys range, in group "
                        f"{task0.name.op}")
                if hashov > 0:
                    # The hash table could not place every row: discard
                    # the result and rerun the wave with this op on the
                    # sort path for good.
                    with self._lock:
                        self._hash_off.add(opbase)
                    self._forget_selection(opbase)
                    continue
                if not has_shuffle or overflow == 0:
                    break
                # slack == ndest makes overflow impossible: a source
                # sends at most its capacity to one destination lane.
                full_slack = float(max(2, min(task0.num_partition,
                                              self.nmesh)))
                if slack >= full_slack:
                    raise RuntimeError(
                        f"shuffle overflow in group {task0.name.op} even at "
                        f"full slack")
                self._slack_memo[opbase] = min(slack * 4, full_slack)
        out_cols = list(out_cols)
        if self.multiprocess:
            cap = bucket_size(rows_max)
            if int(out_cols[0].shape[0]) < cap:
                # One capacity on every rank: a consumer's exchange sizes
                # its buckets from it.
                out_cols = [torch.cat([c, c.new_zeros(
                    (cap - c.shape[0],) + tuple(c.shape[1:]))])
                    for c in out_cols]
        out = DeviceGroupOutput(
            out_cols, out_counts, int(out_cols[0].shape[0]), task0.schema,
            partitioned=task0.num_partition > 1,
            subid=has_shuffle and task0.num_partition > self.nmesh,
            nmesh=self.nmesh,
        )
        out.part_rows = part_rows
        return out

    # -- the device-budget wave split ---------------------------------------

    def _splittable_chain(self, task0: Task) -> bool:
        """Row-slicing a shard is sound only for chains whose stages are
        row-local up to the final shuffle: map/filter/flatmap transform
        rows one by one, and the shuffle's map-side combiner may emit
        per-slice partials because its consumer re-combines
        contributions. Head, a mid-chain Reduce or Fold, a join or a
        group-by would compute per-slice answers no consumer reconciles
        (a fold's partials, above all: its fn need not be associative,
        so nothing could combine them)."""
        stages = self._stages_for(task0)
        if not stages or stages[-1][0] != "shuffle":
            return False
        return all(k in ("map", "filter", "flatmap") for k, _ in stages[:-1])

    def _wave_bytes_estimate(self, task0: Task, inputs) -> int:
        """Coarse working-set model of one wave (``wave_bytes_model``)
        from its staged inputs and stages. It only picks WHEN to split
        and into how many slices."""
        rows = sum(i.capacity for i in inputs)
        rowbytes = sum(c[:1].numel() * c.element_size()
                       for i in inputs for c in i.cols) or 4
        fanout = 1
        hash_table = False
        wide_bytes = 0
        for kind, s in self._stages_for(task0):
            if kind == "flatmap":
                fanout *= s.fanout
            elif kind == "shuffle":
                fc = s.partitioner.combiner
                hash_table = (fc is not None
                              and s.partitioner.partition_fn is None
                              and self._hash_combine_ops(
                                  _op_base(task0.name.op), fc,
                                  decide=False) is not None)
                if hash_table:
                    wide_bytes = _wide_row_bytes(fc.schema.values)
        return self.wave_bytes_model(rows, rowbytes, fanout, hash_table,
                                     self._wave_slack(task0), wide_bytes)

    @staticmethod
    def wave_bytes_model(rows: int, rowbytes: int, fanout: int = 1,
                         hash_table: bool = False,
                         slack: float = 2.0, wide_bytes: int = 0) -> int:
        """Bytes one wave of ``rows`` staged rows of ``rowbytes`` holds on
        the device: the staged rows; the combine + route working set of
        its ``rows * fanout`` rows and, in a split wave, of the running
        merge that rides into its combine (taken as no larger) — with
        the hash combine (``hash_table``), the partition ids and a table
        of one slot a row holding the keys and values, a presence byte
        and a claim word, plus the kernel's bucketed copy of the rows
        and its spill list (K2's wide route, ``wide_bytes`` of vector
        values a row scattered after the kernel: those bytes stay out of
        the bucketed copy, which carries a row index instead, beside each
        row's slot and the scatter's int64 index); else the sort's
        operands and scratch and the ``slack``-scaled receive buffer;
        the rows concatenated with the running merge; and the output, at
        most one row a row, with its subid and the compaction's row
        ids."""
        n = rows * fanout
        m = 2 * n  # the rows and the running merge
        if hash_table:
            copy = rowbytes - wide_bytes + (16 if wide_bytes else 0)
            work = m * (4 + 1 + rowbytes + 4 + copy + 8)
        else:
            work = int(m * rowbytes * (2 + slack))
        out = n * (rowbytes + 4 + 8)
        return int(rows * rowbytes + work + m * rowbytes + out)

    def _try_execute_wave_split(self, tasks: List[Task], wave: int,
                                inputs, budget: int):
        """Run the wave as K row slices of its single dep, each under
        the budget. None when the capacity does not split exactly."""
        cap = inputs[0].capacity
        est = self._wave_bytes_estimate(tasks[0], inputs)
        want = (est + budget - 1) // budget
        K = 1
        while K < want:
            K <<= 1
        K = min(K, cap)
        while K > 1 and cap % K:
            K >>= 1  # only exact row slices keep the prefix contract
        if K <= 1:
            return None
        return self._execute_wave_sliced(tasks, wave, inputs, K)

    def _execute_wave_sliced(self, tasks: List[Task], wave: int, inputs,
                             K: int) -> DeviceGroupOutput:
        """Run one wave as K exact row slices of its single dep (K divides
        the capacity), each slice folded into the running merge as it
        runs (``_run_slice``): the consumer's re-combine makes the result
        the unsplit wave's. No slice's output outlives its fold; the
        wave's staged inputs are donated after the last slice."""
        task0 = tasks[0]
        B = inputs[0].capacity // K
        merged = None
        for b in range(K):
            merged = self._run_slice(tasks, wave, self._slice_wave_program(
                inputs[0], b, B), merged)
        with self._lock:
            self.split_runs[_op_base(task0.name.op)] = K
        if self.donate_buffers:
            self._telemetry_donation(task0, inputs, merged)
        return merged

    def _run_slice(self, tasks: List[Task], wave: int, inp: StagedInput,
                   merged: Optional[DeviceGroupOutput]) -> DeviceGroupOutput:
        """One row slice of a split wave, folded into the running merge
        ``merged`` (None before the first); returns the new running
        merge. With a map-side combiner the running merge's rows (one a
        key) join the slice's rows before its combine, so the slice's
        output IS the new running merge, one row a key as the unsplit
        wave's output, however little the slice combines on its own;
        without one, the slice's rows are appended."""
        task0 = tasks[0]
        if merged is None:
            return self._execute_wave_on(tasks, wave, [inp])
        if task0.partitioner.combiner is None:
            sub = self._execute_wave_on(tasks, wave, [inp])
            return self._merge_outputs([merged, sub], task0)
        valid = (torch.arange(merged.capacity, device=self.device)
                 < merged.counts[0])
        carry = (valid, merged.cols[int(merged.subid):])
        return self._execute_wave_on(tasks, wave, [inp], carry=carry)

    @staticmethod
    def _slice_wave_program(inp: StagedInput, b: int, B: int) -> StagedInput:
        """Slice b of a staged input: rows [b*B, (b+1)*B) as views, with
        the valid-prefix count clipped into the slice."""
        start = b * B
        counts = torch.clamp(inp.counts - start, 0, B).to(torch.int32)
        return StagedInput([c[start : start + B] for c in inp.cols], counts,
                           B, False, None)

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

    def _note_cogroup_width(self, opbase: str, G: int) -> None:
        """Record a Cogroup wave's matrix width: the op's capacity is the
        widest, at least ``COGROUP_DEFAULT_CAP`` — the capacity the JAX
        package's ladder reaches, ``bucket_size`` of the largest group
        once that group outgrows the starting one."""
        with self._lock:
            self._cogroup_caps[opbase] = max(
                self._cogroup_caps.get(opbase, COGROUP_DEFAULT_CAP), G)

    @property
    def cogroup_caps(self) -> Dict[str, int]:
        """Op site -> the group capacity its Cogroup's waves needed."""
        with self._lock:
            return dict(self._cogroup_caps)

    def _hash_combine_ops(self, opbase: str, fc, decide: bool = True):
        """The classified ops when the hash lowering serves this combiner,
        None for the sort (or dense) lowering: the combiner's own verdict
        (``FrameCombiner.hash_ops``) unless the op's table overflowed
        before, or a dense bound is declared — the dense table, or where
        it gates itself off the sort path that honours the range check,
        takes precedence.

        A kernel selector (reference exec/meshexec.py:3488-3552) takes
        these gates' verdict as the boundary's eligibility: ``static``
        records it and moves nothing; ``measured`` may send an eligible
        boundary to the sort path where its probe says so, never one the
        gates refuse onto the hash path. The combiner's schema is the
        boundary's: its dtypes name the decision's site.
        ``decide=False`` (the wave size model) reads a standing decision
        and makes none, so that decisions are made where the program
        runs, after wave 0's dense discovery, as in the JAX package."""
        if (not self.hash_aggregate or opbase in self._hash_off
                or fc.dense_keys is not None):
            ops = None
        else:
            ops = fc.hash_ops()
        sel = self.kernel_select
        if sel is None:
            return ops
        schema = fc.schema
        key_dtypes = tuple(_dtype_name(ct.dtype) for ct in schema.key)
        val_dtypes = tuple(_dtype_name(ct.dtype) for ct in schema.values)
        # Boundaries of one op with the same dtypes share a decision.
        site = "k(%s)v(%s)" % (",".join(key_dtypes), ",".join(val_dtypes))
        if not decide:
            kernel = sel.decision(opbase, site)
        else:
            kernel = sel.choose(
                opbase, site, nkeys=len(schema.key),
                nvals=len(schema.values), ops=ops or (),
                key_dtypes=key_dtypes, val_dtypes=val_dtypes,
                hash_eligible=ops is not None,
                dense_bound=fc.dense_keys is not None)
        return None if kernel == "sort" else ops

    def _forget_selection(self, *opbases) -> None:
        """A gate under these ops' lowerings moved (a dense bound was
        retracted, or a hash table overflowed): the selector's cached
        verdicts for them no longer hold, and their reruns decide
        again."""
        if self.kernel_select is not None:
            for opb in opbases:
                if opb:
                    self.kernel_select.forget(opb)

    # -- auto-dense discovery ------------------------------------------------

    def _dense_candidate(self, task0: Task):
        """The declarable object (a FrameCombiner or a Fold) whose key
        column is the staged input's column 0 and which opted into
        discovery, or None. Only mask-level stages (filter, head) may
        precede it: map, flatmap and join rewrite columns, so a probe of
        the staged input would measure the wrong keys."""
        if len(task0.deps) > 1:
            return None
        for kind, s in self._stages_for(task0):
            if kind in ("filter", "head"):
                continue
            if kind == "shuffle":
                part = task0.partitioner
                fc = part.combiner
                if (fc is not None and fc.auto_dense
                        and fc.dense_keys is None
                        and part.partition_fn is None
                        and fc.dense_eligible()):
                    return fc
                return None
            if kind == "combine":
                fc = s.frame_combiner
                if (fc.auto_dense and fc.dense_keys is None
                        and fc.dense_eligible()):
                    return fc
                return None
            if kind == "fold":
                if (s.auto_dense and s.dense_keys is None
                        and s.dense_eligible()):
                    return s
                return None
            return None
        return None

    def _maybe_auto_dense(self, task0: Task, inputs, wave: int) -> None:
        """Wave 0 of a candidate group probes its key range and declares
        the bound dense when the keys are non-negative, ``kmax + 1 <=
        MAX_DENSE_KEYS`` and at most twice the wave's capacity (a table
        far larger than the data beats nothing). Wave 0 only: declaring
        mid-group would mix dense and sort routing across waves; the
        badrange signal and the group retry guard a misprobe."""
        if wave != 0 or not self.auto_dense or inputs[0].subid:
            return
        opb = _op_base(task0.name.op)
        with self._lock:
            if opb in self._auto_dense_off:
                return
        cand = self._dense_candidate(task0)
        if cand is None:
            return
        kmin, kmax = self._key_range(inputs[0])
        k = kmax + 1
        if (kmin >= 0 and 0 < k <= dense_mod.MAX_DENSE_KEYS
                and k <= 2 * inputs[0].capacity
                and cand.try_declare_dense(k)):
            cand._auto_declared = True
            cand._auto_site = opb  # kept off too on a retraction

    def _declared_auto(self, task0: Task):
        """The discovered declaration governing this group's dense
        lowering, if any (for a badrange retraction)."""
        objs = []
        if task0.num_partition > 1 and task0.partitioner.combiner:
            objs.append(task0.partitioner.combiner)
        for s in task0.chain:
            if isinstance(s, Reduce):
                objs.append(s.frame_combiner)
            elif isinstance(s, Fold):
                objs.append(s)
        for o in objs:
            if o._auto_declared and o.dense_keys is not None:
                return o
        return None

    def _key_range(self, inp: StagedInput) -> Tuple[int, int]:
        """(min, max) of the staged key column's valid rows: one
        ``torch.aminmax`` and one readback. The rows are front-packed, so
        row 0 stands in for the invalid tail; an empty wave reads as
        (int32 max, int32 min), which declares nothing."""
        key = inp.cols[0]
        valid = torch.arange(key.shape[0], device=key.device) < inp.counts[0]
        lo, hi = torch.aminmax(torch.where(valid, key, key[0]))
        kmin, kmax, n = torch.stack([lo.to(torch.int64), hi.to(torch.int64),
                                     inp.counts[0].to(torch.int64)]).tolist()
        empty = (torch.iinfo(torch.int32).max, torch.iinfo(torch.int32).min)
        if n == 0:
            kmin, kmax = empty
        if self.multiprocess:
            # The whole wave's range, the same on every rank (the JAX
            # package's pmin/pmax, reference :3593-3675).
            every = self.mesh.all_gather([kmin, kmax])
            kmin = min(r[0] for r in every)
            kmax = max(r[1] for r in every)
        return kmin, kmax

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
        or a Reshard (each reads its shuffled input as it is) or a
        Prefixed (its rows are its input's). A JoinAggregate, the
        innermost slice of its chain, is the first stage; a Cogroup is
        the only one. A SelfAttend, innermost too, is the first stage."""
        kinds = ((Map, "map"), (Flatmap, "flatmap"), (Filter, "filter"),
                 (Head, "head"), (Reduce, "combine"), (Fold, "fold"),
                 (JoinAggregate, "join"), (GroupByKey, "groupby"),
                 (Cogroup, "cogroup"), (SelfAttend, "attend"))
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
        routed by the same hash) and keep the keys present in both. A
        dense-declared join whose consumer shards are the devices, with
        a table in the inputs' league, takes a rank-indexed table a side
        (``dense.make_dense_join``); classified fns over non-float keys
        one shared claim cascade (``hashagg.make_hash_join_align``);
        others two segmented reduces and the tagged-sort alignment
        (``join.make_align``). Returns (mask, cols, bad, hash
        overflow)."""
        fc_a, fc_b = s.frame_combiners
        nk = s.prefix
        cols_a, cols_b = col_sets
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        dk = fc_a.dense_keys
        if (dk is not None and dk == fc_b.dense_keys
                and s.num_shards == self.nmesh
                and dk <= 4 * self.nmesh * (cols_a[0].shape[0]
                                            + cols_b[0].shape[0])):
            djoin = dense_mod.make_dense_join(
                dk, fc_a.dense_ops, fc_b.dense_ops, self.nmesh)
            mask, cols, bad = djoin(masks[0], cols_a, masks[1], cols_b)
            return mask, cols, bad, zero
        jops = self._hash_join_ops(opbase, s)
        if jops is not None:
            align = hashagg.make_hash_join_align(nk, jops[0], jops[1])
            mask, cols, hov = align(masks[0], cols_a, masks[1], cols_b)
            return mask, cols, zero, hov
        sides = []
        for fc, m, cols in ((fc_a, masks[0], cols_a),
                            (fc_b, masks[1], cols_b)):
            core = segment.make_segmented_reduce_masked(
                nk, fc.nvals, segment.canonical_combine(fc.fn, fc.nvals))
            sides.extend(core(m, tuple(cols[:nk]), tuple(cols[nk:])))
        mask, cols = join_mod.make_align(nk, fc_a.nvals, fc_b.nvals)(*sides)
        return mask, cols, zero, zero

    @staticmethod
    def _dense_gate(dk, key_col, mask, badrange):
        """Declared-dense bookkeeping of the combine and fold stages:
        keys outside the bound count into the badrange signal whenever a
        bound is declared (the loud failure must not depend on which
        lowering runs), while the dense table engages only when it stays
        in the input's league (``dk <= 2 * rows``). Returns (the bound to
        use or None, badrange)."""
        if dk is None:
            return None, badrange
        badrange = badrange + (mask & ((key_col < 0) | (key_col >= dk))
                               ).sum().to(torch.int32)
        if dk > 2 * key_col.shape[0]:
            return None, badrange
        return dk, badrange

    def _program(self, task: Task, stages: List[tuple], slack: float):
        """The wave program: ``stepped(wave, inputs, carry=None) ->
        (out_counts,
        overflow, badrange, hashov, gbover, cols)``. Validity rides as a
        bool mask between stages; one final compaction establishes the
        front-packed output contract, in ``bucket_size`` of the surviving
        rows. Each input holds this wave's rows only (a subid output
        reaches a consumer as its wave's view); a join reads two inputs,
        a Cogroup one per input, every other chain one. ``carry``, a
        split wave's running merge (mask, keys and values), joins the
        rows ahead of the shuffle's combine (``_run_slice``). With a
        telemetry hub a shuffle's program also returns its rows a
        partition (``[nparts]``, on the device) as a seventh element;
        the settle reads them with the signals.

        The program is rebuilt on every call (a re-selection or a
        retracted bound takes effect at the op's next wave); with a
        telemetry hub it is accounted in the program cache
        (``_served_program``)."""
        t0 = time.perf_counter()
        if self.kernel_select is not None:
            # Attribution only (reference exec/meshexec.py:3777-3781):
            # instants of decisions made while this program is built and
            # run land in its invocation's section.
            self.kernel_select.current_inv = task.name.inv_index
        opbase = _op_base(task.name.op)
        nmesh = self.nmesh
        device = self.device
        part_counts = self._telemetry_hub() is not None

        def stepped(wave: int, inputs, carry=None):
            masks, col_sets = [], []
            for inp in inputs:
                cols = list(inp.cols)
                size = cols[0].shape[0]
                valid = torch.arange(size, device=device) < inp.counts[0]
                if inp.subid:
                    # A wave-partitioned output read whole: this wave's
                    # rows are those of its own subid.
                    valid = valid & (cols[0] == wave)
                    cols = cols[1:]
                masks.append(valid)
                col_sets.append(cols)
            zero = torch.zeros((), dtype=torch.int32, device=device)
            # A strict GroupByKey's overflow rides a channel of its own
            # (gbover), as does the hash lowerings' (hashov).
            overflow = badrange = hashov = gbover = zero
            parts = None
            run_stages = stages
            if stages and stages[0][0] == "cogroup":
                # The Cogroup is the chain's only stage: its aligner
                # returns the distinct keys' rows already front-packed,
                # at the width its largest group needs (no deficit).
                s = stages[0][1]
                agree = ((lambda g: self.mesh.pmax_host([g])[0])
                         if self.multiprocess else None)
                n, cols, _, G = cogroup_mod.make_cogroup_align(
                    s.prefix, s.nvals, agree=agree)(masks, col_sets)
                self._note_cogroup_width(opbase, G)
                return (n.reshape(1), overflow, badrange, hashov, gbover,
                        tuple(cols))
            if stages and stages[0][0] == "join":
                mask, cols, badrange, hashov = self._join_prelude(
                    opbase, stages[0][1], masks, col_sets)
                run_stages = stages[1:]
            elif stages and stages[0][0] == "attend":
                # Attention over the producer's device output: the
                # count masks padded K columns, and causal positions are
                # logical global rows. Output rows beyond the count are
                # masked by the producer's mask, which carries over.
                cols = [self._attend(opbase, stages[0][1], inputs[0])]
                mask = masks[0]
                run_stages = stages[1:]
            else:
                mask, cols = masks[0], col_sets[0]
            for kind, s in run_stages:
                if kind == "map":
                    cols = s.device_apply(cols)
                elif kind == "flatmap":
                    # Fixed fanout k: [n, k] planes (mask first) flatten
                    # row-major, each row's outputs contiguous.
                    fmask, cols = s.device_apply(cols)
                    mask = (mask[:, None] & fmask).reshape(-1)
                elif kind == "filter":
                    mask = mask & s.device_mask(cols)
                elif kind == "head":
                    # The first n valid rows of the shard, by running
                    # count.
                    rank = torch.cumsum(mask.to(torch.int32), 0,
                                        dtype=torch.int32)
                    mask = mask & (rank <= s.n)
                elif kind == "combine":
                    fc = s.frame_combiner
                    keys, vals = cols[: fc.nkeys], cols[fc.nkeys :]
                    use_dk, badrange = self._dense_gate(
                        fc.dense_keys, cols[0], mask, badrange)
                    hops = self._hash_combine_ops(opbase, fc)
                    if use_dk is not None:
                        core = dense_mod.make_dense_combine(
                            use_dk, fc.dense_ops)
                        mask, keys, vals = core(mask, tuple(keys),
                                                tuple(vals))
                    elif hops is not None:
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
                elif kind == "fold":
                    # This wave holds every row of its keys, in arrival
                    # order: producer wave, then row.
                    nk = s.prefix
                    use_dk, badrange = self._dense_gate(
                        s.dense_keys, cols[0], mask, badrange)
                    if use_dk is not None:
                        core = dense_mod.make_dense_fold(
                            use_dk, s.dense_op, s.acc_dtype, s.init)
                    else:
                        core = segment.make_sequential_fold_masked(
                            nk, len(cols) - nk, s.fn, s.init,
                            torch_dtype(s.acc_dtype))
                    mask, keys, accs = core(mask, tuple(cols[:nk]),
                                            tuple(cols[nk:]))
                    cols = list(keys) + list(accs)
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
                    if carry is not None:
                        cmask, ccols = carry
                        mask = torch.cat([cmask, mask])
                        cols = [torch.cat([cc, c]) for cc, c in
                                zip(ccols, cols)]
                    part = s.partitioner
                    fc = part.combiner
                    pf = part.partition_fn
                    pfn = (pf.device_fn(s.num_partition)
                           if pf is not None else None)
                    # A 2-D mesh routes every shuffle through the
                    # two-stage exchange (parallel/hier.py): the dense
                    # and hash fused lowerings are one flat exchange,
                    # whose buckets would all cross DCN, so they stay
                    # 1-D (reference :4204-4211).
                    hier_on = self.mesh.is_hier
                    hops = (self._hash_combine_ops(opbase, fc)
                            if fc is not None and pf is None
                            and not hier_on else None)
                    dense_k = fc.dense_keys if fc is not None else None
                    if (dense_k is not None and pf is None
                            and fc.nkeys == 1 and not hier_on
                            and s.num_partition == nmesh):
                        # Dense keys: the table combine and the static
                        # routing. It needs one partition a device, so on
                        # one device (where a group of one partition has
                        # no shuffle stage) it waits for the multi-GPU
                        # exchange; until then such shuffles take the
                        # sort path below.
                        body = dense_mod.make_dense_combine_shuffle(
                            nmesh, dense_k, fc.dense_ops)
                        mask, ov, nb, cols = body(mask, *cols)
                        overflow = overflow + ov
                        badrange = badrange + nb
                    elif hops is not None:
                        # Fused hash combine + exchange of table regions.
                        body = hashagg.make_hash_combine_shuffle(
                            nmesh, fc.nkeys, fc.nvals, hops,
                            nparts=s.num_partition,
                        )
                        mask, hov, cols = body(mask, *cols)
                        hashov = hashov + hov
                    elif hier_on:
                        from bigslice_tpu_torch.parallel import hier

                        D, I = self.mesh.ndcn, self.mesh.nici
                        if fc is not None:
                            # The fused sort over ICI, an ICI-stage
                            # combine, then one message a row pair a
                            # lane over DCN.
                            body = hier.make_hier_combine_shuffle_fn(
                                D, I, fc.nkeys, fc.nvals,
                                segment.canonical_combine(fc.fn, fc.nvals),
                                slack=slack, nparts=s.num_partition,
                                partition_fn=pfn)
                        else:
                            body = hier.make_hier_shuffle_fn(
                                D, I, s.schema.prefix, cols[0].shape[0],
                                slack=slack, nparts=s.num_partition,
                                partition_fn=pfn)
                        mask, ov, nb, cols = body(mask, *cols)
                        overflow = overflow + ov
                        badrange = badrange + nb
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
                    if part_counts:
                        parts = self._partition_counts(
                            mask, cols, s.num_partition,
                            planar=hops is not None and dense_k is None)
            if (all(kind == "map" for kind, _ in stages)
                    and not inputs[0].subid):
                # Map-only chain: the mask is untouched (no subid masked
                # it), so the counts carry over.
                return (inputs[0].counts, overflow, badrange, hashov,
                        gbover, tuple(cols))
            out_n, cols = compact_to_bucket(mask, cols)
            return (out_n.reshape(1), overflow, badrange, hashov, gbover,
                    cols, parts)

        return self._served_program(task, stages, slack, stepped,
                                    time.perf_counter() - t0)

    def _attend(self, opbase: str, att: SelfAttend,
                inp: StagedInput) -> torch.Tensor:
        """The attend stage: Ulysses when heads divide the device slots,
        heads > 1 and ``method`` is "ulysses", or "auto" with no
        ``block_q`` (Ulysses has no tiling, and a ``block_q`` bounds the
        score memory); else the ring, its heads on a leading batch axis
        (the JAX package vmaps the ring body over them). The choice is
        recorded in ``attend_methods``. Returns o, [cap, d] fp32."""
        nmesh = self.nmesh
        heads = att.heads
        hd = att.d // heads
        count0 = inp.counts[0:1]
        q, k, v = inp.cols
        cap0 = q.shape[0]
        use_ulysses = (heads % nmesh == 0 and heads > 1
                       and (att.method == "ulysses"
                            or (att.method == "auto" and att.block_q == 0)))
        with self._lock:
            self.attend_methods[opbase] = ("ulysses" if use_ulysses
                                           else "ring")
        if use_ulysses:
            body = ulysses.masked_local_body(
                nmesh, heads, hd, causal=att.causal, dtype=att.dtype)
            qh, kh, vh = (c.reshape(cap0, heads, hd) for c in (q, k, v))
            return body(count0, qh, kh, vh).reshape(cap0, att.d)
        body = ringattention.masked_local_body(
            nmesh, hd, causal=att.causal, dtype=att.dtype,
            block_q=att.block_q)
        qh, kh, vh = (c.reshape(cap0, heads, hd).transpose(0, 1)
                      for c in (q, k, v))
        o = body(count0, qh, kh, vh)                  # [heads, cap, hd]
        return o.transpose(0, 1).reshape(cap0, att.d)

    # -- the program cache (serve/programcache.py) --------------------------

    def _served_program(self, task: Task, stages: List[tuple], slack: float,
                        stepped, build_s: float):
        """Account ``stepped`` in the program cache (reference
        :3803-3821, :4360-4401): look its session key up in the
        executor's table (the stage functions' ids, guarded by weakrefs
        against recycled ids), making an entry with the program's
        cross-session digest on a miss, and return a callable that
        probes the process-wide tier once per argument signature (the
        wave inputs' shapes and dtypes) and counts every later call as a
        session-local hit. Without a hub, ``stepped`` itself."""
        dev = self._device_telemetry()
        if dev is None:
            return stepped
        fns = self._stage_fns(stages)
        struct = self._stage_struct(stages)
        engaged = self._op_hash_engaged(task, stages)
        token = (self.kernel_select.token(_op_base(task.name.op))
                 if self.kernel_select is not None else None)
        ncols = self._input_ncols(task)
        key = (struct, tuple(id(f) for f in fns), task.num_partition,
               len(task.schema), ncols, slack, engaged, token)
        with self._lock:
            cached = self._programs.get(key)
        if cached is not None:
            entry, refs = cached
            if not (len(refs) == len(fns) and all(
                    r is None or r() is f for r, f in zip(refs, fns))):
                cached = None
        if cached is None:
            # The serve digest's parts (reference :4373-4387): the
            # structural key under the device signature and partition
            # config, the stage functions by content, and the serve-only
            # extras.
            key_parts = (getattr(task, "partition_config", None),
                         (tuple(kind for kind, _ in stages),
                          task.num_partition, ncols, slack,
                          self.donate_buffers))
            extra = ((struct,
                      tuple((str(ct.dtype), tuple(ct.shape))
                            for ct in task.schema),
                      len(task.schema), engaged)
                     + ((token,) if token is not None else ()))
            entry = _ProgramEntry(
                devicetelemetry.serve_key(task.name.op, "group", key_parts,
                                          fns, extra),
                ("group", key_parts, extra), build_s)
            refs = []
            for f in fns:
                try:
                    refs.append(weakref.ref(f))
                except TypeError:  # an unweakrefable callable
                    refs.append(None)
            with self._lock:
                self._programs[key] = (entry, tuple(refs))
                while len(self._programs) > _PROGRAM_CACHE_MAX:
                    self._programs.pop(next(iter(self._programs)))
        op, inv = task.name.op, task.name.inv_index
        dtype = self.device.type

        def run(wave: int, inputs, carry=None):
            sig = (dtype,) + tuple(
                (inp.subid, tuple((str(c.dtype), tuple(c.shape))
                                  for c in inp.cols))
                for inp in inputs)
            if carry is not None:
                sig += (("carry",) + tuple(tuple(c.shape)
                                           for c in carry[1]),)
            with self._lock:
                fresh = sig not in entry.sigs
                entry.sigs.add(sig)
            try:
                if fresh:
                    dev.probe_program(op, inv, "group", entry.serve_key,
                                      sig, entry.spec, entry.build_s)
                else:
                    dev.record_program(op, inv, "group", "hit")
            except Exception:  # noqa: BLE001 — telemetry never fails a run
                pass
            return stepped(wave, inputs, carry)

        return run

    @staticmethod
    def _stage_struct(stages) -> tuple:
        """Repr-stable stage descriptors for the cross-session program
        key (reference :4405-4456): the stages with every function
        removed, since ``_stage_fns`` fingerprints those by content, so
        that two sessions whose pipelines differ only in function
        objects share a key while any structural knob the program
        branches on (dense key spaces, prefixes, capacities, shard
        counts) still splits it."""
        out = []
        for kind, s in stages:
            if kind == "map":
                out.append((kind, len(s.args)))
            elif kind == "flatmap":
                out.append((kind, s.fanout))
            elif kind == "filter":
                out.append((kind,))
            elif kind == "head":
                out.append((kind, s.n))
            elif kind == "groupby":
                out.append((kind, s.prefix, s.capacity, s.on_overflow))
            elif kind == "cogroup":
                out.append((kind, s.prefix, s.nvals))
            elif kind == "attend":
                out.append((kind, (s.d, s.causal, str(s.dtype), s.block_q,
                                   s.heads, s.method)))
            elif kind == "combine":
                fc = s.frame_combiner
                out.append((kind, fc.nkeys, fc.nvals, fc.dense_keys))
            elif kind == "fold":
                out.append((kind, s.prefix, repr(s.init), str(s.acc_dtype),
                            s.dense_keys))
            elif kind == "join":
                fa, fb = s.frame_combiners
                out.append((kind, s.prefix, fa.nkeys, fa.nvals, fb.nvals,
                            fa.dense_keys, fb.dense_keys, s.num_shards))
            else:  # shuffle
                fc = s.partitioner.combiner
                out.append((kind, s.schema.prefix, fc is not None,
                            s.partitioner.partition_fn is not None,
                            s.num_partition,
                            fc.dense_keys if fc is not None else None,
                            fc.nkeys if fc is not None else None,
                            fc.nvals if fc is not None else None))
        return tuple(out)

    @staticmethod
    def _stage_fns(stages) -> list:
        """The user functions a wave program closes over, in stage order
        (reference :4458-4479)."""
        fns = []
        for kind, s in stages:
            if kind in ("map", "flatmap", "fold"):
                fns.append(s.fn)
            elif kind == "filter":
                fns.append(s.pred)
            elif kind == "combine":
                fns.append(s.frame_combiner.fn)
            elif kind == "join":
                fns.extend(fc.fn for fc in s.frame_combiners)
            elif kind == "shuffle":
                fc = s.partitioner.combiner
                if fc is not None:
                    fns.append(fc.fn)
                pf = s.partitioner.partition_fn
                if pf is not None:
                    fns.append(getattr(pf, "fn", pf))
        return fns

    @staticmethod
    def _input_ncols(task: Task) -> Tuple[int, ...]:
        """Per-input column counts (one entry a dep; one for a
        source)."""
        innermost = task.chain[-1]
        deps = innermost.deps()
        if deps:
            return tuple(len(d.slice.schema) for d in deps)
        return (len(innermost.schema),)

    def _op_hash_engaged(self, task: Task, stages) -> bool:
        """Would a stage of this op's program take a hash lowering now
        (reference :3565-3584)? The gates are the program's own: the
        combine stage's, the shuffle's with a combiner and no partition
        function, the join's."""
        opbase = _op_base(task.name.op)
        for kind, s in stages:
            if kind == "combine":
                if self._hash_combine_ops(opbase,
                                          s.frame_combiner) is not None:
                    return True
            elif kind == "shuffle":
                fc = s.partitioner.combiner
                if (fc is not None and s.partitioner.partition_fn is None
                        and self._hash_combine_ops(opbase, fc) is not None):
                    return True
            elif kind == "join":
                if self._hash_join_ops(opbase, s) is not None:
                    return True
        return False

    def _partition_counts(self, mask, cols, nparts: int,
                          planar: bool = False) -> torch.Tensor:
        """A shuffle's valid rows a partition, on the device (no host
        read): this slot holds partitions ``p % nmesh == slot``, the
        w-th of them with subid w (the leading column when partitions
        outnumber the slots), so its counts land at ``w * nmesh + slot``
        and the rest stay 0 for the other ranks' terms (the settle sums
        them). The hash lowering's output is planar (from each source
        slot, W regions of equal size, in subid order), so its counts
        are one sum a region; otherwise one masked count a subid for a
        few subids, and a scatter-add for many."""
        N = self.nmesh
        W = max(1, (nparts + N - 1) // N)
        if W == 1:
            per = mask.sum().reshape(1)
        elif planar:
            per = mask.reshape(-1, W, mask.shape[0] // (N * W)
                               ).sum((0, 2))
        else:
            sub = cols[0]
            if W <= _FEW_SUBIDS:
                per = torch.stack([(mask & (sub == w)).sum()
                                   for w in range(W)])
            else:
                per = torch.zeros(W, dtype=torch.int64, device=mask.device)
                per.index_add_(0, sub.to(torch.int64).clamp(0, W - 1),
                               mask.to(torch.int64))
        if N == 1:
            return per[:nparts]
        full = torch.zeros((W, N), dtype=torch.int64, device=mask.device)
        full[:, self.slot] = per.to(torch.int64)
        return full.reshape(-1)[:nparts]

    # -- cross-wave merge and the consumer-side subid split ----------------

    def _merge_outputs(self, outs: List[DeviceGroupOutput],
                       task0: Task) -> DeviceGroupOutput:
        """Merge partitioned outputs (the waves', or a split wave's
        slices') into one: this slot's valid rows of every output in
        order, front-packed into ``bucket_size`` of the largest slot's
        total; consumers treat the merged rows as multiple producer
        contributions and re-combine them.

        Machine-combined producers (a ``combine_key`` with a device
        combiner, scalar columns) also re-combine across the outputs
        here, as the JAX package's merge does (reference
        exec/meshexec.py:2897-2933): the merged partition holds at most
        one row per (subid, key) before any consumer reads it."""
        if len(outs) == 1:
            return outs[0]
        counts = [int(o.counts[0]) for o in outs]
        total = sum(counts)
        # The largest slot's total: one capacity on every rank.
        cap = bucket_size(self.mesh.pmax_host([total])[0])
        packed = []
        for j in range(len(outs[0].cols)):
            c0 = outs[0].cols[j]
            buf = c0.new_zeros((cap,) + tuple(c0.shape[1:]))
            pos = 0
            for o, n in zip(outs, counts):
                buf[pos : pos + n] = o.cols[j][:n]
                pos += n
            packed.append(buf)
        fc = task0.partitioner.combiner
        if (task0.partitioner.combine_key and fc is not None
                and getattr(fc, "device", False)
                and all(ct.shape == () for ct in task0.schema)):
            # The subid, when present, leads as one more key: rows of
            # different wave partitions never merge.
            nk = fc.nkeys + (1 if outs[0].subid else 0)
            core = segment.make_segmented_reduce_masked(
                nk, fc.nvals, segment.canonical_combine(fc.fn, fc.nvals))
            mask = torch.arange(cap, device=packed[0].device) < total
            mask, keys, vals = core(mask, tuple(packed[:nk]),
                                    tuple(packed[nk:]))
            n, packed = segment.compact_by_mask(mask,
                                                list(keys) + list(vals))
            packed = list(packed)
            total = int(n)
        merged = DeviceGroupOutput(
            packed, torch.tensor([total], dtype=torch.int32,
                                 device=self.device),
            cap, task0.schema, partitioned=True, subid=outs[0].subid,
            nmesh=self.nmesh,
        )
        if all(o.part_rows is not None for o in outs):
            merged.part_rows = [sum(r) for r in
                                zip(*(o.part_rows for o in outs))]
        return merged

    def _subid_wave_view(self, out: DeviceGroupOutput, task0: Task,
                         wave: int) -> DeviceGroupOutput:
        """Consumer wave ``wave``'s compacted view of a wave-partitioned
        output, so that wave w processes only its own partition's rows.
        The views are built once per output for all W waves; when that
        split declines (its W views over the wave budget), each wave's
        view is built alone as it stages, so the device holds one view
        at a time and the wave's program runs over its own rows only."""
        W = (task0.name.num_shard + self.nmesh - 1) // self.nmesh
        with out._views_lock:
            if out._wave_views is None or out._wave_views[0] != W:
                out._wave_views = (W, self._build_wave_views(out, W))
            views = out._wave_views[1]
        if views is None:
            return self._wave_view(out, wave)
        return views[wave]

    def _build_wave_views(self, out: DeviceGroupOutput,
                          W: int) -> Optional[List[DeviceGroupOutput]]:
        valid = torch.arange(out.capacity, device=self.device) < out.counts[0]
        subid = out.cols[0]
        # The views' capacity is the observed largest subid: the counts
        # ARE the data, so no overflow ladder is needed.
        per = torch.bincount(subid[valid].to(torch.int64), minlength=W)
        capr = bucket_size(int(per.max()) if per.numel() else 1)
        budget = self.device_budget_bytes
        if budget:
            # Skewed subids push capr toward the whole output, so W views
            # (and the split's scratch) could double W-fold the device
            # residency: under a budget that does not hold them,
            # decline (cached).
            rowbytes = sum(c[:1].numel() * c.element_size()
                           for c in out.cols[1:]) or 4
            if 2 * W * capr * rowbytes > budget:
                return None
        return [self._wave_view(out, w, capr) for w in range(W)]

    def _wave_view(self, out: DeviceGroupOutput, w: int,
                   capr: Optional[int] = None) -> DeviceGroupOutput:
        """Partition ``w``'s rows of a subid output, front-packed into
        ``capr`` rows (default: ``bucket_size`` of their count)."""
        valid = torch.arange(out.capacity, device=self.device) < out.counts[0]
        idx = torch.nonzero(valid & (out.cols[0] == w)).squeeze(1)
        k = idx.shape[0]
        if capr is None:
            capr = bucket_size(k)
        cols_w = []
        for c in out.cols[1:]:
            buf = c.new_zeros((capr,) + tuple(c.shape[1:]))
            buf[:k] = take(c, idx)
            cols_w.append(buf)
        return DeviceGroupOutput(
            cols_w, torch.full((1,), k, dtype=torch.int32, device=self.device),
            capr, out.schema, partitioned=True, subid=False,
            nmesh=self.nmesh,
        )

    # -- staging ------------------------------------------------------------

    def _group_inputs(self, tasks: List[Task], wave: int = 0
                      ) -> List[StagedInput]:
        """One ``StagedInput`` per dep, or one upload of the innermost
        source's shards. Called from the prefetcher thread as well as the
        group thread: it reads executor state and issues copies, nothing
        else. Inside ``_staging_breakdown`` its parts are timed."""
        task0 = tasks[0]
        if not task0.deps:
            t0 = time.perf_counter()
            with codec_mod.decode_clock() as ck:
                shard_lists = [
                    [f for f in t.chain[-1].reader(t.name.shard, [])
                     if len(f)]
                    for t in tasks
                ]
            self._stage_stat("decode_s", ck.seconds)
            self._stage_stat("read_s",
                             max(0.0, time.perf_counter() - t0 - ck.seconds))
            return [self._stage_upload(shard_lists, task0.chain[-1].schema)]
        return [self._dep_input(tasks, i, wave)
                for i in range(len(task0.deps))]

    def _dep_input(self, tasks: List[Task], dep_idx: int,
                   wave: int = 0) -> StagedInput:
        """One dep's staged input: a device-resident producer output is
        chained zero-copy (never owned); a store-resident one (a spilled
        boundary's partitions, a result plane kept on the host) is read
        shard by shard and staged through the arena. The attend stage
        reads only the former (``_AttendHostFallback`` otherwise)."""
        task0 = tasks[0]
        dep0 = task0.deps[dep_idx]
        with self._lock:
            out = self._outputs.get(dep0.tasks[0].group_key)
        if isinstance(task0.chain[-1], SelfAttend):
            # The broadcast dep's device layout is the producer's
            # unpartitioned, unwaved output, read aligned and zero-copy
            # (device s holds sequence block s). Anything else (a
            # host-tier producer) has no layout the stage can read: the
            # group runs the host tier's broadcast reader instead.
            if (isinstance(out, DeviceGroupOutput) and not out.partitioned
                    and out.cols is not None and out.nmesh == self.nmesh):
                return StagedInput(out.cols, out.counts, out.capacity,
                                   False, None)
            raise _AttendHostFallback(str(task0.name))
        if isinstance(out, shuffleplan.SpilledGroupOutput) or (
                isinstance(out, DeviceGroupOutput) and out.cols is None):
            # Nothing on the device (spilled, or salvaged to the host by
            # a resize): read through the bridge.
            out = None
        if isinstance(out, WavedGroupOutput):
            wout = out.waves[wave] if len(dep0.tasks) == 1 else None
            if wout is not None and wout.cols is not None:
                # Aligned dep on a waved producer: consumer wave w
                # aligns with producer wave w.
                return StagedInput(wout.cols, wout.counts, wout.capacity,
                                   False, None)
            out = None
        if out is not None and out.partitioned:
            # Device-resident shuffle output: partition p on device
            # p % nmesh. A subid output (more partitions than devices)
            # reaches each consumer wave as its partition's view, or
            # with the subid split off whole, for the program to mask.
            if out.subid and (not self.subid_split or self.multiprocess):
                # Over ranks the split's view capacities would differ by
                # rank (reference :3242-3245): the program masks.
                return StagedInput(out.cols, out.counts, out.capacity,
                                   False, None, subid=True)
            if out.subid:
                out = self._subid_wave_view(out, task0, wave)
            return StagedInput(out.cols, out.counts, out.capacity, False,
                               None)
        if out is not None and len(dep0.tasks) == 1:
            return StagedInput(out.cols, out.counts, out.capacity, False,
                               None)
        if dep0.combine_key:
            return self._machine_buffers_input(tasks, dep_idx)

        # Store-resident dep: each shard's frames, the shards' reads
        # fanned out on the staging pool; a decode clock a shard splits
        # reading from decoding.
        def read_shard(t: Task) -> Tuple[List[Frame], float]:
            dep = t.deps[dep_idx]
            frames: List[Frame] = []
            with codec_mod.decode_clock() as ck:
                for p in dep.tasks:
                    try:
                        frames.extend(self.store.read(p.name,
                                                      dep.partition))
                    except store_mod.Missing as e:
                        if getattr(e, "spilled_group", False):
                            # A spilled partition holds every producer
                            # shard's rows: the whole group re-runs.
                            raise DepLost(*dep.tasks) from e
                        raise DepLost(p) from e
            return frames, ck.seconds

        t0 = time.perf_counter()
        results = staging.map_shards(read_shard, tasks, self.stage_threads)
        elapsed = time.perf_counter() - t0
        # The shards' decode clocks overlap on the pool: capped at the
        # wall time, so the parts stay within the staging.
        decode_s = min(sum(r[1] for r in results), elapsed)
        self._stage_stat("decode_s", decode_s)
        self._stage_stat("read_s", max(0.0, elapsed - decode_s))
        return self._stage_upload([r[0] for r in results],
                                  dep0.tasks[0].schema)

    def _machine_buffers_input(self, tasks: List[Task],
                               dep_idx: int) -> StagedInput:
        """A machine-combined dep whose producers ran on the host tier:
        their own store entries are empty by design, so each consumer
        shard stages the committed machine buffer of its partition. No
        commit means the buffers are gone: the producer group reruns."""
        dep0 = tasks[0].deps[dep_idx]
        ck = dep0.combine_key
        local = self.local
        with local._mc_lock:
            if ck not in local._mc_keys_committed:
                raise DepLost(*dep0.tasks)
            bufs = [local._mc_committed.get((ck, t.deps[dep_idx].partition))
                    for t in tasks]
        per_shard = [[f] if f is not None and len(f) else [] for f in bufs]
        return self._stage_upload(per_shard, dep0.tasks[0].schema)

    def _stage_upload(self, shard_lists, schema) -> StagedInput:
        """Stage per-shard frame lists: assembled once per column into an
        arena buffer, then on ``cuda`` copied with ``non_blocking`` copies
        on the copy stream, behind which an event is recorded (the arena
        recycles the pinned buffers once it completes, and the wave
        program waits on it). On ``cpu`` the assembled buffers are the
        program's inputs. Object columns or dtype drift, and
        ``staging_arena=False``, take ``_upload``.

        A transient failure of the assembly or the upload (the
        ``staging.assemble`` and ``shuffle.upload`` seams, both at entry)
        reruns it with ``fileio``'s bounded backoff over the same host
        data; when the retries run out, the arena gets its buffers back
        before the error propagates."""
        arena = self.staging_arena
        if arena.enabled:
            t0 = time.perf_counter()
            try:
                host_cols, count, capacity, bufs = fileio.retry_transient(
                    lambda: staging.assemble(shard_lists, schema,
                                             self.nmesh, arena, self.slot),
                    "staging.assemble")
            except staging.StagingFallback:
                pass
            else:
                host_counts = arena.acquire(torch.int32, (1,))
                host_counts.fill_(count)
                bufs = bufs + [host_counts]
                t1 = time.perf_counter()
                self._stage_stat("assemble_s", t1 - t0)
                try:
                    placed = fileio.retry_transient(
                        lambda: self._place_assembled(host_cols, host_counts,
                                                      capacity, bufs),
                        "shuffle.upload")
                except BaseException:
                    arena.abandon(bufs)
                    raise
                self._stage_stat("upload_s", time.perf_counter() - t1)
                return placed
        return fileio.retry_transient(
            lambda: self._upload(shard_lists, schema), "shuffle.upload")

    def _place_assembled(self, host_cols, host_counts, capacity: int,
                         bufs) -> StagedInput:
        """An assembled wave onto the device: on ``cpu`` the buffers are
        the inputs; on ``cuda`` one ``non_blocking`` copy a column on the
        copy stream, the event behind them recorded, and the arena
        buffers released behind that event."""
        if faultinject.ENABLED:
            # Chaos seam (reference parallel/shuffle.py:661-681), before
            # any copy is issued: a retry re-places the same host data.
            faultinject.maybe_raise("shuffle.upload")
        if self.device.type != "cuda":
            return StagedInput(host_cols, host_counts, capacity, True, None)
        with torch.cuda.stream(self._copy_stream):
            dev = [torch.empty(h.shape, dtype=h.dtype, device=self.device)
                   for h in host_cols + [host_counts]]
            for d, h in zip(dev, host_cols + [host_counts]):
                d.copy_(h, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        self.staging_arena.release(bufs, ready)
        return StagedInput(dev[:-1], dev[-1], capacity, True, ready)

    def _upload(self, shard_lists, schema) -> StagedInput:
        """Stage this slot's frames of a wave's per-shard lists: its
        shard concatenated (assembly), padded to the power-of-two
        capacity of the wave's largest shard and copied to the device
        (upload; pageable copies on the current stream)."""
        if faultinject.ENABLED:
            # Chaos seam (reference parallel/shuffle.py:661-681), at entry.
            faultinject.maybe_raise("shuffle.upload")
        t0 = time.perf_counter()
        counts = [sum(len(f) for f in fl) for fl in shard_lists]
        capacity = bucket_size(max(counts + [1]))
        mine = (shard_lists[self.slot] if self.slot < len(shard_lists)
                else [])
        frame = Frame.concat(mine) if mine else None
        t1 = time.perf_counter()
        self._stage_stat("assemble_s", t1 - t0)
        cols = []
        for j, ct in enumerate(schema):
            buf = torch.zeros((capacity,) + ct.shape,
                              dtype=torch_dtype(ct.dtype), device=self.device)
            if frame is not None:
                buf[: len(frame)] = frame.cols[j].to(self.device)
            cols.append(buf)
        n = len(frame) if frame is not None else 0
        counts_t = torch.tensor([n], dtype=torch.int32, device=self.device)
        self._stage_stat("upload_s", time.perf_counter() - t1)
        return StagedInput(cols, counts_t, capacity, True, None)

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
        if isinstance(out, shuffleplan.SpilledGroupOutput):
            # The partitions live in the spill store, attributed to
            # producer shard 0 like a merged output's. A loss is tagged
            # spilled_group: a spilled partition holds every shard's
            # rows, so the whole producer group must re-run.
            if shard != 0 or partition >= out.nparts:
                return []
            try:
                return out.frames_for(partition)
            except store_mod.Missing as e:
                e.spilled_group = True
                raise
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
        cg = task.chain[-1] if task.chain else None
        if isinstance(cg, Cogroup):
            # The padded device encoding, decoded into the Cogroup
            # contract's object lists.
            cols = cogroup_mod.ragged_from_padded(cg.prefix, cg.nvals, cols)
        return [Frame(cols, task.schema)]
