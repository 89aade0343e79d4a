"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out DIR]

Phase 0 prints the card (name and power limit, as nvidia-smi reports
them) and the torch and CUDA versions. Phase 1 builds the CUDA kernels
from bigslice_tpu_torch/csrc/ and runs the probe kernel. Phase 2 holds
each kernel against its plain PyTorch version on the card at the main
path's shapes (for K2 also a bucket that spills, a table at load
factor 1/4, the two tables of phase 6 that overflow and the join paths'
map waves; for K1 also float keys and the map waves of phases 6, 7, 8,
9 and 10) and times both (median of CUDA-event-timed runs after a
warm-up; the bare kernel between CUDA events, its buffers reset
outside them, with the GPU idle at the start event, and again queued
behind a busy-wait, which leaves out the host's launch latency) beside
the kernel's bound; K1 also with the L2 flushed, K2 also pass by pass.
Phase 3 runs the keyed Reduce at the shape of the JAX package's
``reduce-wave`` scenario (2**25 rows, keys uniform over 2**20, S = 4
shards: 4 waves on one card) and a max/min Reduce at 2**24 rows, each
three times warm (the median wall is reported), checks them against
numpy, and checks that the kernels' launch counters rose during the
runs. The counted run of the main path is the process's first: its
executor runs the probe kernel, which is cached per process after that.

Phases 4-7 drive the sort lowering and the map stages, each at full
width, each once counted and three times warm, every output row checked
against numpy: 4, ``lww-wave``, Const -> Map -> Filter -> a Reduce
keeping the latest record per key (a combine fn that does not classify)
at 2**25 rows; 5, ``float-key``, a counting Reduce over float32 keys
with +-0.0 and NaN at 2**24 rows; 6, ``overflow-fallback``, near-distinct
keys all routed to one partition, whose hash table overflows and whose
waves rerun on the sort path, at about 2**22 rows; 7, ``sortshuffle``,
Reshuffle of 2**24 keys, each partition read back and sorted on the
card. Each prints its warm wall, rows/s and peak device memory.

Phases 8-10 drive the join family the same way: 8, ``join``, the JAX
package's ``bench.py join`` scenario (JoinAggregate of two Consts of
2**23 int32 keys uniform over 2**19, counting both sides: K2 on both
sides' map waves, the hash join); 9, ``join-sort``, the same keys with
int32 values, side A adding and side B xoring (the tagged-sort
alignment); 10, ``groupby``, a Map over GroupByKey(capacity=64) of
2**22 rows. Each checks every output row against numpy, each row's
shard with the plain K1, the op sites on the sort path
(``MeshExecutor.hash_off``, empty on all three) and the exact launch
counts of K1 and K2.

Phases 11-13 drive the wave pipeline: 11, ``pipeline``, reduce-wave
at S = 4 and 16 under four prefetch and arena settings and the join at
depth 0 and 1; 12, ``budget-split``, reduce-wave with a budget of a
quarter of a map wave's estimate (K = 4 row slices), whose peak device
memory must not exceed phase 3's unsplit peak, nor any slice's working
set the budget; 13, ``spill``,
reduce-wave and the join through the spill exchange. Phases 14-15 drive
the general Cogroup: 14, ``cogroup-join``, two inputs of 2**22 rows (a
full outer join of lists; capacity 64); 15, ``cogroup-hotkey``, one
input of 2**20 rows with a 4096-row group (capacity 4096).
Each checks every list against numpy, in input order, and prints the
decode seconds beside the wall.

Phases 16-17 drive the local executor (``LocalExecutor()``, task
threads, the host tier): 16, ``local-reduce``, phase 3's count as
``wordcount_ids(4, keys, 2**20)``, its shards bit-equal to phase 3's,
K1 held against its plain version at the path's frame shape and
launched once a producer frame; 17, ``wordcount``, the JAX package's
word count (ScanReader, host Flatmap and Map, a Reduce over str keys)
over a generated corpus of 2**21 Zipf-like words, checked against
collections.Counter, with the host share (the wall's part with the
device idle, from one profiled run).

Phases 18-20 drive the rest of the user API: 18, ``fold``, a
device-tier Fold (``acc * 31 + v`` from 7: order-sensitive, wrapping,
not associative) over phase 3's shape, 2**25 int32 keys uniform over
2**20 from a seeded generator, and ``acc * 0.5 + v`` in float32 at
2**24 rows, every key against a numpy fold in the rows' order (source
shard, then row) and in its K1 shard, with K1 launched, K2 not, and
each wave's fold steps equal to its longest group; 19,
``fold-hotkey``, the same Fold over phase 15's rows (a 4096-row
group), whose wave takes 4096+ steps; 20, ``func-api``,
``Session().run(int_max_func, 4, keys, vals)`` at 2**24 rows (K2's
map-side max) against np.maximum.at, a Reduce over ``Reshard`` to 16
shards against np.bincount, a Reduce over a two-column ``Prefixed``
key against numpy, and a ``Scan`` sink on ``LocalExecutor()``
counting each shard's rows.

Phases 3, 11-13 and phase 20's ``int_max_func`` and Reshard runs build
``MeshExecutor(auto_dense=False)``: their int32 keys are dense enough
for the executor's auto-dense discovery (on by default, as in the JAX
package), and these phases keep the lowering and the exact launch
counts they hold (K2 on both sides of reduce-wave). Phases 21-22 drive
this slice's paths: 21, ``dense``, at the default: (a) reduce-wave's
rows through ``Session()``, where the producer's first wave discovers
the bound 2**20 (the map side takes the sort combine-shuffle, the
reduce side a dense table, K2 0), then ten alternating pairs of phase
3's lowering and this one; (b) ``Reduce(Const(1, keys, ones), add,
dense_keys=2**20)`` (one partition: the whole combine one table, no
kernel), and the fused dense combine-shuffle called directly at that
shape, its routing tables built by K1 over arange(2**20) and checked
against the CPU's; (c) a dense join, ``JoinAggregate`` of two
``Const(1, ...)`` sides of 2**23 keys over 2**19 with
``dense_keys=2**19`` (K1 1: its routing tables); (d) a dense ``Fold``
(max from -7) over phase 18's keys; (e) a misprobe, the first shard's
keys below 2**16 and the others' up to 2**21: the bound is retracted
on the reduce side, both sites go into ``auto_dense_off`` and the
group reruns on K2. 22, ``host-fallback``: word count through
``Session()`` (the device executor's host tier, its inner
``LocalExecutor``) over phase 17's corpus, equal to
collections.Counter and to phase 17's shards; and a mixed chain, a
host Map over ScanReader lines to int32 ids, a device Reduce, a host
Map over its result. Each once counted and warm (word count twice,
the chain three times), every row against numpy, with its wall, rows/s,
peak memory and K1/K2 launches.

Phases 23-25 drive dictionary-encoded string keys and the result cache,
each once counted and warm (23 and 24 twice, 25 three times), every row
checked: 23, ``urls``,
the reference's demo (cmd/urls) as
``models.urls.domain_count_encoded(Session(), 4, lines)`` over 2**22
lines in the shape of the JAX package's urls benchmark (RandomState(7),
domains ``zipf(1.5) % 5000``), against collections.Counter of
``_domain``, with the native rung that parsed, the spawn parse pool's
processes, start-up and resident memory, and the host sweep's seconds
against the Reduce's; then ``domain_count`` (host str keys, the native
CRC) over the first 2**20 lines, equal to the encoded count of the same
lines. 24, ``dict-wordcount``, phase 17's corpus through
``dictenc.dict_encoded_reduce`` (a host Flatmap to words, the encode, a
dense Reduce), equal to phase 17's Counter, beside phases 17 and 22's
walls (the native CRC in place; both print its calls). 25, ``cache``,
``Cache`` over phase 3's Reduce: the write (K1 and K2, the shards
bit-equal to phase 3's), a fresh session over the files (no K1 or K2
launch, no producer task in the graph), ``CachePartial`` after one
shard file is deleted (that file rewritten, byte-equal) and
``ReadCache``, with the write and read walls and bytes a second.

Phase 26, ``observability``, drives the telemetry hub over the main
path: (a) phase 3's reduce-wave through ``Session(executor=
MeshExecutor(auto_dense=False), trace_path=..., eventer=...)``, its
rows against np.bincount, the hub's per-partition vector against numpy
(each shard's distinct keys a partition, the partition from the plain
K1 on a CPU copy), the hub's kernel launches against the ``LAUNCHES``
deltas, each kernel's declared bytes a launch against phase 2's bound,
its peak HBM against ``max_memory_allocated`` and at least a map
wave's staged bytes, its staging against
``staging_seconds()`` and the Chrome trace's complete events against
the run's tasks; (b) phase 16's rows through ``LocalExecutor()``, the
routed vector against np.bincount of the plain K1; (c) ten alternating
pairs of (a)'s Reduce with ``BIGSLICE_TELEMETRY=0`` and the default,
each a fresh session, the medians and ratio (printed, not gated), and
host syncs a run each way after one warm-up count, which must be equal
(the hub adds no sync); (d) a
``Profiler.window`` around one run of (a), whose trace names K1's and
K2's kernels, with each kernel's achieved bytes a second from the
declared bytes and the profiled time; (e) a ``Counter`` inside a Map
over device columns, host tier, counting 2**20 rows exactly; (f)
whether ``pyarrow`` and ``fsspec`` import.

Phase 27 drives the data plane and k-means: (a) ``parquet-reduce``,
2**25 rows of int64 keys uniform over 2**20 and int64 values (each
wrapping when cast down to int32) from default_rng(27), written once
outside the timed runs as one Parquet file of 32 row groups under a
``memory://`` prefix, read by ``ParquetReader(4, url, out=[int32,
int32])`` into ``Reduce(add)`` through ``MeshExecutor(auto_dense=False)``
(the host producer routes each row group with K1; the reduce side
combines with K2), then at the default, every key's sum against numpy
and in its K1 shard, the result written with ``Result.write_parquet``
to ``memory://`` and read back with pyarrow; the median warm wall of
two runs, rows/s, peak device memory, the launches and the reader's
own decode seconds; (b) ``parquet-glob-spill``, the same rows as 8
local files under a ``*`` glob through a ``Reshuffle`` (a device group
whose boundary spills) into the Reduce, with ``BIGSLICE_SHUFFLE=spill``
and ``BIGSLICE_SPILL_DIR=memory://...``, its shards equal to (a)'s; (c)
(a)'s Reduce under ``Cache`` on a ``memory://`` prefix: the write, then
a re-run with no launch and the same rows; (d) ``Result.to_arrow`` of
(a)'s 2**20 result rows and ``to_pandas`` where pandas imports; (e)
``kmeans``: ``models.kmeans.kmeans(Session(), points, k=1024, iters=5,
num_shards=4)`` over 2**20 float32 points of d = 128 in 1024 Gaussian
blobs (default_rng(27)), each iteration held against float64 on the
card from the same centroids (an assignment may flip only within
float32 rounding; the centroids within ``KMEANS_RTOL``), with seconds
an iteration and the launches.

Phase 28 drives the robustness plane, each part with its wall and
launches on its own lines: (a) ``chaos-mesh``, phase 3's Reduce under
the JAX package's mesh chaos plan at prefetch depth 0 and 2, arena on
and off, each against its fault-free run and numpy (``mesh.dispatch``
once, the op on probation with its host-tier runs counted, no fatal
recovery, the seed's sorted injection log replayed, the card's memory
and the arena's outstanding buffers back at their baselines); (b)
``chaos-local``, phase 16's rows on ``LocalExecutor(procs=4)`` over 8
shards with a ``FileStore`` under the package's local plan (files
quarantined, ``store.read`` recovered); (c) ``chaos-spill``, phase
13's spill path under write transients, a lost and a corrupted spilled
partition; (d) ``coded``, ``BIGSLICE_CODED=combine`` on phase 16's
Reduce, r losses silent, r + 1 loud, a stuck member cancelled; (e)
``deadline``, ``run(deadline_s=0.5)`` with a stuck host-tier task at
depth 2, then a fresh run; (f) ``adaptive-skew``, ``-cost`` and
``-spec`` against ``off``; (g) ``seam-cost``, ten alternating pairs of
phase 3's Reduce with no plan and with a rate-0 plan on every site,
equal host syncs asserted; (h) the ``chaosslice`` CLI, two subprocesses
at once.

Phase 29 drives the operator plane at reduce-wave's shape (2**25 rows
over 2**20 keys, S = 4, ``auto_dense=False``): (a) ``debug-server``,
a run through ``Session(debug_port=0, trace_path=...)`` with every
route polled while it is live and after it (each 200; ``/debug/fleet``
the fleet merge of this one process in either format),
``/debug/device``'s launches against the hub's and ``LAUNCHES``,
every ``/debug/metrics`` line parsed, ``/debug/profile?seconds=0.5``
around a run holding K1's and K2's kernel events while a second window
gets 409, alternating pairs of the run with and without a client
polling the server, and a ``close()`` that drains a window in flight;
(b) ``kselect-static``, ``BIGSLICE_KERNEL_SELECT=static`` over sparse
int32 keys (hash, ``static:cuda-kernel``, bit-equal to the unset run,
whose launches are phase 3's), float32 keys with +-0.0 (sort,
``hash-ineligible``, no K2) and small contiguous keys (dense,
``dense-bound``), every row against numpy, then phase 21's misprobe
unset and under ``static``: the retracted op records ``dense`` and then
``hash``, with the unset run's rows and launches; (c)
``kselect-measured``: the probe's sort and hash medians and samples,
the verdict, the probe's launches (kind ``kselect``) apart from the
op's wave launches, rows bit-equal to the unset run's, then the same op
over a hot key: one re-selection, and a new decision, then the race at
eight more op shapes (256 and 65,536 rows, one or two keys, one or four
value lanes); (d) ``tools``: ``slicetrace`` over
(a)'s and (c)'s traces (``:kernels``, skew, overlap, no recovery;
``--merge`` into rank lanes) and ``obsdump``'s workload on the card,
whose summary's device section lists K1 and K2.

Phase 30 drives the serving plane: (a) ``full-width``, phase 3's
Reduce (2**25 rows over 2**20 keys, S = 4, ``auto_dense=False``)
registered on ``ServeServer(Session(...), port=0, slots=2,
queue_depth=64)`` and invoked over HTTP once with every row: the rows
against np.bincount, K1 4 and K2 8 as in phase 3 (the path's counted
run), the latency beside phase 3's warm wall; (b) ``program-cache``,
the server attached to a fresh Session and invoked again: bit-equal
rows, the program cache's hits risen, no group program built after a
miss; (c) ``sustained``, the JAX package's serve-qps shape (2**20 rows
over 2**12 keys, S = 2) on a fresh ``Session()``, 8 closed-loop HTTP
clients over 4 tenants for 10 s with ``rows: false``: every
``num_rows`` checked, QPS, p50, p99, rows/s and shed recorded; (d)
``admission``, a gated slow pipeline: 503 with the queue full, 429 at
the quota, the predictive 504 and a mid-flight 504 that frees its slot,
then under ``BIGSLICE_ADAPTIVE=cost`` the sole invocation's declared
launch bytes (the sum of ``cuda_kernels.cost`` over its launches) as
its prediction, and a budget below two invocations' bytes shedding the
second concurrent one; (e) ``result-cache``, a ``cache=True``
pipeline whose second invocation is a hit with no K1 or K2 launch; (f)
the ``sliceserve`` CLI in a subprocess: its JSON line, a ``reduce``
invocation, SIGTERM, exit 0 and the final snapshot line, with the
spawn to the first 200 (a fresh process's cold start) beside (b)'s
fresh-Session request.

Phase 31 drives attention, the one-card tools and the staging
breakdown: (a) ``SelfAttend`` on the device tier at the JAX package's
attention shape on one device (S = 1, seq 2**13, 2 heads of 128,
causal, RandomState(31)) in three lowerings, ``auto`` in fp32 with TF32
off (Ulysses), ``auto`` in bf16 and the ring in bf16 tiled at
``block_q = max(128, seq // 64)``, each once counted and three times
warm against the host's float64 oracle (fp32 at 3e-4, bf16 at 3e-2,
and by the norm of the difference at 1e-5 and 1e-2),
with its warm wall, the stage's device time (CUDA events around the
executor's attend stage over the staged columns) and TFLOP/s of the
forward's 4 * seq**2 * heads * head_dim operations over it, the peak
device memory (the tiled ring's below Ulysses') and K1-K3 launches (0:
no shuffle); then ``scaled_dot_product_attention`` on the same q, k, v
in fp32 and bf16, a yardstick that is not on the path; (b) S = 4 (more
shards than the one device slot) on the host tier's broadcast reader,
no attend lowering recorded, against the oracle at seq 2**12; (c) an
outer ``Map(o * 2)`` fused after the attend stage at S = 1, seq 2**12;
(d) every ``slicer`` mode on the card (200,000 rows, 100,000 for
``oom``, 8 shards), ``microbench --quick`` with every line parsed, and
``slicetypecheck`` over a source with six known problems; (e) phase
3's reduce-wave with the hub on, its source group's
``staging_breakdown`` (read, assemble, upload) non-negative and within
its staged seconds.

Phase 32 drives the device executor over 2 ``torch.distributed`` ranks
that share the card over gloo, started fresh by the port's launcher
(``tools/multihost_smoke.py``): (a) reduce-wave at full width (2**25
rows over 2**20 keys) at S = 8 shards, 4 waves a rank, once counted and
once warm, every row against numpy and in the shard K1 names, K1
and K2 launched on each rank (their sums in the kernels line), the
backend, the exchange's transport and bytes and each rank's walls
printed, and the mesh k-means step at phase 27e's shape against one
rank's; (b) one NCCL rank through the exchange seam's own path; (c) a
wedged rank caught by its peer's keepalive.

Phase 33 drives the rest of the multi-process plane: (a) reduce-wave at
full width on 4 ranks sharing the card as a 2x2 DCN x ICI grid
(``BIGSLICE_MESH_SHAPE=2x2``, the two-stage exchange of
``parallel/hier.py``) at S = 16, and on the flat mesh of the same ranks,
every shard's rows against numpy and equal between the two, each
stage's bytes and host seconds printed; (b) phase 17's word count on 2
ranks through the host-task exchange (``exec/hostdist.py``), each host
task run once; (c) SelfAttend at phase 31a's shape over 2 ranks, the
ring's K/V rotation and Ulysses' all_to_alls, fp32 and bf16, against
the float64 oracle; (d) (a)'s fleet telemetry merged on rank 0 against
the ranks' own snapshots; (e) an elastic session recovering from an
injected ``peer.lost``; (f) the sm_90a build check of every source
(``tools/aotcheck.py``).

Phase 34 drives an undeclared ``Reduce`` over vector value columns
through K2 (``auto_dense=False``, no ``dense_keys``), each once counted
and three times warm like phases 4-7, both on K2's vector route (each
row gathered whole into the bucket's shared sub-table): (a) phase 27e's
k-means point sums (2**20 float32 points of d = 128, keys in [0, 1024),
S = 4), every key's [128] sum against a float64 numpy oracle within
1e-4 of its summands' absolute sum; (b) reduce-wave's widths with a
vector payload (2**23 rows over 2**20 keys, int32 [n, 8] values, S =
4), every row exact against numpy. Each prints its warm wall, K1 and
K2 launches (both above 0), that no op went to the sort path
(``hash_off`` empty), its peak device memory and the phase's seconds.
Phase 2 holds K2 against its plain version at G = 4, 8, 9, 128 and
1814 (the boundary) on the vector route and at 1815 past it
(scattered), add, max and min on int32 and float32, the spill case
included, and times the route against the placement-and-scatter
yardstick and G scalar columns (``_route_pairs``).

Every check raises, so any failed phase exits non-zero. The line before
the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Without a GPU the script exits
non-zero and prints no result. With ``--out DIR`` the measurements
are also written to DIR/chip_smoke.json. It imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import gc
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

if __name__ != "__mp_main__":
    # A parse-pool worker (phase 23) re-imports this script as
    # __mp_main__ under the spawn start method; it runs no phase and
    # need not load torch.
    import torch

#: H100 SXM device-memory rate (NVIDIA data sheet), for byte bounds.
HBM_BYTES_PER_S = 3.35e12
#: Warm runs of each phase-3 Reduce and of every path driven like it;
#: the wall reported is their median. Three (was five), the host paths'
#: one (was three, then two) and phase 32a's one (was three) keep the
#: script, phases 32 and 33 included, inside its time limit.
WARM_RUNS = 3
#: Warm runs of the host-tier word-count and urls paths (phases 17,
#: 22-24), seconds each: fewer still.
HOST_WARM_RUNS = 1

REPLACES = {
    "hash_partition": "bigslice_tpu/parallel/pallas_kernels.py:176",
    "hash_aggregate": "bigslice_tpu/parallel/pallas_kernels.py:436",
    "probe_add1": "bigslice_tpu/parallel/pallas_kernels.py:46",
}
SOURCES = {
    "hash_partition": "bigslice_tpu_torch/csrc/hash_partition.cu",
    "hash_aggregate": "bigslice_tpu_torch/csrc/hash_aggregate.cu",
    "probe_add1": "bigslice_tpu_torch/csrc/probe.cu",
}
#: The kernels the main path launches (the process's first executor
#: runs the probe at construction).
PATH_KERNELS = ("hash_partition", "hash_aggregate", "probe_add1")
#: The keys of each kernel's entry in the ``{"kernels": [...]}`` line.
LINE_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` between CUDA events over ``reps``
    runs after ``warmup``."""
    return time_bare_ms(lambda: None, fn, reps, warmup)


#: GPU cycles of the busy-wait queued before a start event (about 50 us),
#: so that the host has enqueued the launch before the GPU reaches it.
QUEUE_CYCLES = 100_000


def time_bare_ms(setup, launch, reps: int = 10, warmup: int = 2,
                 queued: bool = False) -> float:
    """Median milliseconds of the bare kernel ``launch()`` between CUDA
    events, with ``setup()`` (resetting its buffers) run before the
    start event. By default the GPU is idle at the start event, so the
    time includes the host's launch latency (the headline ``ms`` of
    each kernel); ``queued`` puts a busy-wait before it, which leaves
    the device's time alone."""
    times = []
    for i in range(warmup + reps):
        setup()
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def _launcher(fn, args, name):
    def launch():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")
    return launch


def bare_partition_ms(keys, nparts, seed, valid, with_counts,
                      flush=None):
    """K1 alone: ``bs_hash_partition`` into buffers allocated once, timed
    with the GPU idle and queued (``time_bare_ms``): ``(ms, queued_ms)``.
    With ``flush`` (a buffer larger than the 50 MB L2), setup writes it
    before each start event, so the kernel finds its input in device
    memory."""
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    n, device = keys[0].shape[0], keys[0].device
    ids = torch.empty(n, dtype=torch.int32, device=device)
    counts = (torch.zeros(nparts, dtype=torch.int32, device=device)
              if with_counts else None)
    args = ck.partition_args(keys, nparts, seed, valid, ids, counts)

    def setup():
        if with_counts:
            counts.zero_()
        if flush is not None:
            flush.zero_()

    launch = _launcher(ck.build().bs_hash_partition, args, "hash_partition")
    return (time_bare_ms(setup, launch),
            time_bare_ms(setup, launch, queued=True))


def bare_aggregate_ms(valid, keys, vals, ops, part, nparts, R,
                      want_keys: int, by_pass: bool = False):
    """K2 alone: ``bs_hash_aggregate`` (all three passes) into outputs and
    scratch allocated once; the wrapper's allocation is not in the time.
    Checks that the timed launches placed ``want_keys`` keys with no
    overflow. With ``by_pass`` also returns the queued time of all three
    and of each pass, the earlier passes run before its start event:
    ``(ms, {"queued": .., "A": .., "B": .., "C": ..})``."""
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    n, T, device = valid.shape[0], nparts * R, valid.device
    # The kernel's share of K2: the value columns it combines (the
    # rows' slots written for the scattered columns, whose scatter is
    # not in this time).
    shapes = [tuple(v.shape[1:]) for v in vals]
    routes = ck.aggregate_routes(shapes, [v.dtype for v in vals], len(keys))
    wide = "scatter" in routes
    vals = [v for v, r in zip(vals, routes) if r == "kernel"]
    ops = [op for op, r in zip(ops, routes) if r == "kernel"]
    nvals, words = ck.kernel_words(shapes, routes)
    plan = ck.aggregate_plan(len(keys), nvals, nparts, R, n,
                             row_lane=wide, row_words=words)
    buf = ck.aggregate_buffers(plan, keys, vals, T, device, placed=wide)
    lib = ck.build()

    def run(passes):
        args = ck.aggregate_args(valid, keys, vals, ops, part, nparts, R,
                                 0, plan, buf, passes)
        return _launcher(lib.bs_hash_aggregate, args, "hash_aggregate")

    ms = time_bare_ms(lambda: None, run(7))
    queued = time_bare_ms(lambda: None, run(7), queued=True)
    placed = int(buf.present.sum())
    if int(buf.overflow) != 0 or placed != want_keys:
        raise AssertionError(f"bare hash_aggregate placed {placed} keys "
                             f"(want {want_keys}), overflow "
                             f"{int(buf.overflow)}")
    if not by_pass:
        return ms
    passes = {"queued": queued,
              "A": time_bare_ms(lambda: None, run(1), queued=True),
              "B": time_bare_ms(run(1), run(2), queued=True),
              "C": time_bare_ms(run(3), run(4), queued=True)}
    return ms, passes


def nbytes(*tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def phase0_card() -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"phase 0: card {card}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    return card


def phase1_build() -> None:
    from bigslice_tpu_torch.parallel import cuda_kernels

    t0 = time.perf_counter()
    cuda_kernels.build()
    # K3 checked directly (uncached): the main path's first executor
    # runs it again through the per-process kernels_available().
    if not cuda_kernels.probe():
        raise RuntimeError("probe kernel returned wrong values")
    log(f"phase 1: kernels built in {cuda_kernels.BUILD_SECONDS:.3f} s, "
        f"probe ok ({time.perf_counter() - t0:.3f} s with the probe)")


def _rows(present, keys, vals):
    """Occupied table rows as a sorted int64 matrix (float bits as
    int32), for comparing tables whose slot layouts differ."""
    idx = torch.nonzero(present).squeeze(1)
    cols = []
    for c in list(keys) + list(vals):
        c = c.view(torch.int32) if c.element_size() == 4 else c
        cols.append(c[idx].to(torch.int64).cpu().numpy())
    m = np.stack(cols, 1)
    return m[np.lexsort(m.T[::-1])]


def phase2_kernels(device) -> dict:
    """Each kernel against its plain version at the main path's
    shapes; ``ms`` is the bare kernel's time, ``wrapper_ms`` the
    wrapper's (allocation, launch and, for K2, its fills and key
    gather)."""
    from bigslice_tpu_torch.parallel import cuda_kernels as ck
    from bigslice_tpu_torch.parallel import hashagg

    results = {}
    # Each section's seconds, logged at the end: where phase 2's time
    # goes.
    secs, t_mark = {}, [time.perf_counter()]

    def mark(what):
        torch.cuda.synchronize()
        now = time.perf_counter()
        secs[what] = round(now - t_mark[0], 2)
        t_mark[0] = now

    g = torch.Generator(device="cpu").manual_seed(0)
    # -- K1 at the main path's shape: one map wave routes its shard's
    # 2**23 rows (one int32 key, the validity mask, 4 partitions, no
    # histogram).
    n = 1 << 23
    key = torch.randint(-(2**31), 2**31 - 1, (n,), generator=g,
                        dtype=torch.int32).to(device)
    valid = torch.ones(n, dtype=torch.bool, device=device)

    def route():
        return ck.hash_partition([key], 4, 0, with_counts=False,
                                 valid=valid)

    def route_plain():
        return ck.hash_partition_plain([key], 4, 0, with_counts=False,
                                       valid=valid)

    ids, _ = route()
    pids, _ = route_plain()
    if not torch.equal(ids, pids):
        raise AssertionError("hash_partition != plain at the path shape")
    err = int((ids.to(torch.int64) - pids).abs().max())
    ms, queued = bare_partition_ms([key], 4, 0, valid, with_counts=False)
    # The map wave's 42 MB of K1 input fits the 50 MB L2: the time with
    # the L2 flushed first is the one to hold against the HBM bound.
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    flushed, flushed_queued = bare_partition_ms(
        [key], 4, 0, valid, with_counts=False, flush=flush)
    del flush
    wrapper = time_ms(route)
    plain = time_ms(route_plain, reps=5)
    # The kernel's declared cost (cuda_kernels.cost, what the telemetry
    # hub sums) is the byte model of every bound here: key, mask and ids.
    bound_bytes = ck.cost("hash_partition", n=n, key_itemsizes=(4,),
                          valid=True, nparts=4, with_counts=False)["bytes"]
    if bound_bytes != nbytes(key, valid, ids):
        raise AssertionError("hash_partition's declared bytes differ from "
                             "its tensors'")
    bound = bound_bytes / HBM_BYTES_PER_S * 1e3
    log(f"phase 2: hash_partition n={n} keys=1 nparts=4 masked, no "
        f"counts (map wave): kernel {ms:.4f} ms (queued {queued:.4f}), L2 "
        f"flushed {flushed:.4f} ms (queued {flushed_queued:.4f}), wrapper "
        f"{wrapper:.4f} ms (plain {plain:.4f} ms, bound {bound:.4f} ms), "
        f"bit-equal")
    results["hash_partition"] = dict(
        max_abs_err=err, ms=ms, queued_ms=queued, flushed_ms=flushed,
        flushed_queued_ms=flushed_queued, wrapper_ms=wrapper,
        plain_ms=plain, bound_ms=bound, bound_by="bytes", library_ms=None,
        bound_bytes=bound_bytes,
        shape="n=2**23, 1 int32 key, valid mask, nparts=4, no counts",
    )

    # The whole reduce-wave input at once (n = 2**25), with the
    # histogram.
    n = 1 << 25
    key = torch.randint(-(2**31), 2**31 - 1, (n,), generator=g,
                        dtype=torch.int32).to(device)
    ids, counts = ck.hash_partition([key], 4, 0)
    pids, pcounts = ck.hash_partition_plain([key], 4, 0)
    if not (torch.equal(ids, pids) and torch.equal(counts, pcounts)):
        raise AssertionError("hash_partition != plain at n=2**25")
    err = max(err, int((ids.to(torch.int64) - pids).abs().max()))
    ms25, queued25 = bare_partition_ms([key], 4, 0, None, with_counts=True)
    plain25 = time_ms(lambda: ck.hash_partition_plain([key], 4, 0), reps=5)
    bound25 = ck.cost("hash_partition", n=n, key_itemsizes=(4,),
                      valid=False, nparts=4, with_counts=True)["bytes"] \
        / HBM_BYTES_PER_S * 1e3
    log(f"phase 2: hash_partition n={n} keys=1 nparts=4 counts: kernel "
        f"{ms25:.4f} ms (queued {queued25:.4f}; plain {plain25:.4f} ms, "
        f"bound {bound25:.4f} ms), bit-equal")
    results["hash_partition"].update(
        ms_n25_counts=ms25, queued_ms_n25_counts=queued25,
        plain_ms_n25_counts=plain25,
        bound_ms_n25_counts=bound25)

    # Mixed int32/uint32/float32 keys with +-0.0 and NaN, a mask, 1000
    # partitions (the wide-histogram shape).
    n = (1 << 20) + 37
    f = torch.randn(n, generator=g) * 100
    f[:4] = torch.tensor([0.0, -0.0, float("nan"), float("inf")])
    keys = [
        torch.randint(-(2**31), 2**31 - 1, (n,), generator=g,
                      dtype=torch.int32),
        torch.randint(-(2**31), 2**31 - 1, (n,), generator=g,
                      dtype=torch.int32).view(torch.uint32),
        f.to(torch.float32),
    ]
    keys = [k.to(device) for k in keys]
    valid = (torch.rand(n, generator=g) < 0.9).to(device)
    ids, counts = ck.hash_partition(keys, 1000, 7, valid=valid)
    pids, pcounts = ck.hash_partition_plain(keys, 1000, 7, valid=valid)
    if not (torch.equal(ids, pids) and torch.equal(counts, pcounts)):
        raise AssertionError("hash_partition != plain on mixed keys")
    results["hash_partition"]["max_abs_err"] = max(
        err, int((ids.to(torch.int64) - pids).abs().max()))
    ms2, queued2 = bare_partition_ms(keys, 1000, 7, valid, with_counts=True)
    log(f"phase 2: hash_partition n={n} keys=3 nparts=1000 masked: kernel "
        f"{ms2:.4f} ms (queued {queued2:.4f}), bit-equal")

    # One float32 key column with +-0.0 and NaN at the float-key path's
    # map wave (phase 5: 2**22 rows, valid mask, 4 partitions).
    n = 1 << 22
    rng = np.random.RandomState(12)
    fk = rng.randn(n).astype(np.float32)
    for i, v in enumerate([0.0, -0.0, np.nan, -np.nan]):
        fk[i::97] = v
    key = torch.from_numpy(fk).to(device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    ids, _ = ck.hash_partition([key], 4, 0, with_counts=False, valid=valid)
    pids, _ = ck.hash_partition_plain([key], 4, 0, with_counts=False,
                                      valid=valid)
    if not torch.equal(ids, pids):
        raise AssertionError("hash_partition != plain on float keys")
    msf, queuedf = bare_partition_ms([key], 4, 0, valid, with_counts=False)
    boundf = ck.cost("hash_partition", n=n, key_itemsizes=(4,),
                     valid=True, nparts=4, with_counts=False)["bytes"] \
        / HBM_BYTES_PER_S * 1e3
    log(f"phase 2: hash_partition n={n} float32 key with +-0.0 and NaN "
        f"nparts=4 masked (float-key map wave): kernel {msf:.4f} ms (queued "
        f"{queuedf:.4f}; bound {boundf:.4f} ms), bit-equal")
    results["hash_partition"].update(float_key_ms=msf,
                                     float_key_queued_ms=queuedf,
                                     float_key_bound_ms=boundf)

    # int32 keys at the map waves of phase 6 (wave 0: 2**20 rows, every
    # key in partition 0) and phase 7 (wave 0: 2**22 keys uniform over
    # 2**30), 4 partitions, all rows valid, no histogram.
    okeys = _overflow_keys()
    for what, k in (("overflow-fallback", okeys[:1 << 20]),
                    ("sortshuffle", _sortshuffle_keys()[:1 << 22]),
                    ("groupby", _groupby_input()[0][:1 << 20])):
        key = torch.from_numpy(k).to(device)
        valid = torch.ones(len(k), dtype=torch.bool, device=device)
        ids, _ = ck.hash_partition([key], 4, 0, with_counts=False,
                                   valid=valid)
        pids, _ = ck.hash_partition_plain([key], 4, 0, with_counts=False,
                                          valid=valid)
        if not torch.equal(ids, pids):
            raise AssertionError(f"hash_partition != plain at the {what} "
                                 f"map wave")
        log(f"phase 2: hash_partition n={len(k)} int32 key nparts=4 masked "
            f"({what} map wave 0): bit-equal")

    mark("K1")
    # -- K2 at the map side's shape (n = 2**23, 4 parts, R = 2**21, keys
    # uniform over 2**20, int32 add).
    n = 1 << 23
    nparts, R = 4, 1 << 21
    key = torch.randint(0, 1 << 20, (n,), generator=g,
                        dtype=torch.int32).to(device)
    one = torch.ones(n, dtype=torch.int32, device=device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    part, _ = ck.hash_partition([key], nparts, 0, with_counts=False)

    def agg():
        return ck.hash_aggregate(valid, [key], [one], ["add"], part,
                                 nparts, R)

    def agg_plain():
        return ck.hash_aggregate_plain(valid, [key], [one], ["add"], part,
                                       nparts, R)

    got, want = agg(), agg_plain()
    err2 = _check_tables(got, want, nparts, R, "map-side shape")
    nkeys = int(got[0].sum())
    ms, passes = bare_aggregate_ms(valid, [key], [one], ["add"], part,
                                   nparts, R, nkeys, by_pass=True)
    wrapper = time_ms(agg)
    plain = time_ms(agg_plain, reps=3, warmup=1)
    bound_bytes = ck.cost("hash_aggregate", n=n, key_itemsizes=(4,),
                          val_itemsizes=(4,), nparts=nparts, R=R)["bytes"]
    if bound_bytes != nbytes(valid, key, one, part, got[0], *got[1],
                             *got[2]):
        raise AssertionError("hash_aggregate's declared bytes differ from "
                             "its tensors'")
    bound = bound_bytes / HBM_BYTES_PER_S * 1e3
    log(f"phase 2: hash_aggregate n={n} nparts={nparts} R={R} (map side): "
        f"kernel {ms:.4f} ms, wrapper {wrapper:.4f} ms (plain {plain:.4f} "
        f"ms, bound {bound:.4f} ms), {nkeys} keys, rows equal")
    results["hash_aggregate"] = dict(
        ms=ms, wrapper_ms=wrapper, plain_ms=plain, bound_ms=bound,
        bound_by="bytes", library_ms=None, pass_ms=passes,
        bound_bytes=bound_bytes,
        shape="n=2**23, nparts=4, R=2**21, keys over 2**20, int32 add",
    )

    # -- K2 at the reduce side's shape: reduce wave 0's input as the
    # main path builds it (nparts = 1, R = bucket_size(n)).
    rvalid, rkey, rval, rn = _reduce_side_input(device)
    R = rkey.shape[0]
    rpart = torch.zeros(R, dtype=torch.int32, device=device)
    got = ck.hash_aggregate(rvalid, [rkey], [rval], ["add"], rpart, 1, R)
    want = ck.hash_aggregate_plain(rvalid, [rkey], [rval], ["add"], rpart,
                                   1, R)
    err2 = max(err2, _check_tables(got, want, 1, R, "reduce-side shape"))
    rkeys = int(got[0].sum())
    rms, rpasses = bare_aggregate_ms(rvalid, [rkey], [rval], ["add"], rpart,
                                     1, R, rkeys, by_pass=True)
    rbound = ck.cost("hash_aggregate", n=R, key_itemsizes=(4,),
                     val_itemsizes=(4,), nparts=1, R=R)["bytes"] \
        / HBM_BYTES_PER_S * 1e3
    log(f"phase 2: hash_aggregate n={R} ({rn} valid) nparts=1 R={R} "
        f"(reduce side): kernel {rms:.4f} ms (bound {rbound:.4f} ms), "
        f"{rkeys} keys, rows equal")
    results["hash_aggregate"].update(
        reduce_side_ms=rms, reduce_side_bound_ms=rbound,
        reduce_side_pass_ms=rpasses,
        reduce_side_shape=f"n={R} ({rn} valid), nparts=1, R={R}, "
                          f"{rkeys} keys, int32 add")

    # Two int32 keys; int32 add, float32 max, int32 min values.
    n = 1 << 20
    k1 = torch.randint(0, 1 << 16, (n,), generator=g, dtype=torch.int32)
    keys = [k1.to(device), (k1 % 5).to(device)]
    vals = [torch.randint(-1000, 1000, (n,), generator=g,
                          dtype=torch.int32).to(device),
            torch.randn(n, generator=g).to(device),
            torch.randint(-(2**31), 2**31 - 1, (n,), generator=g,
                          dtype=torch.int32).to(device)]
    ops = ["add", "max", "min"]
    valid = (torch.rand(n, generator=g) < 0.9).to(device)
    part, _ = ck.hash_partition(keys, 4, 0, with_counts=False)
    R2 = 1 << 18
    got = ck.hash_aggregate(valid, keys, vals, ops, part, 4, R2)
    want = ck.hash_aggregate_plain(valid, keys, vals, ops, part, 4, R2)
    err2 = max(err2, _check_tables(got, want, 4, R2, "multi-column"))
    ms2 = bare_aggregate_ms(valid, keys, vals, ops, part, 4, R2,
                            int(got[0].sum()))
    log(f"phase 2: hash_aggregate n={n} keys=2 vals=add/max/min: kernel "
        f"{ms2:.4f} ms, rows equal")

    # More distinct keys than one bucket holds, all homed in one bucket of
    # region 1 (the region under a fifth full): the spill pass places the
    # rows the bucket cannot.
    nparts, R = 4, 1 << 16
    skey = _spill_keys(nparts, R)
    rng = np.random.RandomState(7)
    skeys = torch.from_numpy(rng.permutation(np.repeat(skey, 3))).to(device)
    sval = torch.from_numpy(
        rng.randint(-100, 100, skeys.shape[0]).astype(np.int32)).to(device)
    svalid = torch.ones(skeys.shape[0], dtype=torch.bool, device=device)
    spart, _ = ck.hash_partition([skeys], nparts, 0, with_counts=False)
    got = ck.hash_aggregate(svalid, [skeys], [sval], ["add"], spart, nparts,
                            R)
    want = ck.hash_aggregate_plain(svalid, [skeys], [sval], ["add"], spart,
                                   nparts, R)
    err2 = max(err2, _check_tables(got, want, nparts, R, "spill"))
    sms, spasses = bare_aggregate_ms(svalid, [skeys], [sval], ["add"],
                                     spart, nparts, R, len(skey),
                                     by_pass=True)
    log(f"phase 2: hash_aggregate spill case, {len(skey)} keys in one "
        f"bucket's home range, nparts={nparts} R={R}: kernel {sms:.4f} ms, "
        f"rows equal")

    # Load factor 1/4: 2**19 distinct keys in one 2**21-slot region. The
    # keys come from a Generator: RandomState's choice without
    # replacement permutes the whole 2**30 range first (8 GiB, about a
    # minute).
    rng = np.random.RandomState(8)
    distinct = np.random.default_rng(8).choice(1 << 30, 1 << 19,
                                               replace=False)
    qkey = torch.from_numpy(rng.permutation(np.repeat(
        distinct.astype(np.int32), 2))).to(device)
    qval = torch.from_numpy(
        rng.randint(0, 50, qkey.shape[0]).astype(np.int32)).to(device)
    qvalid = torch.ones(qkey.shape[0], dtype=torch.bool, device=device)
    qpart = torch.zeros(qkey.shape[0], dtype=torch.int32, device=device)
    got = ck.hash_aggregate(qvalid, [qkey], [qval], ["max"], qpart, 1,
                            1 << 21)
    want = ck.hash_aggregate_plain(qvalid, [qkey], [qval], ["max"], qpart,
                                   1, 1 << 21)
    err2 = max(err2, _check_tables(got, want, 1, 1 << 21, "load 1/4"))
    qms = bare_aggregate_ms(qvalid, [qkey], [qval], ["max"], qpart, 1,
                            1 << 21, 1 << 19)
    log(f"phase 2: hash_aggregate load 1/4, 2**19 keys in 2**21 slots: "
        f"kernel {qms:.4f} ms, rows equal")
    # The two tables of phase 6 that overflow on the first attempt: its
    # map wave 0 (2**20 near-distinct keys, all of partition 0, into
    # regions of R = 2**18) and its reduce wave 0 (partition 0's rows of
    # the four map waves, from the sort path the overflow sent them to,
    # nparts = 1). Only the overflow count steers the path here.
    okey = torch.from_numpy(okeys[:1 << 20]).to(device)
    oone = torch.ones_like(okey)
    ovalid = torch.ones(okey.shape[0], dtype=torch.bool, device=device)
    opart, _ = ck.hash_partition_plain([okey], 4, 0, with_counts=False)
    oR = hashagg.combine_region_size(okey.shape[0], 4)
    overflows = {"map_wave": _check_overflowed(
        ck.hash_aggregate(ovalid, [okey], [oone], ["add"], opart, 4, oR),
        ck.hash_aggregate_plain(ovalid, [okey], [oone], ["add"], opart, 4,
                                oR),
        ovalid, okey, oone, 4, oR, "phase 6 map wave 0")}
    rvalid, rkey, rval, rn = _overflow_reduce_input(okeys, device)
    oR = rkey.shape[0]
    rpart = torch.zeros(oR, dtype=torch.int32, device=device)
    overflows["reduce_wave"] = _check_overflowed(
        ck.hash_aggregate(rvalid, [rkey], [rval], ["add"], rpart, 1, oR),
        ck.hash_aggregate_plain(rvalid, [rkey], [rval], ["add"], rpart, 1,
                                oR),
        rvalid, rkey, rval, 1, oR, "phase 6 reduce wave 0")
    log(f"phase 2: hash_aggregate where phase 6 overflows, map wave 0 "
        f"(n=2**20, nparts=4, R=2**18) and reduce wave 0 (n={oR}, {rn} "
        f"valid, nparts=1): overflow (kernel, plain) "
        + "; ".join(f"{k} {v['kernel']}, {v['plain']}"
                    for k, v in overflows.items())
        + ", both tables consistent with their counts")
    results["hash_aggregate"]["overflow_cases"] = overflows
    log("phase 2: hash_aggregate queued, all passes and each (A bucket, "
        "B aggregate, C spill), ms: " + "; ".join(
            f"{what} " + ", ".join(f"{k} {v:.4f}" for k, v in p.items())
            for what, p in (("map side", passes), ("reduce side", rpasses),
                            ("spill case", spasses))))
    results["hash_aggregate"].update(
        max_abs_err=err2, spill_case_ms=sms, spill_case_pass_ms=spasses,
        load_quarter_ms=qms)

    mark("K2 scalar")
    # -- K2 over vector value columns (phase 34's shapes).
    vec = _phase2_vector(device)
    mark("K2 vector")
    results["hash_aggregate"]["vector"] = vec
    results["hash_aggregate"]["max_abs_err"] = max(
        results["hash_aggregate"]["max_abs_err"], vec["max_abs_err"])

    # -- K1 and K2 at the join paths' map waves (phases 8 and 9): wave 0
    # of each side routes and combines 2**21 rows of keys uniform over
    # 2**19 into 4 regions of R = 2**19 (side B of join-sort only
    # routes).
    jms = {}
    for side, k in zip("ab", _join_keys()):
        key = torch.from_numpy(k[:1 << 21]).to(device)
        one = torch.ones_like(key)
        valid = torch.ones(key.shape[0], dtype=torch.bool, device=device)
        jpart, _ = ck.hash_partition([key], 4, 0, with_counts=False,
                                     valid=valid)
        ppart, _ = ck.hash_partition_plain([key], 4, 0, with_counts=False,
                                           valid=valid)
        if not torch.equal(jpart, ppart):
            raise AssertionError(f"hash_partition != plain at the join's "
                                 f"side {side} map wave 0")
        jR = hashagg.combine_region_size(key.shape[0], 4)
        got = ck.hash_aggregate(valid, [key], [one], ["add"], jpart, 4, jR)
        want = ck.hash_aggregate_plain(valid, [key], [one], ["add"], jpart,
                                       4, jR)
        results["hash_aggregate"]["max_abs_err"] = max(
            results["hash_aggregate"]["max_abs_err"],
            _check_tables(got, want, 4, jR, f"join side {side} map wave"))
        jkeys = int(got[0].sum())
        jms[side] = bare_aggregate_ms(valid, [key], [one], ["add"], jpart, 4,
                                      jR, jkeys)
        log(f"phase 2: join side {side} map wave 0 (n=2**21, keys over "
            f"2**19, nparts=4, R={jR}): hash_partition bit-equal; "
            f"hash_aggregate kernel {jms[side]:.4f} ms, {jkeys} keys, rows "
            f"equal")
    results["hash_aggregate"]["join_map_wave_ms"] = jms
    mark("join map waves")

    results["probe_add1"] = _probe_timing(device)
    mark("K3")
    log(f"phase 2: sections s {secs}, vector cases s {vec['section_s']}")
    results["section_s"] = secs
    return results


#: Phase 2's vector-value cases of K2: (label, G, rows, nparts, R, key
#: span). Every G up to the boundary takes the kernel's one vector route
#: (each [n, G] row gathered whole into the bucket's [B, G] shared
#: sub-table): 4, 8 and 128 (16-byte loads), 9 (one word a load), and
#: 1814, the most words a 32-slot sub-table holds beside one key lane
#: (one block an SM); 1815 is past it and scattered after the kernel.
#: The G = 8 and G = 128 cases are phase 34's map waves: 34b's 2**21
#: rows into 4 regions of 2**19, 34a's 2**18 k-means points into 4
#: regions of 2**16.
VECTOR_CASES = (
    ("G=4", 4, 1 << 18, 4, 1 << 16, 1 << 16),
    ("G=8 (34b map wave)", 8, 1 << 21, 4, 1 << 19, 1 << 20),
    ("G=9", 9, 1 << 18, 4, 1 << 16, 1 << 16),
    ("G=128 (34a map wave)", 128, 1 << 18, 4, 1 << 16, 1 << 10),
    ("G=1814 (the boundary)", 1814, 1 << 14, 4, 1 << 12, 1 << 12),
)

#: The first G past the boundary: scattered after the kernel.
PAST_BOUNDARY_G = 1815


def _vector_values(gen, n, G, dtype, op, device):
    """[n, G] values of ``dtype`` for ``op``, drawn on the card from
    ``gen``: int32 small for add and over the whole range for max/min;
    float32 normal with -0.0, +0.0 and a sparse NaN (one bit pattern,
    so that either side's NaN is the other's)."""
    if dtype == torch.int32:
        lo, hi = (-1000, 1000) if op == "add" else (-(2**31), 2**31 - 1)
        return torch.randint(lo, hi, (n, G), generator=gen, device=device,
                             dtype=torch.int32)
    v = torch.randn((n, G), generator=gen, device=device)
    v[::41, 0] = -0.0
    v[::43, G - 1] = 0.0
    v[::4099, G // 2] = float("nan")
    return v


def _vector_rows_err(got, want, what, float_add=False) -> float:
    """K2's table against its plain version's, key by key on occupied
    slots (the slot layouts differ): the same keys, each once; int and
    float max/min bits equal; a float add within 1e-4 relative (the
    kernel's atomics add in arrival order). Returns the largest
    absolute difference."""
    if int(got[3]) != 0 or int(want[3]) != 0:
        raise AssertionError(f"hash_aggregate overflow ({what})")
    rows = []
    for present, keys, vals in (got[:3], want[:3]):
        idx = torch.nonzero(present).squeeze(1)
        k = keys[0][idx]
        order = torch.argsort(k)
        rows.append((k[order], [v[idx][order] for v in vals]))
    (gk, gv), (wk, wv) = rows
    if not torch.equal(gk, wk) or torch.unique(gk).shape[0] != gk.shape[0]:
        raise AssertionError(f"hash_aggregate keys differ ({what})")
    err = 0.0
    for a, b in zip(gv, wv):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"hash_aggregate table shapes differ "
                                 f"({what}): {a.shape}, {b.shape}")
        if a.dtype == torch.float32 and float_add:
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-4,
                                  equal_nan=True):
                raise AssertionError(f"hash_aggregate float sums differ "
                                     f"({what})")
            ok = ~(torch.isnan(a) | torch.isnan(b))
            if bool(ok.any()):
                err = max(err, float((a[ok] - b[ok]).abs().max()))
        elif not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"hash_aggregate rows differ ({what})")
    return err


def _phase2_vector(device) -> dict:
    """K2 over [n, G] value columns against its plain version: for each
    ``VECTOR_CASES`` shape, int32 and float32, add, max and min each on
    one column, then a scalar int32 add beside a float32 [n, G] max (a
    value lane beside a value row); one int32 add past the boundary
    (``PAST_BOUNDARY_G``, scattered). Then the spill case at G = 8 and
    G = 128 (keys homed in one bucket's range, as phase 2's scalar spill
    case: pass C combines the spilled rows), the bare kernel, the
    wrapper and the plain version timed at phase 34's two map waves
    (float32 add at G = 128, int32 add at G = 8) and at G = 4, and the
    route against its yardsticks (``_route_pairs``)."""
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    gen = torch.Generator(device=device).manual_seed(34)
    err, out = 0.0, {"cases": [], "times": {}, "section_s": {}}
    t_case = time.perf_counter()

    def mark(what):
        nonlocal t_case
        torch.cuda.synchronize()
        now = time.perf_counter()
        out["section_s"][what] = round(now - t_case, 2)
        t_case = now

    for label, G, n, nparts, R, span in VECTOR_CASES:
        key = torch.randint(0, span, (n,), generator=gen, device=device,
                            dtype=torch.int32)
        valid = torch.rand(n, generator=gen, device=device) < 0.95
        part, _ = ck.hash_partition([key], nparts, 0, with_counts=False)
        route = ck.aggregate_routes([(G,)])[0]
        if route != "kernel":
            raise AssertionError(f"{label}: routed to {route}")
        for dtype in (torch.int32, torch.float32):
            for op in ("add", "max", "min"):
                v = _vector_values(gen, n, G, dtype, op, device)
                args = (valid, [key], [v], [op], part, nparts, R)
                err = max(err, _vector_rows_err(
                    ck.hash_aggregate(*args), ck.hash_aggregate_plain(*args),
                    f"{label} {dtype} {op}", float_add=op == "add"))
        s = torch.randint(-50, 50, (n,), generator=gen, device=device,
                          dtype=torch.int32)
        v = _vector_values(gen, n, G, torch.float32, "max", device)
        args = (valid, [key], [s, v], ["add", "max"], part, nparts, R)
        err = max(err, _vector_rows_err(
            ck.hash_aggregate(*args), ck.hash_aggregate_plain(*args),
            f"{label} scalar int32 add + float32 max"))
        torch.cuda.synchronize()
        log(f"phase 2: hash_aggregate {label} ({route} route), n={n} "
            f"nparts={nparts} R={R} keys over {span}: int32 and float32 "
            f"add/max/min, and a scalar add beside a [n, {G}] max, rows "
            f"equal per key (float add within 1e-4)")
        out["cases"].append(dict(label=label, G=G, n=n, nparts=nparts, R=R,
                                 route=route))
        mark(label)
    # Past the boundary: the kernel places the rows, the rows are
    # scattered whole after it.
    G, n, nparts, R, span = PAST_BOUNDARY_G, 1 << 14, 4, 1 << 12, 1 << 12
    key = torch.randint(0, span, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    part, _ = ck.hash_partition([key], nparts, 0, with_counts=False)
    v = _vector_values(gen, n, G, torch.int32, "add", device)
    args = (valid, [key], [v], ["add"], part, nparts, R)
    route = ck.aggregate_routes([(G,)])[0]
    if route != "scatter":
        raise AssertionError(f"G={G}: routed to {route}")
    err = max(err, _vector_rows_err(
        ck.hash_aggregate(*args), ck.hash_aggregate_plain(*args),
        f"G={G} int32 add"))
    log(f"phase 2: hash_aggregate G={G} (past the boundary: {route}), "
        f"n={n} nparts={nparts} R={R}: int32 add rows equal per key")
    out["cases"].append(dict(label=f"G={G}", G=G, n=n, nparts=nparts, R=R,
                             route=route))
    mark(f"G={G}")
    # The spill case with vector values: pass C places the spilled rows
    # and combines their words into the table with global atomics.
    nparts, R = 4, 1 << 16
    for G in (8, 128):
        skey = _spill_keys(nparts, R, G)
        srng = np.random.RandomState(7)
        skeys = torch.from_numpy(srng.permutation(np.repeat(skey, 3))).to(
            device)
        svalid = torch.ones(skeys.shape[0], dtype=torch.bool, device=device)
        spart, _ = ck.hash_partition([skeys], nparts, 0, with_counts=False)
        sv = torch.randint(-100, 100, (skeys.shape[0], G), generator=gen,
                           device=device, dtype=torch.int32)
        args = (svalid, [skeys], [sv], ["add"], spart, nparts, R)
        got = ck.hash_aggregate(*args)
        err = max(err, _vector_rows_err(got, ck.hash_aggregate_plain(*args),
                                        f"spill case G={G}"))
        if int(got[0].sum()) != len(skey):
            raise AssertionError(f"spill case G={G}: {int(got[0].sum())} "
                                 f"keys placed, not {len(skey)}")
        log(f"phase 2: hash_aggregate spill case at G={G}, {len(skey)} keys "
            f"in one {G}-word bucket's home range: rows equal per key")
    mark("spill")
    # Timings at phase 34's map waves and at G = 4.
    for label, G, dtype, n, R, span in VECTOR_TIMED:
        dtype = getattr(torch, dtype)
        key = torch.randint(0, span, (n,), generator=gen, device=device,
                            dtype=torch.int32)
        v = (torch.randn((n, G), generator=gen, device=device)
             if dtype == torch.float32 else
             _vector_values(gen, n, G, dtype, "add", device))
        valid = torch.ones(n, dtype=torch.bool, device=device)
        part, _ = ck.hash_partition([key], 4, 0, with_counts=False)
        args = (valid, [key], [v], ["add"], part, 4, R)
        got = ck.hash_aggregate(*args)
        nkeys = int(got[0].sum())
        ms, passes = bare_aggregate_ms(valid, [key], [v], ["add"], part, 4,
                                       R, nkeys, by_pass=True)
        wrapper = time_ms(lambda: ck.hash_aggregate(*args))
        plain = time_ms(lambda: ck.hash_aggregate_plain(*args), reps=3,
                        warmup=1)
        bound_bytes = ck.cost("hash_aggregate", n=n, key_itemsizes=(4,),
                              val_itemsizes=(4 * G,), nparts=4, R=R,
                              val_lanes=G)["bytes"]
        if bound_bytes != nbytes(valid, key, v, part, got[0], *got[1],
                                 *got[2]):
            raise AssertionError("hash_aggregate's declared bytes differ "
                                 "from its tensors' (vector values)")
        bound = bound_bytes / HBM_BYTES_PER_S * 1e3
        route = ck.aggregate_routes([(G,)])[0]
        log(f"phase 2: hash_aggregate {label}, n={n} [n, {G}] "
            f"{str(dtype)[6:]} add, nparts=4 R={R} ({route} route): "
            f"kernel {ms:.4f} ms, wrapper {wrapper:.4f} ms (plain {plain:.4f}"
            f" ms, bound {bound:.4f} ms, {bound_bytes} declared bytes, "
            f"{bound / ms:.1%} of it), {nkeys} keys; queued passes ms "
            f"{ {k: round(x, 4) for k, x in passes.items()} }")
        out["times"][label] = dict(G=G, n=n, R=R, route=route, ms=ms,
                                   wrapper_ms=wrapper, plain_ms=plain,
                                   bound_ms=bound, bound_bytes=bound_bytes,
                                   keys=nkeys, pass_ms=passes)
    mark("map-wave times")
    out["routes"] = {}
    for label, G, dtype, n, R, span in VECTOR_TIMED:
        dtype = getattr(torch, dtype)
        rp = _route_pairs(device, gen, G, dtype, n, R, span)
        err = max(err, rp.pop("max_abs_err"))
        out["routes"][label] = rp
        lanes = (f"on {G} contiguous scalar columns {rp['lanes']:.4f} ms "
                 f"(faster than the [n, {G}] column in "
                 f"{rp['lanes_beat_vector']} of {ROUTE_ROUNDS} rounds), "
                 if "lanes" in rp else "")
        log(f"phase 2: hash_aggregate route at {label}, n={n} [n, {G}] "
            f"{str(dtype)[6:]} add, nparts=4 R={R}, {ROUTE_ROUNDS} rounds in "
            f"alternating order, medians of the rounds' medians: the "
            f"wrapper on the [n, {G}] column {rp['vector']:.4f} ms, {lanes}"
            f"the rows placed on the keys alone and scattered whole "
            f"{rp['wide']:.4f} ms; the [n, {G}] column faster than the "
            f"scatter in {rp['vector_beats_wide']} of {ROUTE_ROUNDS} "
            f"rounds; rows equal per key")
    mark("routes")
    out["max_abs_err"] = err
    return out


#: Rounds of ``_route_pairs``.
ROUTE_ROUNDS = 10


#: Phase 2's timed vector shapes: (label, G, dtype name, rows, R, key
#: span), 4 regions each; 34a and 34b are phase 34's map waves. (Names,
#: not torch dtypes: a parse-pool worker imports this script without
#: torch.)
VECTOR_TIMED = (
    ("34a", 128, "float32", 1 << 18, 1 << 16, 1 << 10),
    ("34b", 8, "int32", 1 << 21, 1 << 19, 1 << 20),
    ("G=4", 4, "int32", 1 << 18, 1 << 16, 1 << 16),
)


def _route_pairs(device, gen, G, dtype, n, R, span) -> dict:
    """K2 at one [n, G] add shape, computed up to three ways and timed
    in ``ROUTE_ROUNDS`` rounds whose order alternates (each round's times
    the median of 5 runs between CUDA events): ``vector``, the wrapper on
    the [n, G] column (the kernel's vector route); ``wide``, the kernel
    placing the rows on the keys alone, then the whole rows scattered
    into their slots (``dense._scatter_tables``, the route of the columns
    the kernel does not combine); and at G <= 8 ``lanes``, the wrapper
    on G contiguous scalar columns of the same values (the kernel holds
    G value lanes; the copy into them is not timed). The tables are
    checked equal per key (float sums within 1e-4: atomics add in
    arrival order)."""
    from bigslice_tpu_torch.parallel import cuda_kernels as ck
    from bigslice_tpu_torch.parallel.dense import _scatter_tables

    nparts, T = 4, 4 * R
    key = torch.randint(0, span, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    v = (torch.randn((n, G), generator=gen, device=device)
         if dtype == torch.float32 else
         _vector_values(gen, n, G, dtype, "add", device))
    float_add = dtype == torch.float32
    valid = torch.ones(n, dtype=torch.bool, device=device)
    part, _ = ck.hash_partition([key], nparts, 0, with_counts=False)
    plan = ck.aggregate_plan(1, 0, nparts, R, n, row_lane=True)
    lib = ck.build()

    def vector():
        return ck.hash_aggregate(valid, [key], [v], ["add"], part, nparts,
                                 R)

    def wide():
        buf = ck.aggregate_buffers(plan, [key], [], T, device, placed=True)
        rc = lib.bs_hash_aggregate(*ck.aggregate_args(
            valid, [key], [], [], part, nparts, R, 0, plan, buf))
        if rc:
            raise RuntimeError(f"hash_aggregate: CUDA error {rc}")
        idx = torch.where(buf.placed >= 0, buf.placed, T)
        _, t = _scatter_tables(idx, [v], ["add"], T + 1)
        return buf.present, buf.out_keys, [t[0][:T]], buf.overflow

    fns = {"vector": vector, "wide": wide}
    want = vector()
    err = _vector_rows_err(wide(), want, f"G={G} wide", float_add)
    if G <= ck.MAX_COLS:
        lanes = [v[:, j].contiguous() for j in range(G)]

        def by_lanes():
            p, k, t, o = ck.hash_aggregate(valid, [key], lanes, ["add"] * G,
                                           part, nparts, R)
            return p, k, [torch.stack(t, 1)], o

        fns["lanes"] = by_lanes
        err = max(err, _vector_rows_err(by_lanes(), want, f"G={G} lanes",
                                        float_add))
    rounds = {k: [] for k in fns}
    for r in range(ROUTE_ROUNDS):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            rounds[k].append(time_ms(fns[k], reps=5, warmup=1))
    out = {k: statistics.median(t) for k, t in rounds.items()}
    out.update(
        rounds=rounds, max_abs_err=err,
        vector_beats_wide=sum(a < b for a, b in zip(rounds["vector"],
                                                    rounds["wide"])))
    if "lanes" in rounds:
        out["lanes_beat_vector"] = sum(
            a < b for a, b in zip(rounds["lanes"], rounds["vector"]))
    return out


def _spill_keys(nparts, R, G: int = 1) -> np.ndarray:
    """Half as many keys again as one bucket of a one-key table with one
    value lane (``G`` = 1), or one [n, G] value row, has slots, all of
    partition 1 with their home slots in bucket 3 of its region."""
    from bigslice_tpu_torch.parallel import cuda_kernels as ck
    from bigslice_tpu_torch.parallel import hashagg

    plan = (ck.aggregate_plan(1, 1, nparts, R, 0) if G == 1 else
            ck.aggregate_plan(1, 0, nparts, R, 0, row_words=G))
    B = 1 << plan.bucket_log2
    cand = torch.arange(1 << 22, dtype=torch.int32)
    part, _ = ck.hash_partition_plain([cand], nparts, 0, with_counts=False)
    home = (hashagg._slot_hash([cand], 0) & (R - 1)) >> plan.bucket_log2
    keys = cand[(part == 1) & (home == 3)][:B + B // 2].numpy()
    if len(keys) != B + B // 2 or len(keys) >= R // 4:
        raise AssertionError("spill case: too few candidate keys")
    return keys


def _reduce_side_input(device):
    """Reduce wave 0's input on the main path: the four map waves of
    phase 3's reduce-wave run through the fused combine + shuffle,
    their rows of partition 0 in wave order and slot order
    (``MeshExecutor._merge_outputs``), packed into a buffer of
    ``bucket_size`` of the largest partition's rows
    (``_build_wave_views``). Returns ``(valid, key, val, rows)``."""
    from bigslice_tpu_torch.parallel import hashagg

    S, n = 4, 1 << 25
    keys = np.random.RandomState(42).randint(0, 1 << 20, n).astype(np.int32)
    body = hashagg.make_hash_combine_shuffle(1, 1, 1, ["add"], nparts=S)
    outs = []
    for chunk in np.split(keys, S):
        k = torch.from_numpy(chunk).to(device)
        mask, overflow, cols = body(torch.ones_like(k, dtype=torch.bool), k,
                                    torch.ones_like(k))
        if int(overflow) != 0:
            raise AssertionError("map-side table overflowed")
        outs.append((mask, *cols))
    return _wave0_input(outs, S, device)


def _overflow_reduce_input(keys, device):
    """Reduce wave 0's input in phase 6: its four map waves on the sort
    path (fused sort combine + shuffle at the slack a combiner starts
    with), packed as ``_reduce_side_input`` packs them."""
    from bigslice_tpu_torch.parallel import segment, shuffle

    S = 4
    body = shuffle.make_combine_shuffle_fn(
        1, 1, 1, segment.canonical_combine(lambda a, b: a + b, 1),
        slack=1.0, nparts=S)
    outs = []
    for chunk in np.split(keys, S):
        k = torch.from_numpy(chunk).to(device)
        mask, overflow, bad, cols = body(
            torch.ones_like(k, dtype=torch.bool), k, torch.ones_like(k))
        if int(overflow) != 0 or int(bad) != 0:
            raise AssertionError("phase 6's sort shuffle overflowed")
        outs.append((mask, *cols))
    return _wave0_input(outs, S, device)


def _wave0_input(outs, S, device):
    """Partition 0's rows of the map waves' outputs ``[(mask, subid, key,
    val)]``, in wave order and slot order, front-packed into a buffer
    of ``bucket_size`` of the largest partition's rows. Returns
    ``(valid, key, val, rows)``."""
    from bigslice_tpu_torch.parallel.jitutil import bucket_size

    per = torch.zeros(S, dtype=torch.int64, device=device)
    rows_k, rows_v = [], []
    for mask, subid, out_k, out_v in outs:
        per += torch.bincount(subid[mask].to(torch.int64), minlength=S)
        sel = torch.nonzero(mask & (subid == 0)).squeeze(1)
        rows_k.append(out_k[sel])
        rows_v.append(out_v[sel])
    rk, rv = torch.cat(rows_k), torch.cat(rows_v)
    rn = rk.shape[0]
    cap = bucket_size(int(per.max()))
    key = torch.zeros(cap, dtype=torch.int32, device=device)
    val = torch.zeros(cap, dtype=torch.int32, device=device)
    key[:rn], val[:rn] = rk, rv
    valid = torch.arange(cap, device=device) < rn
    return valid, key, val, rn


def _overflow_keys() -> np.ndarray:
    """Phase 6's keys: 2**22 - 2**18 distinct int32 keys that all route
    to partition 0 of 4, the first 2**18 of them twice, shuffled."""
    from bigslice_tpu_torch.parallel.cuda_kernels import hash_partition_plain

    ndistinct = (1 << 22) - (1 << 18)
    cand = torch.arange(1 << 24, dtype=torch.int32)
    part, _ = hash_partition_plain([cand], 4, 0, with_counts=False)
    distinct = cand[part == 0][:ndistinct].numpy()
    if len(distinct) != ndistinct:
        raise AssertionError("overflow-fallback: too few candidate keys")
    rng = np.random.RandomState(6)
    return rng.permutation(np.concatenate([distinct,
                                           distinct[:1 << 18]]))


def _sortshuffle_keys() -> np.ndarray:
    """Phase 7's keys: 2**24 int32 keys uniform over 2**30."""
    return np.random.RandomState(11).randint(0, 1 << 30,
                                             1 << 24).astype(np.int32)


def _join_keys():
    """The join paths' keys (the JAX package's ``bench.py join``
    scenario): 2**23 int32 keys a side, uniform over 2**19, side A from
    RandomState(1) and side B from RandomState(2)."""
    n = 1 << 23
    return tuple(np.random.RandomState(seed).randint(0, n // 16, n).astype(
        np.int32) for seed in (1, 2))


def _join_sort_values():
    """Phase 9's int32 values, side A's then side B's, from
    RandomState(3)."""
    rng = np.random.RandomState(3)
    n = 1 << 23
    return tuple(rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32)
                 for _ in "ab")


def _groupby_input():
    """Phase 10's rows: 2**22 int32 keys uniform over 2**17 (mean group
    32) and int32 values in [1, 100), from RandomState(19)."""
    rng = np.random.RandomState(19)
    n = 1 << 22
    return (rng.randint(0, 1 << 17, n).astype(np.int32),
            rng.randint(1, 100, n).astype(np.int32))


def _probe_timing(device) -> dict:
    """K3, the build probe: its launch latency beside ``x + 1``, the one
    PyTorch call that computes the same function."""
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    x = torch.zeros((8, 128), dtype=torch.int32, device=device)
    add1 = _launcher(ck.build().bs_probe_add1,
                     (x.data_ptr(), x.numel(),
                      torch.cuda.current_stream(device).cuda_stream),
                     "probe_add1")
    ms3 = time_ms(add1)
    plain3 = time_ms(lambda: x + 1)
    # The floor of any launch: one kernel that does nothing (torch's
    # busy-wait for 0 cycles), timed the same way.
    empty = time_ms(lambda: torch.cuda._sleep(0))
    log(f"phase 2: probe_add1: kernel {ms3:.4f} ms (x + 1: {plain3:.4f} "
        f"ms; one empty kernel launch: {empty:.4f} ms)")
    return dict(
        max_abs_err=0, ms=ms3, plain_ms=plain3,
        bound_ms=ck.cost("probe_add1", numel=x.numel())["bytes"]
        / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=plain3, empty_launch_ms=empty, shape="(8, 128) int32",
    )


def _check_tables(got, want, nparts, R, what) -> float:
    """Kernel table vs plain table: overflow 0 in both, the same sorted
    occupied rows (float bits exact: no float add here), and the region
    invariant (every occupied slot's region is its key's partition)."""
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    if int(got[3]) != 0 or int(want[3]) != 0:
        raise AssertionError(f"hash_aggregate overflow ({what})")
    a, b = _rows(*got[:3]), _rows(*want[:3])
    if a.shape != b.shape or not np.array_equal(a, b):
        raise AssertionError(f"hash_aggregate rows differ ({what})")
    slots = torch.nonzero(got[0]).squeeze(1)
    occupied = [k[slots] for k in got[1]]
    rp, _ = ck.hash_partition_plain(occupied, nparts, 0, with_counts=False)
    if not torch.equal((slots // R).to(torch.int32), rp):
        raise AssertionError(f"hash_aggregate region invariant ({what})")
    return float(np.abs(a - b).max()) if a.size else 0.0


def _check_overflowed(got, want, valid, key, val, nparts, R, what
                      ) -> dict:
    """Kernel and plain table where the rows cannot all be placed: both
    must report overflow, and each table must agree with its count —
    distinct keys, each of the input, in its partition's region and
    holding at most its key's total (the values are positive), and the
    overflow as many rows as the totals left out of the table need:
    every row of a key the table lacks, and for a key held short at
    least one of its rows and not all."""
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    k_in, v_in = key[valid], val[valid].to(torch.int64)
    uk, inv = torch.unique(k_in, return_inverse=True)
    total = torch.zeros(uk.shape[0], dtype=torch.int64,
                        device=k_in.device).index_add_(0, inv, v_in)
    nrows = torch.bincount(inv, minlength=uk.shape[0])
    counts = {}
    for name, (present, ok, ovs, ov) in (("kernel", got), ("plain", want)):
        ov = int(ov)
        counts[name] = ov
        if ov <= 0:
            raise AssertionError(f"hash_aggregate ({name}) reports no "
                                 f"overflow ({what})")
        slots = torch.nonzero(present).squeeze(1)
        tk, tv = ok[0][slots], ovs[0][slots].to(torch.int64)
        pos = torch.searchsorted(uk, tk).clamp(max=uk.shape[0] - 1)
        if torch.unique(tk).shape[0] != tk.shape[0] or not bool(
                (uk[pos] == tk).all()):
            raise AssertionError(f"hash_aggregate ({name}) table keys are "
                                 f"repeated or not of the input ({what})")
        if not bool(((tv > 0) & (tv <= total[pos])).all()):
            raise AssertionError(f"hash_aggregate ({name}) values exceed "
                                 f"their keys' totals ({what})")
        rp, _ = ck.hash_partition_plain([tk], nparts, 0, with_counts=False)
        if not torch.equal((slots // R).to(torch.int32), rp):
            raise AssertionError(f"hash_aggregate ({name}) region "
                                 f"invariant ({what})")
        held = torch.zeros_like(total)
        held[pos] = tv
        lacks, short = held == 0, (held > 0) & (held < total)
        lo = int(nrows[lacks].sum()) + int(short.sum())
        hi = int(nrows[lacks].sum()) + int((nrows[short] - 1).sum())
        if not lo <= ov <= hi:
            raise AssertionError(
                f"hash_aggregate ({name}) overflow {ov} is not the "
                f"{lo}..{hi} rows left out of the table ({what})")
    return counts


def _shard_keys_routed(shards, S) -> None:
    from bigslice_tpu_torch.parallel.cuda_kernels import hash_partition_plain

    for s, cols in enumerate(shards):
        if len(cols[0]):
            ids, _ = hash_partition_plain([torch.from_numpy(cols[0])], S)
            if not bool((ids == s).all()):
                raise AssertionError(f"shard {s} holds rows of another "
                                     f"partition")


def phase3_slice(card: str) -> dict:
    """The main path: Session(executor=MeshExecutor(auto_dense=False))
    .run(Reduce(Const(4, keys, ones), add)) at the reduce-wave shape,
    then a max/min Reduce, both checked. Discovery is off so that both
    keep K2's lowering on both sides (at the default the map side takes
    the sort and the reduce side a dense table: phase 21)."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    S = 4
    n = 1 << 25
    span = 1 << 20
    keys = np.random.RandomState(42).randint(0, span, n).astype(np.int32)
    ones = np.ones(n, np.int32)
    bc = np.bincount(keys, minlength=span)

    def run_count():
        """Build the session, run, and read every shard's rows back to
        the host: what a user of the system waits for."""
        res = bs.Session(executor=bs.MeshExecutor(auto_dense=False)).run(
            bs.Reduce(bs.Const(S, keys, ones), lambda a, b: a + b))
        for shard in range(S):
            list(res.reader(shard, ()))
        return res

    def check_counts(res) -> int:
        shards = bs.result_shard_rows(res)
        allk = np.concatenate([s[0] for s in shards])
        allv = np.concatenate([s[1] for s in shards])
        present = np.nonzero(bc)[0]
        order = np.argsort(allk)
        if not (np.array_equal(allk[order], present)
                and np.array_equal(allv[order], bc[present])):
            raise AssertionError("reduce-wave counts differ from np.bincount")
        _shard_keys_routed(shards, S)
        return len(allk)

    # The counted run: the process's first run of the main path, whose
    # executor runs the probe kernel (cached per process after it).
    ck.reset_launches()
    res = run_count()
    launches = dict(ck.LAUNCHES)
    check_counts(res)
    shards = bs.result_shard_rows(res)  # host copies, for phase 16
    # Free the counted run's result (and its session's reference
    # cycles) before the peak is reset, as each warm run's is.
    del res
    gc.collect()
    for name in PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the main path")
    # The timed runs: warm (combine classification and the allocator's
    # growth done), the probe not run again; the wall is their median,
    # since the host's staging copies spread from run to run.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(WARM_RUNS):
        ck.reset_launches()
        t0 = time.perf_counter()
        res = run_count()
        walls.append(time.perf_counter() - t0)
        warm = dict(ck.LAUNCHES)
        if warm != dict(launches, probe_add1=0):
            raise AssertionError(f"warm run launched {warm}, the first run "
                                 f"{launches}")
        nkeys = check_counts(res)
        # Free this run's result (and the session's reference cycles)
        # first: the next run's allocations then come from the
        # allocator's cache, as in the first warm run.
        del res
        gc.collect()
    wall = statistics.median(walls)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 3: reduce-wave {n} rows, S={S}: warm wall {wall:.4f} s "
        f"(median of {WARM_RUNS}: {', '.join(f'{w:.4f}' for w in walls)}), "
        f"{n / wall:.1f} rows/s, {nkeys} keys, launches {launches} "
        f"(first run; each warm run {warm}), "
        f"peak device memory {peak:.3f} GiB, on {card}")

    # A second Reduce: float32 max and int32 min per key.
    n2 = 1 << 24
    rng = np.random.RandomState(43)
    k2 = rng.randint(0, span, n2).astype(np.int32)
    fv = rng.randn(n2).astype(np.float32)
    iv = rng.randint(-(2**31), 2**31 - 1, n2).astype(np.int32)

    def run_maxmin():
        res = bs.Session(executor=bs.MeshExecutor(auto_dense=False)).run(
            bs.Reduce(bs.Const(S, k2, fv, iv),
                      lambda a, b: (torch.maximum(a[0], b[0]),
                                    torch.minimum(a[1], b[1]))))
        for shard in range(S):
            list(res.reader(shard, ()))
        return res

    run_maxmin()
    walls2 = []
    res2 = None
    for _ in range(WARM_RUNS):
        res2 = None
        gc.collect()
        ck.reset_launches()
        t0 = time.perf_counter()
        res2 = run_maxmin()
        walls2.append(time.perf_counter() - t0)
    wall2 = statistics.median(walls2)
    launches2 = dict(ck.LAUNCHES)
    shards2 = bs.result_shard_rows(res2)
    if any(launches2[name] <= 0 for name in ("hash_partition",
                                             "hash_aggregate")):
        raise AssertionError("max/min Reduce did not launch the kernels")
    fmax = np.full(span, -np.inf, np.float32)
    np.maximum.at(fmax, k2, fv)
    imin = np.full(span, 2**31 - 1, np.int32)
    np.minimum.at(imin, k2, iv)
    gk = np.concatenate([s[0] for s in shards2])
    gf = np.concatenate([s[1] for s in shards2])
    gi = np.concatenate([s[2] for s in shards2])
    seen = np.unique(k2)
    order = np.argsort(gk)
    if not (np.array_equal(gk[order], seen)
            and np.array_equal(gf[order].view(np.int32),
                               fmax[seen].view(np.int32))
            and np.array_equal(gi[order], imin[seen])):
        raise AssertionError("max/min Reduce differs from numpy group-by")
    _shard_keys_routed(shards2, S)
    log(f"phase 3: max/min Reduce {n2} rows: warm wall {wall2:.4f} s "
        f"(median of {WARM_RUNS}: {', '.join(f'{w:.4f}' for w in walls2)}), "
        f"{n2 / wall2:.1f} rows/s, launches {launches2} (the last run), on "
        f"{card}")
    return dict(launches=launches, wall_s=wall, walls_s=walls, rows=n,
                rows_per_s=n / wall, maxmin_wall_s=wall2,
                maxmin_walls_s=walls2, maxmin_rows=n2, peak_gib=peak,
                shards=shards)


def drive(phase: str, label: str, make_slice, check, need, rows: int,
          card: str, expect=None, auto_dense: bool = True,
          warm: int = WARM_RUNS) -> dict:
    """One path through ``Session().run``: a counted first run (launch
    counts set to 0 just before, read just after; every kernel in
    ``need`` must have launched, and each kernel in ``expect`` exactly
    that many times), then ``warm`` warm runs whose
    median wall is reported. A run is session construction, the run and
    reading every shard back to the host; ``check(session, result)``
    holds each run's output against numpy and raises on a mismatch. Peak
    device memory is the largest over the warm runs, checks excluded.
    ``make_slice()`` returns a Slice, or a tuple ``(func, *args)`` that
    ``Session.run`` takes. The counted run's device fold steps
    (``segment.FOLD_STEPS``) are returned beside its launches. The
    session's executor is ``MeshExecutor(auto_dense=auto_dense)``."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.parallel import cuda_kernels as ck
    from bigslice_tpu_torch.parallel import segment

    def run():
        sess = bs.Session(executor=bs.MeshExecutor(auto_dense=auto_dense))
        made = make_slice()
        res = sess.run(*made) if isinstance(made, tuple) else sess.run(made)
        for shard in range(res.num_shards):
            list(res.reader(shard, ()))
        return sess, res

    ck.reset_launches()
    segment.reset_fold_steps()
    sess, res = run()
    launches = dict(ck.LAUNCHES)
    fold_steps = dict(segment.FOLD_STEPS)
    for name in need:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: {name} was not launched")
    for name, want in (expect or {}).items():
        if launches[name] != want:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launches[name]} times, not {want}")
    note = check(sess, res)
    del sess, res
    walls, peaks = [], []
    for _ in range(warm):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sess, res = run()
        walls.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        check(sess, res)
        del sess, res
    gc.collect()
    wall = statistics.median(walls)
    log(f"phase {phase}: {label}, {rows} rows: warm wall {wall:.4f} s "
        f"(median of {warm}: {', '.join(f'{w:.4f}' for w in walls)}), "
        f"{rows / wall:.1f} rows/s, peak device memory {max(peaks):.3f} GiB, "
        f"launches {launches} (first run){note or ''}, on {card}")
    return dict(launches=launches, wall_s=wall, walls_s=walls, rows=rows,
                rows_per_s=rows / wall, peak_gib=max(peaks),
                fold_steps=fold_steps)


def _lww_fn(a, b):
    """Keep the latest record per key: max timestamp, its value."""
    return (torch.maximum(a[0], b[0]), torch.where(a[0] >= b[0], a[1], b[1]))


def phase4_lww(card: str) -> dict:
    """lww-wave: Const -> Map (fold keys to 2**20) -> Filter (timestamp
    watermark) -> Reduce keeping the latest record per key, at the
    reduce-wave shape (2**25 rows, S = 4). The combine fn does not
    classify, so the map side is the fused sort combine + shuffle routed
    by K1 and the reduce side the segmented reduce."""
    import bigslice_tpu_torch as bs

    S, n, mark = 4, 1 << 25, 1 << 22
    rng = np.random.RandomState(42)
    keys = rng.randint(0, 1 << 24, n).astype(np.int32)
    ts = rng.permutation(n).astype(np.int32)
    vals = rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32)
    # numpy: one sort of (folded key, ts); each key's last row is its
    # latest record (ts values are distinct).
    sel = ts >= mark
    comb = ((keys[sel] & 0xFFFFF).astype(np.int64) << 25) | ts[sel]
    comb.sort()
    kk = comb >> 25
    last = np.r_[kk[1:] != kk[:-1], True]
    want_k = kk[last].astype(np.int32)
    want_t = (comb[last] & ((1 << 25) - 1)).astype(np.int32)
    row_of_ts = np.empty(n, np.int64)
    row_of_ts[ts] = np.arange(n)
    want_v = vals[row_of_ts[want_t]]
    del comb, kk, row_of_ts

    def make():
        s = bs.Map(bs.Const(S, keys, ts, vals),
                   lambda k, t, v: (k & 0xFFFFF, t, v))
        s = bs.Filter(s, lambda k, t, v: t >= mark)
        return bs.Reduce(s, _lww_fn)

    def check(sess, res):
        shards = bs.result_shard_rows(res)
        got = [np.concatenate([sh[j] for sh in shards]) for j in range(3)]
        order = np.argsort(got[0])
        if not (np.array_equal(got[0][order], want_k)
                and np.array_equal(got[1][order], want_t)
                and np.array_equal(got[2][order], want_v)):
            raise AssertionError("lww-wave rows differ from numpy")
        _shard_keys_routed(shards, S)
        return f", {len(want_k)} keys"

    return drive("4", "lww-wave (Map, Filter, last-writer-wins Reduce)",
                 make, check, ("hash_partition",), n, card)


def phase5_float_key(card: str) -> dict:
    """float-key: a counting Reduce over float32 keys (2**16 distinct
    normal draws with 0.0, -0.0 and NaN rows) on the sort lowering; K1
    hashes the float keys."""
    import bigslice_tpu_torch as bs

    S, n = 4, 1 << 24
    rng = np.random.RandomState(5)
    pool = rng.randn(1 << 16).astype(np.float32)
    keys = pool[rng.randint(0, 1 << 16, n)]
    pos = rng.permutation(n)
    keys[pos[:1 << 12]] = 0.0
    keys[pos[1 << 12:1 << 13]] = -0.0
    keys[pos[1 << 13:(1 << 13) + (1 << 10)]] = np.nan
    ones = np.ones(n, np.int32)
    nan_in = np.isnan(keys)
    want_k, want_c = np.unique(np.where(keys == 0, np.float32(0),
                                        keys)[~nan_in], return_counts=True)
    zeros = int((keys == 0).sum())

    def check(sess, res):
        shards = bs.result_shard_rows(res)
        k = np.concatenate([sh[0] for sh in shards])
        c = np.concatenate([sh[1] for sh in shards])
        nan = np.isnan(k)
        if nan.sum() != nan_in.sum() or not (c[nan] == 1).all():
            raise AssertionError("float-key: NaN rows did not come back "
                                 "alone")
        if (k == 0).sum() != 1 or int(c[k == 0][0]) != zeros:
            raise AssertionError("float-key: +-0.0 are not one key")
        k, c = k[~nan], c[~nan]
        order = np.argsort(k)
        if not (np.array_equal(np.where(k == 0, np.float32(0), k)[order],
                               want_k)
                and np.array_equal(c[order], want_c)):
            raise AssertionError("float-key counts differ from numpy")
        _shard_keys_routed(shards, S)
        return None

    return drive("5", "float-key (Reduce over float32 keys)",
                 lambda: bs.Reduce(bs.Const(S, keys, ones),
                                   lambda a, b: a + b),
                 check, ("hash_partition",), n, card)


def phase6_overflow(card: str) -> dict:
    """overflow-fallback: near-distinct keys that all route to
    partition 0 overflow the map side's hash table on the first attempt;
    the executor reruns the wave on the sort path and keeps the op there
    (``MeshExecutor.hash_off``).

    Launches under the default pipeline (prefetch depth 1, one wave in
    flight): map wave 1 is dispatched on the hash path before wave 0's
    overflow is read, so both overflow and rerun on the sort path —
    K1: w0 and w1 on the hash path, their two reruns, w2 and w3 on the
    sort path, 6; K2: the two map attempts. The reduce side likewise:
    its wave 1 (empty partition 1, in a buffer of partition 0's
    capacity) is dispatched on the hash path before wave 0 overflows,
    so K2 launches twice there: 4 in all. The serial loop counted 5 and
    2. Both sites end in ``hash_off``: the map side's and the reduce
    side's."""
    import bigslice_tpu_torch as bs

    S = 4
    keys = _overflow_keys()
    ones = np.ones(len(keys), np.int32)
    want_k, want_c = np.unique(keys, return_counts=True)

    def check(sess, res):
        off = sorted(sess.executor.hash_off)
        if sorted(op.split("@")[0] for op in off) != ["const", "reduce"]:
            raise AssertionError(f"overflow-fallback: the sites on the "
                                 f"sort path are {off}, not the map side's "
                                 f"and the reduce side's")
        shards = bs.result_shard_rows(res)
        k = np.concatenate([sh[0] for sh in shards])
        c = np.concatenate([sh[1] for sh in shards])
        order = np.argsort(k)
        if not (np.array_equal(k[order], want_k)
                and np.array_equal(c[order], want_c)):
            raise AssertionError("overflow-fallback counts differ from "
                                 "numpy")
        _shard_keys_routed(shards, S)
        return f", on the sort path after overflow: {off}"

    return drive("6", "overflow-fallback (hash table overflow, sort retry)",
                 lambda: bs.Reduce(bs.Const(S, keys, ones),
                                   lambda a, b: a + b),
                 check, ("hash_partition", "hash_aggregate"), len(keys),
                 card, expect={"hash_partition": 6, "hash_aggregate": 4})


def phase7_sortshuffle(card: str) -> dict:
    """sortshuffle: Reshuffle(Const(4, keys)), 2**24 keys uniform over
    2**30; each partition read back and sorted on the card with
    ``Frame.sorted_by_key``."""
    import bigslice_tpu_torch as bs

    S = 4
    keys = _sortshuffle_keys()
    want = np.sort(keys)

    def check(sess, res):
        parts = []
        for shard in range(S):
            frames = list(res.reader(shard, ()))
            k = np.zeros(0, np.int32)
            if frames:
                f = bs.Frame.concat(frames)
                f = bs.Frame([c.to("cuda") for c in f.cols],
                             f.schema).sorted_by_key()
                dk = f.cols[0]
                if not bool((dk[1:] >= dk[:-1]).all()):
                    raise AssertionError(f"sortshuffle: partition {shard} "
                                         f"is not sorted")
                k = dk.cpu().numpy()
            parts.append((k,))
        # Routing against the plain version, not the kernel that routed.
        _shard_keys_routed(parts, S)
        if not np.array_equal(np.sort(np.concatenate(
                [p[0] for p in parts])), want):
            raise AssertionError("sortshuffle rows differ from the input")
        return None

    return drive("7", "sortshuffle (Reshuffle, partitions sorted on the "
                 "card)", lambda: bs.Reshuffle(bs.Const(S, keys)), check,
                 ("hash_partition",), len(keys), card)


def _group_sums(keys, vals, fn):
    """Per distinct key (ascending): the key, its row count and ``fn``
    (a numpy ufunc) reduced over its int32 values, wrapping as int32
    arithmetic does."""
    order = np.argsort(keys, kind="stable")
    sk, sv = keys[order], vals[order]
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    return (sk[starts], np.diff(np.r_[starts, len(sk)]),
            fn.reduceat(sv, starts).astype(np.int32))


def _join_check(ak, av, bk, bv, fa, fb, label):
    """``check`` of a join path: every output row against numpy (keys
    present in both sides, each side's values reduced by its fn), each
    row in the shard the plain K1 names, and no op site on the sort path
    after an overflow."""
    import bigslice_tpu_torch as bs

    ka, _, ra = _group_sums(ak, av, fa)
    kb, _, rb = _group_sums(bk, bv, fb)
    both, ia, ib = np.intersect1d(ka, kb, assume_unique=True,
                                  return_indices=True)
    want_a, want_b = ra[ia], rb[ib]

    def check_rows(shards):
        k, a, b = (np.concatenate([sh[j] for sh in shards])
                   for j in range(3))
        order = np.argsort(k)
        if not (np.array_equal(k[order], both)
                and np.array_equal(a[order], want_a)
                and np.array_equal(b[order], want_b)):
            raise AssertionError(f"{label} rows differ from numpy")
        _shard_keys_routed(shards, 4)

    def check(sess, res):
        if sess.executor.hash_off:
            raise AssertionError(f"{label}: sites on the sort path after "
                                 f"an overflow: {sorted(sess.executor.hash_off)}")
        check_rows(bs.result_shard_rows(res))
        return f", {len(both)} matched keys, hash_off empty"

    check.rows = check_rows
    return check


def phase8_join(card: str) -> dict:
    """join: the JAX package's ``bench.py join`` scenario, not cut —
    JoinAggregate(Const(4, ak, ones), Const(4, bk, ones), add, add) over
    2**23 keys a side. Both sides' map waves combine through K2 and
    route through K1; the join group takes the hash join (one claim
    cascade over both sides' rows)."""
    import bigslice_tpu_torch as bs

    S = 4
    ak, bk = _join_keys()
    ones = np.ones(len(ak), np.int32)

    def make():
        return bs.JoinAggregate(bs.Const(S, ak, ones), bs.Const(S, bk, ones),
                                lambda x, y: x + y, lambda x, y: x + y)

    return drive("8", "join (JoinAggregate, hash join)", make,
                 _join_check(ak, ones, bk, ones, np.add, np.add, "join"),
                 ("hash_partition", "hash_aggregate"), 2 * len(ak), card,
                 expect={"hash_partition": 2 * S, "hash_aggregate": 2 * S})


def phase9_join_sort(card: str) -> dict:
    """join-sort: the same keys with int32 values from RandomState(3);
    side A adds (K2 on its map waves), side B xors, which does not
    classify (the sort combine on its map waves), so the join group runs
    two segmented reduces and the tagged-sort alignment."""
    import bigslice_tpu_torch as bs

    S = 4
    ak, bk = _join_keys()
    av, bv = _join_sort_values()

    def make():
        return bs.JoinAggregate(bs.Const(S, ak, av), bs.Const(S, bk, bv),
                                lambda x, y: x + y, lambda x, y: x ^ y)

    return drive("9", "join-sort (JoinAggregate, add and xor: tagged-sort "
                 "alignment)", make,
                 _join_check(ak, av, bk, bv, np.add, np.bitwise_xor,
                             "join-sort"),
                 ("hash_partition", "hash_aggregate"), 2 * len(ak), card,
                 expect={"hash_partition": 2 * S, "hash_aggregate": S})


def phase10_groupby(card: str) -> dict:
    """groupby: Map(GroupByKey(Const(4, keys, vals), capacity=64),
    lambda k, g, c: (k, g.sum(), c)) over 2**22 rows, keys uniform over
    2**17 (mean group 32). Counts are checked exactly for every key;
    sums exactly where count <= 64; a group with count > 64 must keep
    exactly 64 of its values: the first 64 in arrival order, which on
    one card is input order (shards are contiguous ranges of the input,
    waves arrive in shard order, the shuffle and the sort are stable)."""
    import bigslice_tpu_torch as bs

    S, G = 4, 64
    keys, vals = _groupby_input()
    order = np.argsort(keys, kind="stable")
    sk, sv = keys[order], vals[order].astype(np.int64)
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    want_k = sk[starts]
    want_c = np.diff(np.r_[starts, len(sk)])
    csum = np.r_[0, np.cumsum(sv)]
    want_s = csum[starts + np.minimum(want_c, G)] - csum[starts]
    ntrunc = int((want_c > G).sum())

    def make():
        g = bs.GroupByKey(bs.Const(S, keys, vals), capacity=G)
        return bs.Map(g, lambda k, grp, cnt: (k, grp.sum(), cnt))

    def check(sess, res):
        if sess.executor.hash_off:
            raise AssertionError("groupby: a site went to the sort path")
        shards = bs.result_shard_rows(res)
        k, sm, c = (np.concatenate([sh[j] for sh in shards])
                    for j in range(3))
        o = np.argsort(k)
        k, sm, c = k[o], sm[o], c[o]
        if not (np.array_equal(k, want_k) and np.array_equal(c, want_c)):
            raise AssertionError("groupby keys or counts differ from numpy")
        if not np.array_equal(sm, want_s):
            raise AssertionError("groupby sums differ from numpy (the full "
                                 "sum where count <= 64, the first 64 "
                                 "values' where truncated)")
        _shard_keys_routed(shards, S)
        return (f", {len(want_k)} groups, {ntrunc} truncated at {G}, "
                f"hash_off empty")

    return drive("10", "groupby (GroupByKey capacity 64, Map over the "
                 "[64] vectors)", make, check, ("hash_partition",),
                 len(keys), card,
                 expect={"hash_partition": S, "hash_aggregate": 0})


def _reduce_wave_input(n=1 << 25, span=1 << 20):
    """Phase 3's reduce-wave rows: 2**25 int32 keys uniform over 2**20
    from RandomState(42), each counted once."""
    keys = np.random.RandomState(42).randint(0, span, n).astype(np.int32)
    return keys, np.ones(n, np.int32)


def _same_rows(got, want, what) -> None:
    """Bit-equality of two ``result_shard_rows``."""
    if len(got) != len(want) or any(
            g.dtype != w.dtype or g.tobytes() != w.tobytes()
            for gs, ws in zip(got, want) for g, w in zip(gs, ws)):
        raise AssertionError(f"{what}: rows differ")


def _count_check(keys, span=1 << 20):
    """Rows of a counting Reduce against np.bincount, and each row in the
    shard the plain K1 names."""
    bc = np.bincount(keys, minlength=span)
    present = np.nonzero(bc)[0]

    def check(shards, S):
        k = np.concatenate([s[0] for s in shards])
        v = np.concatenate([s[1] for s in shards])
        o = np.argsort(k)
        if not (np.array_equal(k[o], present)
                and np.array_equal(v[o], bc[present])):
            raise AssertionError("counts differ from np.bincount")
        _shard_keys_routed(shards, S)

    return check


def _run_setting(make, ex_kwargs, runs, env=None, inspect=None):
    """One executor (its arena kept across runs, as a long-lived session
    keeps it): a counted first run, then ``runs`` warm runs, each a new
    Session on it, the run and reading every shard back, after which
    every task of the run is discarded (its outputs leave the device).
    Returns the first run's launches, rows and ``inspect(executor)``
    (taken before its discard), the warm walls, the peak device memory
    of the warm runs, the staging seconds per warm run, the arena's
    counts before and after the warm runs, whether its buffers are
    pinned, and the executor. Discovery is off unless ``ex_kwargs`` says
    otherwise: phases 11-13 measure K2's lowering of reduce-wave."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.task import iter_tasks
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        ex = bs.MeshExecutor(**dict(dict(auto_dense=False), **ex_kwargs))

        def run():
            sess = bs.Session(executor=ex)
            res = sess.run(make())
            for shard in range(res.num_shards):
                list(res.reader(shard, ()))
            return sess, res

        def discard(res):
            for t in iter_tasks(res.tasks):
                ex.discard(t)

        ck.reset_launches()
        sess, res = run()
        launches = dict(ck.LAUNCHES)
        rows = bs.result_shard_rows(res)
        info = inspect(ex) if inspect is not None else None
        discard(res)
        del sess, res
        arena0 = ex.staging_arena.stats()
        ex.reset_staging_seconds()
        walls, peaks = [], []
        for _ in range(runs):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sess, res = run()
            walls.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            last = bs.result_shard_rows(res)
            discard(res)
            del sess, res
        _same_rows(last, rows, "a warm run against the first")
        stage = {k: v / runs if k.endswith("_s") else v
                 for k, v in ex.staging_seconds().items()}
        arena = ex.staging_arena.stats()
        return dict(launches=launches, rows=rows, info=info, walls_s=walls,
                    wall_s=statistics.median(walls), peak_gib=max(peaks),
                    staging_per_run=stage, arena_first=arena0, arena=arena,
                    pinned=arena["pinned"] is True, executor=ex)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


#: Phase 11's settings: (label, MeshExecutor arguments).
PIPELINE_SETTINGS = (
    ("depth 0, arena off", dict(prefetch_depth=0, staging_arena=False)),
    ("depth 0, arena on", dict(prefetch_depth=0)),
    ("depth 1", dict(prefetch_depth=1)),
    ("depth 2", dict(prefetch_depth=2)),
)


def _report(phase, label, rows, r, card) -> dict:
    st, ar = r["staging_per_run"], r["arena"]
    log(f"phase {phase}: {label}: warm wall {r['wall_s']:.4f} s (median of "
        f"{len(r['walls_s'])}: {', '.join(f'{w:.4f}' for w in r['walls_s'])})"
        f", {rows / r['wall_s']:.1f} rows/s, peak device memory "
        f"{r['peak_gib']:.3f} GiB; staging per run {st['staged_s']:.4f} s "
        f"(exposed {st['exposed_s']:.4f}, hidden {st['hidden_s']:.4f}, "
        f"{st['waves'] // max(1, len(r['walls_s']))} waves); arena hits "
        f"{ar['hits']} misses {ar['misses']} recycled {ar['recycled']} "
        f"(after the first run: {r['arena_first']['hits']} / "
        f"{r['arena_first']['misses']} / {r['arena_first']['recycled']}), "
        f"pinned {r['pinned']}; launches {r['launches']} (first run), on "
        f"{card}")
    return {k: v for k, v in r.items()
            if k not in ("rows", "executor", "info")}


def phase11_pipeline(card: str) -> dict:
    """pipeline: phase 3's reduce-wave at S = 4 and S = 16 under each of
    ``PIPELINE_SETTINGS`` (the serial loop with the per-shard pageable
    upload; the serial loop through the arena; prefetch depth 1 and 2),
    three warm runs each on one executor. Rows bit-equal across settings
    and exact against numpy; depth 1 must hide some staging and every
    arena setting must reuse buffers after the first run. Then phase 8's
    join at depth 0 and 1 (its two producer groups staged by two
    prefetchers)."""
    import bigslice_tpu_torch as bs

    keys, ones = _reduce_wave_input()
    check = _count_check(keys)
    out = {"launches": {}}
    want = None
    for S in (4, 16):
        for label, kw in PIPELINE_SETTINGS:
            r = _run_setting(lambda: bs.Reduce(bs.Const(S, keys, ones),
                                               lambda a, b: a + b),
                             kw, WARM_RUNS)
            check(r["rows"], S)
            if S == 4:
                if want is None:
                    want = r["rows"]
                _same_rows(r["rows"], want, f"pipeline S=4 {label}")
            elif label == PIPELINE_SETTINGS[0][0]:
                want16 = r["rows"]
            else:
                _same_rows(r["rows"], want16, f"pipeline S=16 {label}")
            for name in ("hash_partition", "hash_aggregate"):
                if r["launches"][name] <= 0:
                    raise AssertionError(f"pipeline {label}: {name} was not "
                                         f"launched")
            if kw.get("staging_arena", True):
                if r["arena"]["hits"] <= r["arena_first"]["hits"]:
                    raise AssertionError(f"pipeline S={S} {label}: the arena "
                                         f"reused no buffer after the first "
                                         f"run")
                if not r["pinned"]:
                    raise AssertionError(f"pipeline S={S} {label}: arena "
                                         f"buffers are not pinned")
            if kw["prefetch_depth"] == 1 and \
                    r["staging_per_run"]["hidden_s"] <= 0:
                raise AssertionError(f"pipeline S={S}: depth 1 hid no "
                                     f"staging")
            out[f"S={S}, {label}"] = _report("11", f"reduce-wave 2**25 rows "
                                            f"S={S}, {label}", len(keys), r,
                                            card)
            out["launches"] = {k: out["launches"].get(k, 0) + v
                               for k, v in r["launches"].items()}
    ak, bk = _join_keys()
    jones = np.ones(len(ak), np.int32)
    jcheck = _join_check(ak, jones, bk, jones, np.add, np.add, "join")
    jrows = None
    for depth in (0, 1):
        r = _run_setting(lambda: bs.JoinAggregate(
            bs.Const(4, ak, jones), bs.Const(4, bk, jones),
            lambda x, y: x + y, lambda x, y: x + y),
            dict(prefetch_depth=depth), WARM_RUNS)
        if jrows is None:
            jrows = r["rows"]
        _same_rows(r["rows"], jrows, f"pipeline join depth {depth}")
        jcheck.rows(r["rows"])
        if r["executor"].hash_off:
            raise AssertionError("pipeline join: a site went to the sort "
                                 "path")
        out[f"join, depth {depth}"] = _report(
            "11", f"join 2 x 2**23 rows, depth {depth}", 2 * len(ak), r, card)
        out["launches"] = {k: out["launches"].get(k, 0) + v
                           for k, v in r["launches"].items()}
    return out


def phase12_budget_split(card: str, phase3_peak: float) -> dict:
    """budget-split: phase 3's reduce-wave at S = 4 with a device budget
    of a quarter of a map wave's estimated working set, so that each map
    wave runs as K = 4 row slices; rows bit-equal to the unsplit run,
    the peak device memory no higher than phase 3's unsplit peak, and
    each slice's working set within the budget."""
    import bigslice_tpu_torch as bs

    from bigslice_tpu_torch.parallel.jitutil import bucket_size

    keys, ones = _reduce_wave_input()
    # The executor's estimate of a map wave: its capacity (2**23 rows) of
    # 8 bytes through the hash combine's table.
    est = bs.MeshExecutor.wave_bytes_model(bucket_size(len(keys) // 4), 8,
                                           hash_table=True)
    budget = -(-est // 4)
    make = lambda: bs.Reduce(bs.Const(4, keys, ones),  # noqa: E731
                             lambda a, b: a + b)
    plain = _run_setting(make, {}, 1)
    r = _run_setting(make, dict(device_budget_bytes=budget), WARM_RUNS)
    _same_rows(r["rows"], plain["rows"], "budget-split against unsplit")
    _count_check(keys)(r["rows"], 4)
    K = sorted(set(r["executor"].split_runs.values()))
    if K != [4]:
        raise AssertionError(f"budget-split: waves split into {K}, not 4")
    out = _report("12", f"budget-split reduce-wave S=4, budget {budget} "
                  f"bytes, K={K[0]} (phase 3 peak {phase3_peak:.3f} GiB)",
                  len(keys), r, card)
    log(f"phase 12: peak device memory under the split "
        f"{r['peak_gib']:.3f} GiB, phase 3's unsplit peak "
        f"{phase3_peak:.3f} GiB")
    if r["peak_gib"] > phase3_peak:
        raise AssertionError(f"budget-split: peak {r['peak_gib']:.3f} GiB "
                             f"exceeds the unsplit {phase3_peak:.3f} GiB")
    work = _slice_working_sets(r["executor"], make)
    log(f"phase 12: each slice's working set (its program and its fold, "
        f"beyond what the card held before it): largest {max(work)} bytes "
        f"of {len(work)} slices, budget {budget} bytes")
    if len(work) != 16 or max(work) > budget:
        raise AssertionError(f"budget-split: slices' working sets {work} "
                             f"against the budget {budget}")
    out["K"] = K[0]
    out["phase3_peak_gib"] = phase3_peak
    out["slice_work_bytes"] = work
    return out


def _slice_working_sets(ex, make) -> list:
    """One more run on ``ex``: the bytes each budget-split slice (its
    program and its fold into the running merge) allocated beyond what
    the card held when it started."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.task import iter_tasks

    work = []
    run_slice = ex._run_slice

    def measured(*args):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = run_slice(*args)
        torch.cuda.synchronize()
        work.append(torch.cuda.max_memory_allocated() - held)
        return out

    ex._run_slice = measured
    try:
        res = bs.Session(executor=ex).run(make())
        for t in iter_tasks(res.tasks):
            ex.discard(t)
    finally:
        del ex._run_slice
    return work


def phase13_spill(card: str) -> dict:
    """spill: phase 3's reduce-wave at S = 4 and phase 8's join, each with
    ``BIGSLICE_SHUFFLE=spill`` and with ``auto`` under a spill budget of
    a quarter of one side's staged bytes (which must spill); rows
    bit-equal to the in-program run, and the private spill directory
    gone after ``Session.shutdown()``."""
    import bigslice_tpu_torch as bs

    keys, ones = _reduce_wave_input()
    ak, bk = _join_keys()
    jones = np.ones(len(ak), np.int32)
    paths = {
        "reduce-wave": (lambda: bs.Reduce(bs.Const(4, keys, ones),
                                          lambda a, b: a + b),
                        len(keys), nbytes_of(keys, ones)),
        "join": (lambda: bs.JoinAggregate(
            bs.Const(4, ak, jones), bs.Const(4, bk, jones),
            lambda x, y: x + y, lambda x, y: x + y),
            2 * len(ak), nbytes_of(ak, jones)),
    }
    out = {"launches": {}}
    for what, (make, rows, staged) in paths.items():
        want = _run_setting(make, {}, 1)["rows"]
        for mode, env in (("spill", {"BIGSLICE_SHUFFLE": "spill"}),
                          ("auto", {"BIGSLICE_SHUFFLE": "auto",
                                    "BIGSLICE_SPILL_BUDGET_BYTES":
                                        str(staged // 4)})):
            r = _run_setting(make, {}, 3, env=env, inspect=_spill_stats)
            _same_rows(r["rows"], want, f"spill {what} {mode}")
            sp = r["info"]
            if sp["boundaries"] != (2 if what == "join" else 1):
                raise AssertionError(f"spill {what} {mode}: "
                                     f"{sp['boundaries']} boundaries spilled")
            ex = r["executor"]
            tmp = ex._spill_tmp
            bs.Session(executor=ex).shutdown()
            if tmp is None or os.path.exists(tmp):
                raise AssertionError(f"spill {what} {mode}: the spill "
                                     f"directory {tmp} was not removed")
            rep = _report("13", f"{what} {mode} (spilled {sp['bytes']} "
                          f"bytes, {sp['rows']} rows, {sp['partitions']} "
                          f"partitions; plans {sp['plans']}; spill dir "
                          f"removed)", rows, r, card)
            rep["spill"] = sp
            out[f"{what}, {mode}"] = rep
            out["launches"] = {k: out["launches"].get(k, 0) + v
                               for k, v in r["launches"].items()}
    return out


def _flat(col, dtype) -> np.ndarray:
    """The cells of an object column of lists, concatenated."""
    import itertools

    return np.fromiter(itertools.chain.from_iterable(col), dtype=dtype,
                       count=sum(len(c) for c in col))


def _cogroup_check(inputs, label, decode):
    """``check(session, result)`` for a Cogroup of ``inputs`` (a list of
    (keys, values)) against numpy: every key of the union exactly once;
    each input's list under a key its values of that key in input order
    (one card: shards are contiguous ranges of the input, waves arrive
    in shard order, the shuffle and the sort are stable), so equal to
    its numpy group as a multiset and in order; the list lengths summing
    to the input's rows; each row in the shard the routing hash names.
    ``decode`` collects each run's decode seconds (the store bridge's
    ``ragged_from_padded``), read here before this check's own reads."""
    import bigslice_tpu_torch as bs

    union = np.unique(np.concatenate([k for k, _ in inputs]))
    wants = []
    for k, v in inputs:
        order = np.argsort(k, kind="stable")
        wants.append((np.bincount(np.searchsorted(union, k),
                                  minlength=len(union)), v[order]))

    def check(sess, res):
        decode["runs"].append(decode["s"])
        shards = bs.result_shard_rows(res)
        keys = np.concatenate([sh[0] for sh in shards])
        o = np.argsort(keys, kind="stable")
        if not np.array_equal(keys[o], union):
            raise AssertionError(f"{label}: keys differ from the union of "
                                 f"the inputs' keys")
        for j, (cnt, vals) in enumerate(wants):
            col = np.concatenate([sh[1 + j] for sh in shards])[o]
            lens = np.fromiter((len(c) for c in col), np.int64, len(col))
            if not np.array_equal(lens, cnt) or lens.sum() != len(vals):
                raise AssertionError(f"{label}: input {j}'s list lengths "
                                     f"differ from numpy's group sizes")
            got = _flat(col, vals.dtype)
            if got.tobytes() != vals.tobytes():
                raise AssertionError(f"{label}: input {j}'s lists differ "
                                     f"from numpy's groups")
        _shard_keys_routed(shards, len(shards))
        ex = sess.executor
        decode["s"] = 0.0
        return f", {len(union)} keys, caps {ex.cogroup_caps}"

    return check


def _timed_decode(decode):
    """Wrap the store bridge's decode so each call adds its seconds to
    ``decode["s"]``; returns the function to restore."""
    from bigslice_tpu_torch.parallel import cogroup as cogroup_mod

    orig = cogroup_mod.ragged_from_padded

    def timed(*args):
        t0 = time.perf_counter()
        out = orig(*args)
        decode["s"] += time.perf_counter() - t0
        return out

    cogroup_mod.ragged_from_padded = timed
    return lambda: setattr(cogroup_mod, "ragged_from_padded", orig)


def _drive_cogroup(phase, label, make, inputs, rows, card, want_cap,
                   S=4):
    """One Cogroup path through ``drive``: K1 routes each producer wave
    once (S a side) and K2 never runs; the op's capacity (its widest
    wave's ``bucket_size`` of its largest group) must be ``want_cap``. Prints the warm runs' decode seconds beside the
    wall."""
    decode = {"s": 0.0, "runs": []}
    check = _cogroup_check(inputs, label, decode)
    seen = {}

    def check_caps(sess, res):
        note = check(sess, res)
        seen["caps"] = sorted(sess.executor.cogroup_caps.values())
        return note

    restore = _timed_decode(decode)
    try:
        out = drive(phase, label, make, check_caps, ("hash_partition",),
                    rows, card, expect={"hash_partition": S * len(inputs),
                                        "hash_aggregate": 0})
    finally:
        restore()
    if seen["caps"] != [want_cap]:
        raise AssertionError(f"{label}: the capacity reached {seen['caps']}, "
                             f"not [{want_cap}]")
    warm = decode["runs"][1:]
    dec = statistics.median(warm)
    log(f"phase {phase}: {label}: decode (device encoding to object lists) "
        f"{dec:.4f} s a run (median of {len(warm)}: "
        f"{', '.join(f'{d:.4f}' for d in warm)}), {dec / out['wall_s']:.3f} "
        f"of the warm wall; cap {want_cap}, on {card}")
    out.update(cap=want_cap, decode_s=dec,
               decode_runs_s=warm)
    return out


def _cogroup_join_inputs():
    """Phase 14's two inputs, 2**22 rows each from RandomState(14): A's
    int32 keys uniform over [0, 2**18) with int32 values, B's uniform
    over [2**17, 3 * 2**17) with float32 values."""
    n = 1 << 22
    rng = np.random.RandomState(14)
    ak = rng.randint(0, 1 << 18, n).astype(np.int32)
    av = rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32)
    bk = rng.randint(1 << 17, 3 << 17, n).astype(np.int32)
    bv = rng.randn(n).astype(np.float32)
    return [(ak, av), (bk, bv)]


def _cogroup_hotkey_input():
    """Phase 15's rows from RandomState(15): 2**20 int32 keys, uniform
    over [1, 2**16) plus key 0 4096 times, in random order, with int32
    values."""
    n, hot = 1 << 20, 4096
    rng = np.random.RandomState(15)
    keys = np.concatenate([np.zeros(hot, np.int32),
                           rng.randint(1, 1 << 16, n - hot).astype(np.int32)])
    keys = keys[rng.permutation(n)]
    vals = rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32)
    return keys, vals


def phase14_cogroup_join(card: str) -> dict:
    """cogroup-join: Cogroup(Const(4, ak, av), Const(4, bk, bv)) over
    ``_cogroup_join_inputs``: a quarter of the keys on A only, a quarter
    on B only, half on both. Groups average 16 a side with a largest
    near 40, so the capacity is 64."""
    import bigslice_tpu_torch as bs

    (ak, av), (bk, bv) = inputs = _cogroup_join_inputs()
    return _drive_cogroup(
        "14", "cogroup-join (two inputs, full outer join of lists)",
        lambda: bs.Cogroup(bs.Const(4, ak, av), bs.Const(4, bk, bv)),
        inputs, len(ak) + len(bk), card, 64)


def phase15_cogroup_hotkey(card: str) -> dict:
    """cogroup-hotkey: Cogroup(Const(4, keys, vals)) over
    ``_cogroup_hotkey_input``: the capacity must reach 4096."""
    import bigslice_tpu_torch as bs

    keys, vals = _cogroup_hotkey_input()
    return _drive_cogroup(
        "15", "cogroup-hotkey (one input, a 4096-row group)",
        lambda: bs.Cogroup(bs.Const(4, keys, vals)), [(keys, vals)],
        len(keys), card, 4096)


def phase16_local_reduce(card: str, mesh_shards) -> dict:
    """local-reduce: phase 3's count through the local executor,
    ``Session(executor=LocalExecutor()).run(wordcount_ids(4, keys,
    2**20))`` (2**25 keys uniform over 2**20): every row against
    np.bincount and in the shard K1 names, the shards bit-equal to phase
    3's (``mesh_shards``), K1 held against its plain version at this
    path's frame shape (one Const shard of 2**23 rows, 4 partitions, no
    mask) and launched once a producer frame in the counted run."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.models.wordcount import wordcount_ids
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    S = 4
    keys, _ = _reduce_wave_input()
    check = _count_check(keys)
    frame_keys = torch.from_numpy(keys[: len(keys) // S]).cuda()
    got, _ = ck.hash_partition([frame_keys], S, 0, with_counts=False)
    want, _ = ck.hash_partition_plain([frame_keys], S, 0, False, None)
    k1_err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if k1_err:
        raise AssertionError(f"local-reduce: K1 differs from its plain "
                             f"version at n = {len(frame_keys)}, {S} parts")
    del frame_keys, got, want

    def run():
        res = bs.Session(executor=bs.LocalExecutor()).run(
            wordcount_ids(S, keys, 1 << 20))
        for shard in range(S):
            list(res.reader(shard, ()))
        return res

    ck.reset_launches()
    res = run()
    launches = dict(ck.LAUNCHES)
    if launches["hash_partition"] != S:
        raise AssertionError(f"local-reduce: K1 launched "
                             f"{launches['hash_partition']} times, not one "
                             f"a producer frame ({S})")
    shards = bs.result_shard_rows(res)
    check(shards, S)
    _same_rows(shards, mesh_shards, "local-reduce against phase 3")
    del res, shards
    walls, peaks = [], []
    for _ in range(WARM_RUNS):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run()
        walls.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        check(bs.result_shard_rows(res), S)
        del res
    gc.collect()
    wall = statistics.median(walls)
    n = len(keys)
    log(f"phase 16: local-reduce {n} rows, S={S}, LocalExecutor: warm wall "
        f"{wall:.4f} s (median of {WARM_RUNS}: "
        f"{', '.join(f'{w:.4f}' for w in walls)}), {n / wall:.1f} rows/s, "
        f"peak device memory {max(peaks):.3f} GiB, launches {launches} "
        f"(first run), K1 at the frame shape max_abs_err {k1_err}; shards "
        f"equal phase 3's; on {card}")
    return dict(launches=launches, wall_s=wall, walls_s=walls, rows=n,
                rows_per_s=n / wall, peak_gib=max(peaks), k1_err=k1_err)


#: Phase 17's corpus: lines of words drawn from a vocabulary, Zipf-like
#: (word i with probability proportional to 1 / (i + 1)).
WC_LINES, WC_WORDS_A_LINE, WC_VOCAB = 1 << 18, 8, 1 << 16


def wordcount_corpus(path: str, seed: int = 17) -> list:
    """Write phase 17's corpus to ``path``; returns its words in order."""
    rng = np.random.RandomState(seed)
    vocab = np.array([f"w{i:04x}" for i in range(WC_VOCAB)], dtype=object)
    p = 1.0 / np.arange(1, WC_VOCAB + 1)
    ids = rng.choice(WC_VOCAB, size=WC_LINES * WC_WORDS_A_LINE,
                     p=p / p.sum())
    words = vocab[ids]
    with open(path, "w") as fh:
        for row in words.reshape(WC_LINES, WC_WORDS_A_LINE):
            fh.write(" ".join(row) + "\n")
    return list(words)


def _device_busy_s(fn) -> tuple:
    """``fn()`` once under torch.profiler (device activity only):
    (wall s, device busy s or None when no device time was recorded).
    A one-element fill after ``fn`` is the profiler's witness (a few
    microseconds of busy time), so a path that leaves the device idle
    reads as nearly all host, not as unmeasured."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    events = prof.key_averages()
    if not len(events):
        return wall, None
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    us = sum(getattr(e, attr) for e in events)
    return wall, (us / 1e6 if us else None)


def phase17_wordcount(card: str) -> dict:
    """wordcount: ``models.wordcount.wordcount(4, path)`` (ScanReader,
    host Flatmap and Map, a Reduce over str keys) through
    ``LocalExecutor()`` over a generated corpus of 2**18 lines of 8
    words (2**21 words over 2**16 distinct): the counts against
    collections.Counter, each word in the shard its routing hash names;
    one counted run, ``HOST_WARM_RUNS`` warm runs, and one profiled run
    for the host share (the wall's part with the device idle)."""
    import collections
    import tempfile

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch import native
    from bigslice_tpu_torch.frame import ops as frame_ops
    from bigslice_tpu_torch.models.wordcount import wordcount
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    S, runs = 4, HOST_WARM_RUNS
    tmp = tempfile.mkdtemp(prefix="chip-smoke-wordcount-")
    path = os.path.join(tmp, "corpus.txt")
    try:
        words = wordcount_corpus(path)
        want = collections.Counter(words)

        def run():
            res = bs.Session(executor=bs.LocalExecutor()).run(
                wordcount(S, path))
            for shard in range(S):
                list(res.reader(shard, ()))
            return res

        def check(res) -> None:
            got = {}
            for shard, cols in enumerate(bs.result_shard_rows(res)):
                w, c = cols
                if len(w):
                    ids = frame_ops.hash_host_column(w) % np.uint32(S)
                    if not bool((ids == shard).all()):
                        raise AssertionError(f"wordcount: shard {shard} "
                                             f"holds another's words")
                got.update(zip(w.tolist(), c.tolist()))
            if got != want:
                raise AssertionError("wordcount: counts differ from "
                                     "collections.Counter")

        ck.reset_launches()
        native.reset_calls()
        res = run()
        launches = dict(ck.LAUNCHES)
        crc_calls = native.CALLS["crc32_strings"]
        check(res)
        shards = bs.result_shard_rows(res)  # for phase 22
        del res
        walls = []
        for _ in range(runs):
            gc.collect()
            t0 = time.perf_counter()
            res = run()
            walls.append(time.perf_counter() - t0)
            check(res)
            del res
        pwall, busy = _device_busy_s(run)
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    wall = statistics.median(walls)
    n = len(words)
    host_share = None if busy is None else 1 - busy / pwall
    log(f"phase 17: wordcount {n} words ({len(want)} distinct), S={S}, "
        f"LocalExecutor: warm wall {wall:.4f} s (median of {runs}: "
        f"{', '.join(f'{w:.4f}' for w in walls)}), {n / wall:.1f} words/s; "
        f"profiled run {pwall:.4f} s, device busy "
        + (f"{busy:.4f} s, host share {host_share:.4f}" if busy is not None
           else "not measured")
        + f"; launches {launches} (first run), native CRC calls "
        f"{crc_calls} (first run), on {card}")
    return dict(launches=launches, wall_s=wall, walls_s=walls, rows=n,
                rows_per_s=n / wall, profiled_wall_s=pwall,
                device_busy_s=busy, host_share=host_share,
                native_crc_calls=crc_calls, shards=shards)


def numpy_fold(keys, vals, fn, init, dtype):
    """Each key's fold ``acc = fn(acc, v)`` from ``init`` over its rows
    in input order, in numpy: (distinct keys sorted, their folds). A
    stable argsort keeps each key's rows in order; step r folds row r of
    every key that has one."""
    order = np.argsort(keys, kind="stable")
    sk, sv = keys[order], vals[order]
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    lengths = np.diff(np.r_[starts, len(sk)])
    acc = np.full(len(starts), init, dtype)
    with np.errstate(over="ignore"):
        for r in range(int(lengths.max())):
            act = lengths > r
            acc[act] = fn(acc[act], sv[starts[act] + r]).astype(dtype)
    return sk[starts], acc


def _fold_check(keys, vals, fn, init, dtype, S):
    """A Fold's rows against ``numpy_fold`` (the rows' order is the
    Const's: source shard, then row), int bit for bit and float within
    rtol 1e-5, atol 1e-6; each row in the shard K1 names."""
    import bigslice_tpu_torch as bs

    want_k, want_a = numpy_fold(keys, vals, fn, init, dtype)

    def check(sess, res):
        shards = bs.result_shard_rows(res)
        k = np.concatenate([sh[0] for sh in shards])
        a = np.concatenate([sh[1] for sh in shards])
        o = np.argsort(k)
        if not np.array_equal(k[o], want_k):
            raise AssertionError("fold: keys differ from numpy")
        if dtype == np.float32:
            if not np.allclose(a[o], want_a, rtol=1e-5, atol=1e-6):
                raise AssertionError("fold: float folds differ from numpy")
        elif not np.array_equal(a[o], want_a):
            raise AssertionError("fold: folds differ from numpy")
        _shard_keys_routed(shards, S)
        return ""

    return check


def _fold_steps_check(label, keys, r, S) -> None:
    """The counted run's fold steps: each shard's wave folds in as many
    steps as its longest group (the shard's keys by K1's plain
    version), the longest of them the whole input's longest group."""
    from bigslice_tpu_torch.parallel.cuda_kernels import hash_partition_plain

    bc = np.bincount(keys)
    uk = np.nonzero(bc)[0].astype(np.int32)
    ids, _ = hash_partition_plain([torch.from_numpy(uk)], S)
    shard = ids.numpy()
    per = [int(bc[uk[shard == s]].max()) for s in range(S)
           if (shard == s).any()]
    got = r["fold_steps"]
    if got["steps"] != sum(per) or got["longest"] != max(per):
        raise AssertionError(f"{label}: fold steps {got}, want {sum(per)} "
                             f"in all and {max(per)} the longest")


def phase18_fold(card: str) -> dict:
    """fold: Session().run(Fold(Const(4, keys, vals), acc * 31 + v,
    init=7)) at phase 3's shape (2**25 int32 keys uniform over 2**20,
    from a seeded generator, int32 values), then the float32 fold
    acc * 0.5 + v at 2**24 rows: every key against ``numpy_fold`` and
    its K1 shard; K1 routes, K2 never runs, and each wave folds in as
    many steps as its longest group."""
    import bigslice_tpu_torch as bs

    S = 4
    rng = np.random.default_rng(18)
    n = 1 << 25
    keys = rng.integers(0, 1 << 20, n, dtype=np.int32)
    vals = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int32)
    r = drive("18", "fold (acc * 31 + v, int32)",
              lambda: bs.Fold(bs.Const(S, keys, vals),
                              lambda acc, v: acc * 31 + v, init=7),
              _fold_check(keys, vals, lambda acc, v: acc * 31 + v, 7,
                          np.int32, S),
              ("hash_partition",), n, card, expect={"hash_aggregate": 0})
    _fold_steps_check("fold", keys, r, S)
    n2 = 1 << 24
    fk = rng.integers(0, 1 << 20, n2, dtype=np.int32)
    fv = rng.standard_normal(n2, dtype=np.float32)
    r2 = drive("18", "fold (acc * 0.5 + v, float32)",
               lambda: bs.Fold(bs.Const(S, fk, fv),
                               lambda acc, v: acc * 0.5 + v, init=0.0),
               _fold_check(fk, fv, lambda acc, v: acc * np.float32(0.5) + v,
                           0.0, np.float32, S),
               ("hash_partition",), n2, card, expect={"hash_aggregate": 0})
    _fold_steps_check("fold float32", fk, r2, S)
    log(f"phase 18: fold steps (counted runs): int32 {r['fold_steps']}, "
        f"float32 {r2['fold_steps']}; longest group "
        f"{int(np.bincount(keys).max())} / {int(np.bincount(fk).max())}; "
        f"on {card}")
    return {"fold": r, "fold-f32": r2}


def phase19_fold_hotkey(card: str) -> dict:
    """fold-hotkey: the Fold of phase 18 over ``_cogroup_hotkey_input``
    (2**20 rows over 2**16 keys plus key 0 4096 times): the hot key's
    wave takes as many steps as its group."""
    import bigslice_tpu_torch as bs

    S = 4
    keys, vals = _cogroup_hotkey_input()
    r = drive("19", "fold-hotkey (a 4096-row group)",
              lambda: bs.Fold(bs.Const(S, keys, vals),
                              lambda acc, v: acc * 31 + v, init=7),
              _fold_check(keys, vals, lambda acc, v: acc * 31 + v, 7,
                          np.int32, S),
              ("hash_partition",), len(keys), card,
              expect={"hash_aggregate": 0})
    _fold_steps_check("fold-hotkey", keys, r, S)
    if r["fold_steps"]["longest"] < 4096:
        raise AssertionError("fold-hotkey: the hot key's group was not "
                             "folded in its own 4096+ steps")
    log(f"phase 19: fold steps (counted run) {r['fold_steps']}, on {card}")
    return r


def phase20_func_api(card: str) -> dict:
    """func-api: the rest of the user API on the card. A registered Func
    (``Session().run(int_max_func, 4, keys, vals)``, 2**24 rows over
    2**20 keys: K2's map-side max) against np.maximum.at; a Reduce over
    a Reshard to 16 shards against np.bincount; a Reduce over a
    two-column key (Prefixed) against numpy; and a Scan sink on
    ``LocalExecutor()`` counting each shard's rows."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.models.maxint import int_max_func
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    S = 4
    rng = np.random.default_rng(20)
    n = 1 << 24
    span = 1 << 20
    keys = rng.integers(0, span, n, dtype=np.int32)
    vals = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int32)
    mx = np.full(span, np.iinfo(np.int32).min, np.int32)
    np.maximum.at(mx, keys, vals)
    present = np.unique(keys)

    def check_max(sess, res):
        shards = bs.result_shard_rows(res)
        k = np.concatenate([sh[0] for sh in shards])
        v = np.concatenate([sh[1] for sh in shards])
        o = np.argsort(k)
        if not (np.array_equal(k[o], present)
                and np.array_equal(v[o], mx[present])):
            raise AssertionError("int_max_func differs from np.maximum.at")
        _shard_keys_routed(shards, S)
        return ""

    out = {"func-int-max": drive(
        "20", "func-api: Session().run(int_max_func, 4, keys, vals)",
        lambda: (int_max_func, S, keys, vals), check_max,
        ("hash_partition", "hash_aggregate"), n, card, auto_dense=False)}

    ones = np.ones(n, np.int32)
    bc = np.bincount(keys, minlength=span)

    def check_reshard(sess, res):
        shards = bs.result_shard_rows(res)
        if len(shards) != 16:
            raise AssertionError(f"reshard: {len(shards)} shards, not 16")
        k = np.concatenate([sh[0] for sh in shards])
        v = np.concatenate([sh[1] for sh in shards])
        o = np.argsort(k)
        if not (np.array_equal(k[o], present)
                and np.array_equal(v[o], bc[present])):
            raise AssertionError("reshard: counts differ from np.bincount")
        _shard_keys_routed(shards, 16)
        return ""

    out["reshard"] = drive(
        "20", "func-api: Reduce(Reshard(Const(4, keys, ones), 16), add)",
        lambda: bs.Reduce(bs.Reshard(bs.Const(S, keys, ones), 16),
                          lambda a, b: a + b),
        check_reshard, ("hash_partition",), n, card, auto_dense=False)

    k2 = rng.integers(0, 4, n, dtype=np.int32)
    small = rng.integers(0, 100, n, dtype=np.int32)
    pair = keys.astype(np.int64) * 4 + k2
    upair, inv = np.unique(pair, return_inverse=True)
    psum = np.bincount(inv, weights=small).astype(np.int64)

    def check_prefixed(sess, res):
        shards = bs.result_shard_rows(res)
        k = np.concatenate([sh[0] for sh in shards]).astype(np.int64)
        kk = np.concatenate([sh[1] for sh in shards])
        v = np.concatenate([sh[2] for sh in shards])
        got = k * 4 + kk
        o = np.argsort(got)
        if not (np.array_equal(got[o], upair)
                and np.array_equal(v[o].astype(np.int64), psum)):
            raise AssertionError("prefixed: sums differ from numpy")
        return (f", on the sort path after overflow: "
                f"{sorted(sess.executor.hash_off)}")

    out["prefixed"] = drive(
        "20", "func-api: Reduce(Prefixed(Const(4, k1, k2, v), 2), add)",
        lambda: bs.Reduce(bs.Prefixed(bs.Const(S, keys, k2, small), 2),
                          lambda a, b: a + b),
        check_prefixed, ("hash_partition",), n, card)

    # The Scan sink runs on the local executor (the device executor
    # refuses it by name).
    counts = {}

    def sink(shard, reader):
        counts[shard] = sum(len(f) for f in reader)

    ck.reset_launches()
    t0 = time.perf_counter()
    res = bs.Session(executor=bs.LocalExecutor()).run(
        bs.Scan(bs.Const(S, keys), sink))
    wall = time.perf_counter() - t0
    if res.rows() != [] or counts != {s: n // S for s in range(S)}:
        raise AssertionError(f"scan: shard counts {counts}")
    out["scan"] = dict(launches=dict(ck.LAUNCHES), wall_s=wall, rows=n)
    log(f"phase 20: func-api: Scan sink on LocalExecutor(), {n} rows: wall "
        f"{wall:.4f} s (one run), shard counts {counts}, launches "
        f"{out['scan']['launches']}, on {card}")
    return out


#: Alternating pairs of phase 21's reduce-wave A/B (K2's lowering, then
#: the default's).
AB_PAIRS = 10
#: Phases 21-22 run at their sizes shifted right by this many bits: 0 on
#: the card; a rehearsal on the CPU (phase functions called with the
#: executors' device patched to the CPU) sets it to shrink them.
SHIFT = 0


def _misprobe_keys(S: int) -> np.ndarray:
    """Phase 21's misprobe (also 29b's): 2**24 int32 keys whose first
    shard lies below 2**16 and the rest below 2**21, so that the bound
    discovered on wave 0 is retracted by a later one."""
    ne = 1 << (24 - SHIFT)
    mrng = np.random.RandomState(23)
    return np.concatenate([mrng.randint(0, 1 << (16 - SHIFT), ne // S),
                           mrng.randint(0, 1 << (21 - SHIFT), ne - ne // S)]
                          ).astype(np.int32)


def _timed_reduce_wave(keys, ones, S, auto_dense) -> float:
    """One reduce-wave run (session, run, every shard read back) on
    ``MeshExecutor(auto_dense=auto_dense)``: its wall in seconds."""
    import bigslice_tpu_torch as bs

    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = bs.Session(executor=bs.MeshExecutor(auto_dense=auto_dense)).run(
        bs.Reduce(bs.Const(S, keys, ones), lambda a, b: a + b))
    for shard in range(S):
        list(res.reader(shard, ()))
    wall = time.perf_counter() - t0
    del res
    return wall


def phase21_dense(card: str, device) -> dict:
    """dense: the dense lowerings and auto-dense discovery at the
    default (``MeshExecutor()``, auto_dense on). (a) reduce-wave's rows
    (2**25 int32 keys uniform over 2**20, ones, S = 4): the producer's
    first wave discovers the bound 2**20, so the map side takes the sort
    combine-shuffle (the fused dense one needs one partition a device)
    and the reduce side the dense table, with K2 launched 0 times; then
    ``AB_PAIRS`` alternating pairs of phase 3's lowering (K2 on both
    sides, auto_dense=False) and this one. (b) ``Reduce(Const(1, keys,
    ones), add, dense_keys=2**20)``: one partition, so no shuffle stage
    and the whole combine in one [2**20] table; and the fused dense
    combine-shuffle (``dense.make_dense_combine_shuffle``, which the
    executor reaches only with one partition a device of several
    partitions, so never on one card) driven directly at that shape,
    its routing tables built by K1 over arange(2**20). (c) a dense join:
    ``JoinAggregate`` of two ``Const(1, ...)`` sides of 2**23 keys over
    2**19 with ``dense_keys=2**19``: the rank-indexed table a side, its
    routing tables built by K1 once. (d) a dense Fold, max from -7 over
    phase 18's keys with ``dense_keys=2**20``. (e) a misprobe: the first
    shard's keys lie in [0, 2**16), the others' reach 2**21: the bound
    probed on the first wave is retracted by the reduce side's badrange
    signal, both sites go into ``auto_dense_off`` and the group reruns
    on K2. Every row is checked against numpy."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.parallel import cuda_kernels as ck
    from bigslice_tpu_torch.parallel import dense

    S = 4
    span = 1 << (20 - SHIFT)
    keys, ones = _reduce_wave_input(1 << (25 - SHIFT), span)
    n = len(keys)
    count_check = _count_check(keys, span)
    made = []
    out = {}

    def keep(r):
        made.append(r)
        return r

    def check_a(sess, res):
        count_check(bs.result_shard_rows(res), S)
        fc = made[-1].frame_combiner
        if fc.dense_keys != span or not fc._auto_declared:
            raise AssertionError(f"dense (a): the site declared "
                                 f"{fc.dense_keys}, not a discovered {span}")
        if sess.executor.auto_dense_off:
            raise AssertionError("dense (a): a site was retracted")
        return f", discovered dense_keys={fc.dense_keys}"

    out["dense-reduce-wave"] = drive(
        "21", "dense (a): reduce-wave at the default (discovered)",
        lambda: keep(bs.Reduce(bs.Const(S, keys, ones), lambda a, b: a + b)),
        check_a, ("hash_partition",), n, card, expect={"hash_aggregate": 0})
    pairs = [(_timed_reduce_wave(keys, ones, S, False),
              _timed_reduce_wave(keys, ones, S, True))
             for _ in range(AB_PAIRS)]
    k2 = statistics.median(p[0] for p in pairs)
    dn = statistics.median(p[1] for p in pairs)
    wins = sum(p[1] < p[0] for p in pairs)
    out["dense-reduce-wave"]["ab_pairs_s"] = pairs
    log(f"phase 21: reduce-wave A/B, {AB_PAIRS} alternating pairs (K2 "
        f"lowering, auto_dense=False; then the default, sort map side and "
        f"dense reduce side): median {k2:.4f} s against {dn:.4f} s, the "
        f"default faster in {wins} of {AB_PAIRS}; pairs "
        + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in pairs)
        + f"; on {card}")

    def check_b(sess, res):
        count_check(bs.result_shard_rows(res), 1)
        if made[-1].frame_combiner.dense_keys != span:
            raise AssertionError("dense (b): the declaration was dropped")
        return ""

    out["dense-one-partition"] = drive(
        "21", "dense (b): Reduce(Const(1, keys, ones), add, "
        "dense_keys=2**20)",
        lambda: keep(bs.Reduce(bs.Const(1, keys, ones), lambda a, b: a + b,
                               dense_keys=span)),
        check_b, (), n, card,
        expect={"hash_partition": 0, "hash_aggregate": 0})

    # The fused dense combine-shuffle at (b)'s shape, driven directly.
    kt = torch.from_numpy(keys).to(device)
    vt = torch.ones_like(kt)
    valid = torch.ones_like(kt, dtype=torch.bool)
    body = dense.make_dense_combine_shuffle(1, span, ("add",))
    ck.reset_launches()
    mask, ov, bad, (slots, cnt) = body(valid, kt, vt)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    bc = np.bincount(keys, minlength=span)
    if not (launches["hash_partition"] == 1
            and np.array_equal(mask.cpu().numpy(), bc > 0)
            and np.array_equal(slots.cpu().numpy(), np.arange(span))
            and np.array_equal(cnt.cpu().numpy()[bc > 0], bc[bc > 0])
            and int(ov) == 0 and int(bad) == 0):
        raise AssertionError("dense combine-shuffle differs from "
                             "np.bincount")
    table, _ = dense.routing_tables(span, 1, 0, device)
    if not np.array_equal(table, dense.routing_tables(span, 1, 0)[0]):
        raise AssertionError("routing tables on the card differ from the "
                             "CPU's")
    ms = time_ms(lambda: body(valid, kt, vt))
    out["dense-combine-shuffle"] = dict(launches=launches, wall_s=ms / 1e3,
                                        rows=n)
    log(f"phase 21: dense (b) fused combine-shuffle, {n} rows into {span} "
        f"slots, called directly: {ms:.4f} ms (median of CUDA-event runs, "
        f"tables cached), launches {launches} (the routing tables' K1), "
        f"on {card}")
    del kt, vt, valid, mask, slots, cnt

    rng = np.random.RandomState(21)
    nj, span_j = 1 << (23 - SHIFT), 1 << (19 - SHIFT)
    ak = rng.randint(0, span_j, nj).astype(np.int32)
    bk = rng.randint(0, span_j, nj).astype(np.int32)
    onesj = np.ones(nj, np.int32)
    ca = np.bincount(ak, minlength=span_j)
    cb = np.bincount(bk, minlength=span_j)
    both = np.nonzero((ca > 0) & (cb > 0))[0]

    def check_c(sess, res):
        shards = bs.result_shard_rows(res)
        k, a, b = (np.concatenate([sh[i] for sh in shards]) for i in range(3))
        o = np.argsort(k)
        if not (np.array_equal(k[o], both) and np.array_equal(a[o], ca[both])
                and np.array_equal(b[o], cb[both])):
            raise AssertionError("dense join differs from numpy")
        return ""

    out["dense-join"] = drive(
        "21", "dense (c): JoinAggregate(Const(1, ak, 1), Const(1, bk, 1), "
        "dense_keys=2**19)",
        lambda: bs.JoinAggregate(bs.Const(1, ak, onesj),
                                 bs.Const(1, bk, onesj), lambda x, y: x + y,
                                 lambda x, y: x + y, dense_keys=span_j),
        check_c, ("hash_partition",), 2 * nj, card,
        expect={"hash_partition": 1, "hash_aggregate": 0})

    frng = np.random.default_rng(18)
    fk = frng.integers(0, span, n, dtype=np.int32)
    fv = frng.integers(-(2**31), 2**31 - 1, n, dtype=np.int32)
    fmax = np.full(span, -7, np.int32)
    np.maximum.at(fmax, fk, fv)
    fpresent = np.unique(fk)

    def check_d(sess, res):
        shards = bs.result_shard_rows(res)
        k = np.concatenate([sh[0] for sh in shards])
        a = np.concatenate([sh[1] for sh in shards])
        o = np.argsort(k)
        if not (np.array_equal(k[o], fpresent)
                and np.array_equal(a[o], fmax[fpresent])):
            raise AssertionError("dense fold differs from np.maximum.at")
        if made[-1].dense_op != "max":
            raise AssertionError("dense (d): the fold did not classify")
        _shard_keys_routed(shards, S)
        return ""

    out["dense-fold"] = drive(
        "21", "dense (d): Fold(Const(4, keys, vals), max, init=-7, "
        "dense_keys=2**20)",
        lambda: keep(bs.Fold(bs.Const(S, fk, fv),
                             lambda acc, v: torch.maximum(acc, v), init=-7,
                             dense_keys=span)),
        check_d, ("hash_partition",), n, card, expect={"hash_aggregate": 0})

    mk = _misprobe_keys(S)
    ne = len(mk)
    mones = np.ones(ne, np.int32)
    mbc = np.bincount(mk)
    mpresent = np.nonzero(mbc)[0]

    def check_e(sess, res):
        shards = bs.result_shard_rows(res)
        k = np.concatenate([sh[0] for sh in shards])
        v = np.concatenate([sh[1] for sh in shards])
        o = np.argsort(k)
        if not (np.array_equal(k[o], mpresent)
                and np.array_equal(v[o], mbc[mpresent])):
            raise AssertionError("misprobe: counts differ from np.bincount")
        _shard_keys_routed(shards, S)
        off = sorted(sess.executor.auto_dense_off)
        if (sorted(op.split("@")[0] for op in off) != ["const", "reduce"]
                or made[-1].frame_combiner.dense_keys is not None):
            raise AssertionError(f"misprobe: retracted sites {off}")
        return f", retracted: {off}"

    out["dense-misprobe"] = drive(
        "21", "dense (e): misprobe (first wave's keys below 2**16, later "
        "ones to 2**21)",
        lambda: keep(bs.Reduce(bs.Const(S, mk, mones), lambda a, b: a + b)),
        check_e, ("hash_partition", "hash_aggregate"), ne, card)
    return out


def _same_str_shards(got, want, what) -> None:
    """Equality of two ``result_shard_rows`` holding object columns."""
    if len(got) != len(want) or any(
            len(g) != len(w) or any(list(gc) != list(wc)
                                    for gc, wc in zip(g, w))
            for g, w in zip(got, want)):
        raise AssertionError(f"{what}: rows differ")


def phase22_host_fallback(card: str, wc_shards) -> dict:
    """host-fallback: ``Session()`` (the device executor) over slices it
    cannot lower, which run on its host tier (an inner
    ``LocalExecutor`` on the same store and card). Word count over
    phase 17's corpus, equal to collections.Counter and to phase 17's
    shards (``LocalExecutor()``), with no group on the device path; and
    a mixed chain: a host Map over ScanReader lines to int32 ids (the
    first word's id) and word counts (host tier, staged onto the card),
    a device Reduce adding them, then a host Map over its result (read
    back through the store bridge), against numpy. Each once counted
    and warm (word count ``HOST_WARM_RUNS`` times, the chain
    ``WARM_RUNS``)."""
    import collections
    import shutil
    import tempfile

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch import native
    from bigslice_tpu_torch.models.wordcount import wordcount
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    S = 4
    crc_calls = []  # the native CRC's calls in the counted run
    tmp = tempfile.mkdtemp(prefix="chip-smoke-fallback-")
    path = os.path.join(tmp, "corpus.txt")
    out = {}
    try:
        words = wordcount_corpus(path)
        want = collections.Counter(words)

        def check_wc(sess, res):
            shards = bs.result_shard_rows(res)
            got = {}
            for w, c in shards:
                got.update(zip(w.tolist(), c.tolist()))
            if got != want:
                raise AssertionError("fallback wordcount: counts differ "
                                     "from collections.Counter")
            _same_str_shards(shards, wc_shards,
                             "fallback wordcount against phase 17")
            if sess.executor._outputs:
                raise AssertionError("fallback wordcount: a group ran on "
                                     "the device path")
            if not crc_calls:  # the counted run's check comes first
                crc_calls.append(native.CALLS["crc32_strings"])
                return f"; native CRC calls {crc_calls[0]} (first run)"
            return ""

        native.reset_calls()
        out["fallback-wordcount"] = drive(
            "22", "host-fallback: wordcount through Session()",
            lambda: wordcount(S, path), check_wc, (), len(words), card,
            warm=HOST_WARM_RUNS)
        out["fallback-wordcount"]["native_crc_calls"] = crc_calls[0]

        first = np.array([int(line.split(" ", 1)[0][1:], 16)
                          for line in open(path)], np.int64)
        per_id = np.bincount(first, minlength=WC_VOCAB) * WC_WORDS_A_LINE
        want_mixed = {f"w{k:04x}": int(per_id[k] * 2)
                      for k in np.nonzero(per_id)[0]}

        def mixed():
            sess = bs.Session()
            ids = bs.Map(bs.ScanReader(S, path),
                         lambda line: (int(line.split(" ", 1)[0][1:], 16),
                                       len(line.split())),
                         out=[np.int32, np.int32])
            red = sess.run(bs.Reduce(ids, lambda a, b: a + b))
            res = sess.run(bs.Map(red, lambda k, c: (f"w{int(k):04x}",
                                                     int(c) * 2),
                                  out=[str, np.int32]))
            rows = dict(res.rows())
            return sess, rows

        def check_mixed(sess, rows):
            if rows != want_mixed:
                raise AssertionError("mixed chain differs from numpy")
            if len(sess.executor._outputs) != 1:
                raise AssertionError("mixed chain: the Reduce did not run on "
                                     "the device path")

        ck.reset_launches()
        sess, rows = mixed()
        launches = dict(ck.LAUNCHES)
        check_mixed(sess, rows)
        off = sorted(sess.executor.auto_dense_off)
        del sess, rows
        walls, peaks = [], []
        for _ in range(WARM_RUNS):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sess, rows = mixed()
            walls.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            check_mixed(sess, rows)
            del sess, rows
        wall = statistics.median(walls)
        nl = WC_LINES
        log(f"phase 22: host-fallback: mixed chain (host Map over "
            f"ScanReader, device Reduce, host Map over the result), {nl} "
            f"lines: warm wall {wall:.4f} s (median of {WARM_RUNS}: "
            f"{', '.join(f'{w:.4f}' for w in walls)}), {nl / wall:.1f} "
            f"lines/s, peak device memory {max(peaks):.3f} GiB, launches "
            f"{launches} (first run), retracted {off}, on {card}")
        out["fallback-mixed"] = dict(launches=launches, wall_s=wall,
                                     walls_s=walls, rows=nl,
                                     rows_per_s=nl / wall,
                                     peak_gib=max(peaks))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# -- phases 23-25: dictionary-encoded string keys and the result cache -----

#: Phase 23's corpus: lines in the shape of the JAX package's urls
#: benchmark (the reference's cmd/urls demo), and the lines of its host
#: str-key count.
URLS_LINES, URLS_HOST_LINES = 1 << 22, 1 << 20


def synth_urls(n: int) -> list:
    """``n`` URL lines: RandomState(7), domain ``zipf(1.5) % 5000``,
    ``http://site{d}.example.com/p/{i & 1023}``."""
    rng = np.random.RandomState(7)
    doms = (rng.zipf(1.5, n) % 5000).astype(np.int64)
    return [f"http://site{d}.example.com/p/{i & 1023}"
            for i, d in enumerate(doms.tolist())]


def _memory_gib(pid: int) -> tuple:
    """A process's resident memory in GiB: all of it (VmRSS) and its
    anonymous part (RssAnon: the pages no other process shares, unlike
    mapped library files), or NaN where /proc does not say."""
    got = {}
    with open(f"/proc/{pid}/status") as fh:
        for line in fh:
            key = line.split(":", 1)[0]
            if key in ("VmRSS", "RssAnon"):
                got[key] = int(line.split()[1]) / 2**20
    return got.get("VmRSS", float("nan")), got.get("RssAnon", float("nan"))


#: What each parse worker evaluates to report its pid: a short sleep,
#: so that the tasks spread over every worker.
_WORKER_PID = "__import__('time').sleep(0.05) or __import__('os').getpid()"


def _pool_startup() -> tuple:
    """A fresh parse pool, timed until every worker has answered once
    (their 0.05 s sleeps included): (processes, seconds, pids, whether a
    worker imported torch)."""
    from bigslice_tpu_torch.frame import strparse

    strparse.shutdown_pool()
    procs = strparse.parse_procs()
    t0 = time.perf_counter()
    pool = strparse._pool()
    if pool is None:
        return 0, 0.0, [], False
    pids = set()
    for _ in range(50):
        pids.update(pool.map(eval, [_WORKER_PID] * (2 * procs), chunksize=1))
        if len(pids) >= procs:
            break
    else:
        raise AssertionError(f"only {len(pids)} of {procs} parse workers "
                             f"answered")
    secs = time.perf_counter() - t0
    torch_in_worker = pool.apply(eval, ("'torch' in __import__('sys').modules",))
    return procs, secs, sorted(pids), torch_in_worker


def phase23_urls(card: str) -> dict:
    """urls: ``models.urls.domain_count_encoded(Session(), 4, lines)``
    over ``URLS_LINES`` lines of ``synth_urls`` (one host sweep parses
    and encodes every line to an int32 code, through the native rung
    and the spawn pool; a device Map and a dense Reduce count the codes;
    the rows are decoded at the edge), against collections.Counter of
    ``_domain``; once counted and ``HOST_WARM_RUNS`` times warm. The
    host sweep's part of the wall is the time from the run's start to
    the last parse's end; the rest is the Reduce and the decode. Then
    ``domain_count`` (host str keys, the native CRC) over the first
    ``URLS_HOST_LINES`` lines, equal to the encoded count of the same
    lines."""
    import collections
    import resource

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch import native
    from bigslice_tpu_torch.frame import strparse
    from bigslice_tpu_torch.models import urls
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    S = 4
    lines = synth_urls(URLS_LINES >> SHIFT)
    n = len(lines)
    want = collections.Counter(urls._domain(u) for u in lines)
    built = native.rungs()
    procs, startup_s, pids, torch_in_worker = _pool_startup()
    if torch_in_worker:
        raise AssertionError("urls: a parse worker imported torch")
    mem_start = np.sum([_memory_gib(p) for p in pids], axis=0)

    ends = []
    parse = strparse.domains_codes

    def timed_parse(*args, **kwargs):
        out = parse(*args, **kwargs)
        ends.append(time.perf_counter())
        return out

    def run():
        ends.clear()
        sess = bs.Session()
        t0 = time.perf_counter()
        rows = urls.domain_count_encoded(sess, S, lines)
        wall = time.perf_counter() - t0
        return sess, rows, wall, max(ends) - t0

    def check(rows, want, what) -> None:
        if len(rows) != len(want) or dict(rows) != want:
            raise AssertionError(f"{what}: counts differ from "
                                 f"collections.Counter")

    strparse.domains_codes = timed_parse
    try:
        ck.reset_launches()
        strparse.reset_rungs()
        native.reset_calls()
        sess, rows, first_wall, first_sweep = run()
        launches = dict(ck.LAUNCHES)
        rungs = dict(strparse.RUNGS)
        calls = dict(native.CALLS)
        check(rows, want, "urls")
        if not rungs["native-list"] + rungs["native-buffer"]:
            raise AssertionError(f"urls: no native rung ran ({rungs})")
        if launches["hash_partition"] <= 0:
            raise AssertionError("urls: hash_partition was not launched")
        lowering = dict(hash_off=sorted(sess.executor.hash_off),
                        auto_dense_off=sorted(sess.executor.auto_dense_off))
        del sess, rows
        walls, sweeps, peaks = [], [], []
        for _ in range(HOST_WARM_RUNS):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sess, rows, wall, sweep = run()
            walls.append(wall)
            sweeps.append(sweep)
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            check(rows, want, "urls")
            del sess, rows
        mem_end = np.sum([_memory_gib(p) for p in pids], axis=0)
        # The same runs parsed in this process alone (the extension rung),
        # to weigh the pool against.
        strparse.shutdown_pool()
        os.environ["BIGSLICE_PARSE_PROCS"] = "0"
        strparse.reset_rungs()
        solo_walls, solo_sweeps = [], []
        for _ in range(HOST_WARM_RUNS):
            gc.collect()
            sess, rows, w, sw = run()
            solo_walls.append(w)
            solo_sweeps.append(sw)
            check(rows, want, "urls (single process)")
            del sess, rows
        solo_rungs = dict(strparse.RUNGS)
    finally:
        strparse.domains_codes = parse
        os.environ.pop("BIGSLICE_PARSE_PROCS", None)
        strparse.shutdown_pool()
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    wall = statistics.median(walls)
    sweep = statistics.median(sweeps)
    solo, solo_sweep = (statistics.median(solo_walls),
                        statistics.median(solo_sweeps))
    log(f"phase 23: urls: domain_count_encoded(Session(), {S}, lines), {n} "
        f"lines ({len(want)} domains): warm wall {wall:.4f} s (median of "
        f"{HOST_WARM_RUNS}: {', '.join(f'{w:.4f}' for w in walls)}), "
        f"{n / wall:.1f} lines/s; host sweep {sweep:.4f} s, Reduce and "
        f"decode {wall - sweep:.4f} s (medians); first run {first_wall:.4f} "
        f"s (sweep {first_sweep:.4f} s); native builds {built}, rungs "
        f"{rungs} (first run), native calls {calls}; parse pool {procs} "
        f"processes (no torch in a worker), started in {startup_s:.4f} s, "
        f"all workers resident {mem_start[0]:.3f} GiB ({mem_start[1]:.3f} "
        f"anonymous) at start and {mem_end[0]:.3f} ({mem_end[1]:.3f}) GiB "
        f"after the runs; "
        f"this process's peak RSS {host_peak:.3f} GiB; peak device memory "
        f"{max(peaks):.3f} GiB; launches {launches} (first run); "
        f"{lowering}; single process (BIGSLICE_PARSE_PROCS=0): wall "
        f"{solo:.4f} s (median of {HOST_WARM_RUNS}: "
        f"{', '.join(f'{w:.4f}' for w in solo_walls)}), sweep "
        f"{solo_sweep:.4f} s, rungs {solo_rungs} ({HOST_WARM_RUNS} runs), "
        f"on "
        f"{card}")
    out = {"urls": dict(
        launches=launches, wall_s=wall, walls_s=walls, rows=n,
        rows_per_s=n / wall, sweep_s=sweep, sweeps_s=sweeps,
        first_wall_s=first_wall, first_sweep_s=first_sweep, rungs=rungs,
        native_calls=calls, native_built=built, pool_procs=procs,
        pool_startup_s=startup_s,
        pool_rss_anon_gib=[mem_start.tolist(), mem_end.tolist()],
        host_peak_rss_gib=host_peak, peak_gib=max(peaks),
        single_process_wall_s=solo, single_process_walls_s=solo_walls,
        single_process_sweep_s=solo_sweep, **lowering)}

    # The host str-key count of the first lines, and the encoded count
    # of the same lines (parsed in this process: the pool is down).
    head = lines[:URLS_HOST_LINES >> SHIFT]
    head_want = collections.Counter(urls._domain(u) for u in head)
    os.environ["BIGSLICE_PARSE_PROCS"] = "0"
    try:
        encoded = urls.domain_count_encoded(bs.Session(), S, head)
    finally:
        os.environ.pop("BIGSLICE_PARSE_PROCS", None)
    check(encoded, head_want, "urls (encoded, head)")
    ck.reset_launches()
    native.reset_calls()
    t0 = time.perf_counter()
    res = bs.Session().run(urls.domain_count(S, head))
    host_rows = res.rows()
    host_wall = time.perf_counter() - t0
    host_launches = dict(ck.LAUNCHES)
    crc_calls = native.CALLS["crc32_strings"]
    if sorted(host_rows) != sorted(encoded):
        raise AssertionError("urls: domain_count differs from "
                             "domain_count_encoded on the same lines")
    if built["strlist"] and not crc_calls:
        raise AssertionError("urls: the native CRC did not run")
    log(f"phase 23: urls: domain_count(4, lines) (host str keys) over "
        f"{len(head)} lines: wall {host_wall:.4f} s, "
        f"{len(head) / host_wall:.1f} lines/s, native CRC calls "
        f"{crc_calls}, launches {host_launches}, equal to the encoded "
        f"count, on {card}")
    out["urls-host"] = dict(launches=host_launches, wall_s=host_wall,
                            rows=len(head),
                            rows_per_s=len(head) / host_wall,
                            native_crc_calls=crc_calls)
    return out


def phase24_dict_wordcount(card: str, wordcount_path: dict,
                           fallback_path: dict) -> dict:
    """dict-wordcount: phase 17's corpus through
    ``dictenc.dict_encoded_reduce(Session(), ...)``: ``Flatmap`` of each
    line to (word, 1), a ``MapBatches`` encode against the corpus's
    vocabulary (built once, outside the wall), then
    ``Reduce(dense_keys=len(vocab))`` on the card, decoded at the edge;
    equal to collections.Counter, the counts phase 17 checks. Once
    counted and ``HOST_WARM_RUNS`` times warm; phases 17 and 22's walls
    (the same traffic on the str-key host path, the native CRC in place)
    are printed beside."""
    import collections
    import shutil
    import tempfile

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.frame import dictenc
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    S = 4
    tmp = tempfile.mkdtemp(prefix="chip-smoke-dictwc-")
    path = os.path.join(tmp, "corpus.txt")
    try:
        words = wordcount_corpus(path)
        want = collections.Counter(words)
        t0 = time.perf_counter()
        vocab = dictenc.GlobalVocab(sorted(want))
        vocab_s = time.perf_counter() - t0

        def run():
            sess = bs.Session()
            pairs = bs.Flatmap(bs.ScanReader(S, path),
                               lambda line: [(w, 1) for w in line.split()],
                               out=[str, np.int32])
            t0 = time.perf_counter()
            rows = dictenc.dict_encoded_reduce(sess, pairs,
                                               lambda a, b: a + b, vocab)
            return sess, rows, time.perf_counter() - t0

        def check(rows) -> None:
            if len(rows) != len(want) or dict(rows) != want:
                raise AssertionError("dict-wordcount: counts differ from "
                                     "collections.Counter")

        ck.reset_launches()
        sess, rows, first = run()
        launches = dict(ck.LAUNCHES)
        check(rows)
        lowering = dict(hash_off=sorted(sess.executor.hash_off),
                        auto_dense_off=sorted(sess.executor.auto_dense_off))
        del sess, rows
        walls, peaks = [], []
        for _ in range(HOST_WARM_RUNS):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sess, rows, wall = run()
            walls.append(wall)
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            check(rows)
            del sess, rows
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = statistics.median(walls)
    n = len(words)
    log(f"phase 24: dict-wordcount {n} words ({len(vocab)} distinct), "
        f"S={S}, Session(): warm wall {wall:.4f} s (median of "
        f"{HOST_WARM_RUNS}: "
        f"{', '.join(f'{w:.4f}' for w in walls)}), {n / wall:.1f} words/s, "
        f"first run {first:.4f} s, vocabulary {vocab_s:.4f} s (once, "
        f"outside the wall); beside it, the str-key host path with the "
        f"native CRC: phase 17 (LocalExecutor) "
        f"{wordcount_path['wall_s']:.4f} s, phase 22 (Session()) "
        f"{fallback_path['wall_s']:.4f} s; peak device memory "
        f"{max(peaks):.3f} GiB, launches {launches} (first run); "
        f"{lowering}, on {card}")
    return dict(launches=launches, wall_s=wall, walls_s=walls, rows=n,
                rows_per_s=n / wall, first_wall_s=first, vocab_s=vocab_s,
                peak_gib=max(peaks), **lowering)


def _all_tasks(roots) -> list:
    """Every task of a compiled graph, from its roots."""
    seen, stack = {}, list(roots)
    while stack:
        t = stack.pop()
        if id(t) not in seen:
            seen[id(t)] = t
            stack.extend(p for d in t.deps for p in d.tasks)
    return list(seen.values())


def phase25_cache(card: str, mesh_shards) -> dict:
    """cache: ``Cache(Reduce(Const(4, keys, ones), add), prefix)`` at
    phase 3's shape (2**25 int32 keys uniform over 2**20) through
    ``Session(executor=MeshExecutor(auto_dense=False))`` under a temp
    directory: the write (K1 and K2 launch; the shards bit-equal to
    phase 3's); a fresh session and executor over the same prefix (the
    same rows, no K1 or K2 launch, no Reduce or Const task in the
    graph, no group on the device path); ``CachePartial`` with one
    shard file deleted (that file rewritten, byte-equal); ``ReadCache``
    (the same rows). The write and the read each once counted and three
    times warm, with the bytes on disk a second."""
    import shutil
    import tempfile

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.ops.cache import shard_path
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    S = 4
    keys, ones = _reduce_wave_input(n=(1 << 25) >> SHIFT,
                                    span=(1 << 20) >> SHIFT)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-cache-")
    prefix = os.path.join(tmp, "counts")
    files = [shard_path(prefix, s, S) for s in range(S)]

    def add(a, b):
        return a + b

    def build(cache=bs.Cache):
        return cache(bs.Reduce(bs.Const(S, keys, ones), add), prefix)

    def run(slice_):
        sess = bs.Session(executor=bs.MeshExecutor(auto_dense=False))
        t0 = time.perf_counter()
        res = sess.run(slice_)
        shards = bs.result_shard_rows(res)
        return sess, res, shards, time.perf_counter() - t0

    def write():
        for f in files:
            if os.path.exists(f):
                os.remove(f)
        return run(build())

    def read():
        s = build()
        if s.deps() != ():
            raise AssertionError("cache: a cached slice kept its deps")
        sess, res, shards, wall = run(s)
        tasks = _all_tasks(res.tasks)
        if len(tasks) != S or any(isinstance(c, (bs.Reduce, bs.Const))
                                  for t in tasks for c in t.chain):
            raise AssertionError("cache: the cached run compiled producer "
                                 "tasks")
        if sess.executor._outputs:
            raise AssertionError("cache: a cached run used the device path")
        return sess, res, shards, wall

    def timed(fn, label, check):
        walls = []
        for _ in range(WARM_RUNS):
            gc.collect()
            torch.cuda.synchronize()
            sess, res, shards, wall = fn()
            walls.append(wall)
            check(shards, label)
            del sess, res, shards
        return walls

    try:
        ck.reset_launches()
        _, _, shards, first_w = write()
        wl = dict(ck.LAUNCHES)
        if wl["hash_partition"] <= 0 or wl["hash_aggregate"] <= 0:
            raise AssertionError(f"cache: the write launched {wl}")
        _same_rows(shards, mesh_shards, "cache write against phase 3")
        nbytes = sum(os.path.getsize(f) for f in files)
        ck.reset_launches()
        _, _, shards, first_r = read()
        rl = dict(ck.LAUNCHES)
        if any(rl.values()):
            raise AssertionError(f"cache: the cached run launched {rl}")
        _same_rows(shards, mesh_shards, "cache read against phase 3")
        with open(files[2], "rb") as fh:
            before = fh.read()
        os.remove(files[2])
        partial = build(bs.CachePartial)
        if partial.cache.present != [True, True, False, True]:
            raise AssertionError("cache: CachePartial's presence scan")
        _, _, shards, partial_s = run(partial)
        _same_rows(shards, mesh_shards, "CachePartial against phase 3")
        with open(files[2], "rb") as fh:
            if fh.read() != before:
                raise AssertionError("cache: CachePartial rewrote the shard "
                                     "file with other bytes")
        res = bs.Session().run(bs.ReadCache([np.int32, np.int32], S, prefix))
        _same_rows(bs.result_shard_rows(res), mesh_shards,
                   "ReadCache against phase 3")
        del res
        wwalls = timed(write, "cache write",
                       lambda sh, w: _same_rows(sh, mesh_shards, w))
        rwalls = timed(read, "cache read",
                       lambda sh, w: _same_rows(sh, mesh_shards, w))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ww, rw = statistics.median(wwalls), statistics.median(rwalls)
    n = len(keys)
    log(f"phase 25: cache: Cache(Reduce(Const({S}, keys, ones)), prefix), "
        f"{n} rows, {nbytes} bytes on disk in {S} files: write warm wall "
        f"{ww:.4f} s (median of {WARM_RUNS}: "
        f"{', '.join(f'{w:.4f}' for w in wwalls)}), {nbytes / ww:.1f} "
        f"bytes/s, launches {wl} (first run {first_w:.4f} s); cached read "
        f"warm wall {rw:.4f} s (median of {WARM_RUNS}: "
        f"{', '.join(f'{w:.4f}' for w in rwalls)}), {nbytes / rw:.1f} "
        f"bytes/s, launches {rl} (first run {first_r:.4f} s); CachePartial "
        f"with one shard deleted {partial_s:.4f} s (rewritten, "
        f"byte-equal), ReadCache equal; on {card}")
    return {"cache-write": dict(launches=wl, wall_s=ww, walls_s=wwalls,
                                rows=n, rows_per_s=n / ww, bytes=nbytes,
                                bytes_per_s=nbytes / ww),
            "cache-read": dict(launches=rl, wall_s=rw, walls_s=rwalls,
                               rows=n, rows_per_s=n / rw, bytes=nbytes,
                               bytes_per_s=nbytes / rw,
                               partial_s=partial_s)}


def _spill_stats(ex) -> dict:
    """What the first run spilled: boundaries, bytes, rows and
    partitions written, and the plans chosen."""
    from bigslice_tpu_torch.exec import shuffleplan

    spilled = [o for o in ex._outputs.values()
               if isinstance(o, shuffleplan.SpilledGroupOutput)]
    return dict(boundaries=len(spilled),
                bytes=sum(o.exchange.spill_bytes for o in spilled),
                rows=sum(o.exchange.spill_rows for o in spilled),
                partitions=sum(o.exchange.partitions_written()
                               for o in spilled),
                plans=sorted({f"{p.kind}/{p.reason}"
                              for p in ex.shuffle_plans.values()}))


def _hub_launches(summary) -> dict:
    """Launches per kernel the hub attributed to the run's ops."""
    got = {name: 0 for name in PATH_KERNELS}
    for per_kernel in summary["device"]["kernels"].values():
        for name, k in per_kernel.items():
            got[name] += k["launches"]
    return got


def _expected_part_rows(keys, S, span=1 << 20) -> list:
    """Rows out of the map side's combine a partition: each Const
    shard's distinct keys, each key in the partition the plain K1 names
    on a CPU copy."""
    from bigslice_tpu_torch.parallel.cuda_kernels import hash_partition_plain

    part_of, _ = hash_partition_plain(
        [torch.arange(span, dtype=torch.int32)], S, 0, False, None)
    part_of = part_of.numpy()
    n = len(keys)
    base, extra = divmod(n, S)
    want = np.zeros(S, np.int64)
    for shard in range(S):
        start = shard * base + min(shard, extra)
        end = start + base + (1 if shard < extra else 0)
        uniq = np.unique(keys[start:end])
        want += np.bincount(part_of[uniq], minlength=S)
    return want.tolist()


def _count_syncs(fn, sites: list = None) -> int:
    """Host syncs of one call: each operation that waits for the device
    warns under torch's sync debug mode. With ``sites``, the Python
    line each sync came from is appended to it."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    if sites is not None:
        sites.extend(f"{os.path.basename(w.filename)}:{w.lineno}"
                     for w in syncs)
    return len(syncs)


def _trace_launch_lags(events) -> dict:
    """A profiler trace's runtime launches against its kernel events,
    joined on the correlation id: the launch-to-kernel-start lag (a
    negative lag is a clock skew between the host's and the card's
    timestamps), the launches with no kernel event (all, and those
    after the profiler's warm-up range), and where in the
    trace (us from its first event) each K1 kernel and each launch
    without a kernel lies."""
    timed = [e for e in events if "ts" in e and e.get("ph") != "M"]
    t0 = min(float(e["ts"]) for e in timed) if timed else 0.0
    launch = {e.get("args", {}).get("correlation"): float(e["ts"])
              for e in timed if e.get("cat") in ("cuda_runtime",
                                                 "cuda_driver")
              and "aunch" in str(e.get("name", ""))}
    kernels = [e for e in timed if e.get("cat") == "kernel"]
    seen = {e.get("args", {}).get("correlation") for e in kernels}
    lags = sorted(float(e["ts"]) - launch[c] for e in kernels
                  if (c := e.get("args", {}).get("correlation")) in launch)
    warm_end = max((float(e["ts"]) + float(e.get("dur", 0)) for e in timed
                    if e.get("name") == "xprof_warmup"), default=None)
    return {
        "lag_us_min": round(lags[0], 1) if lags else None,
        "lag_us_median": round(statistics.median(lags), 1) if lags
        else None,
        "launches": len(launch), "kernels": len(kernels),
        "orphans": sum(1 for c in launch if c not in seen),
        "orphans_after_warmup": None if warm_end is None else sum(
            1 for c, t in launch.items() if c not in seen and t > warm_end),
        "orphan_at_us": sorted(round(t - t0, 1) for c, t in launch.items()
                               if c not in seen)[:8],
        "k1_at_us": [round(float(e["ts"]) - t0, 1) for e in kernels
                     if "hash_partition_kernel" in str(e.get("name"))],
        "trace_us": round(max(float(e["ts"]) + float(e.get("dur", 0))
                              for e in timed) - t0, 1) if timed else 0.0,
    }


def phase26_observability(card: str, kern: dict) -> dict:
    """observability: the telemetry hub, the trace, the profiler window
    and user metrics over the main path (the module docstring's (a) to
    (f))."""
    import collections
    import tempfile

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.task import iter_tasks
    from bigslice_tpu_torch.parallel import cuda_kernels as ck
    from bigslice_tpu_torch.utils import metrics, xprof

    S = 4
    keys, ones = _reduce_wave_input()
    n = len(keys)
    check = _count_check(keys)
    out_dir = tempfile.mkdtemp(prefix="chip-smoke-obs-")

    def reduce_slice():
        return bs.Reduce(bs.Const(S, keys, ones), lambda a, b: a + b)

    def read_all(res):
        for shard in range(S):
            list(res.reader(shard, ()))

    # -- (a) the main path at full width with the hub on.
    trace_path = os.path.join(out_dir, "trace.json")
    events = []
    ex = bs.MeshExecutor(auto_dense=False)
    sess = bs.Session(executor=ex, trace_path=trace_path,
                      eventer=lambda name, **f: events.append(name))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    t0 = time.perf_counter()
    res = sess.run(reduce_slice())
    read_all(res)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    summary = sess.telemetry_summary()
    check(bs.result_shard_rows(res), S)
    for name in ("hash_partition", "hash_aggregate"):
        if launches[name] <= 0:
            raise AssertionError(f"observability: {name} did not launch")
    skews = {op: e["skew"] for op, e in summary["ops"].items()
             if "skew" in e}
    if len(skews) != 1:
        raise AssertionError(f"observability: {len(skews)} shuffle "
                             f"boundaries, not one")
    (map_op, skew), = skews.items()
    want_rows = _expected_part_rows(keys, S)
    overflowed = sorted(ex.hash_off)
    if overflowed:
        # The sort path's combine-shuffle emits the same rows: one a
        # distinct key of a shard.
        log(f"phase 26: hash tables overflowed at {overflowed}; the "
            f"vector is the sort fallback's")
    if skew["rows"] != want_rows:
        raise AssertionError(f"observability: hub vector {skew['rows']} != "
                             f"numpy {want_rows}")
    hub_launches = _hub_launches(summary)
    if hub_launches != launches:
        raise AssertionError(f"observability: hub launches {hub_launches} "
                             f"!= LAUNCHES {launches}")
    per_launch = {}
    map_kernels = summary["device"]["kernels"][map_op]
    for name in ("hash_partition", "hash_aggregate"):
        k = map_kernels[name]
        per_launch[name] = k["bytes"] / k["launches"]
        if not overflowed and per_launch[name] != kern[name]["bound_bytes"]:
            raise AssertionError(
                f"observability: {name} declared {per_launch[name]} bytes "
                f"a map-side launch, phase 2's bound "
                f"{kern[name]['bound_bytes']}")
    hbm = summary["device"]["hbm"]
    if hbm["source"] != "memory_stats" or hbm["peak_bytes"] != peak:
        raise AssertionError(f"observability: hub peak {hbm['peak_bytes']} "
                             f"!= max_memory_allocated {peak}")
    # Independent of the allocator: a map wave's staged columns (its
    # share of keys and values) were on the card at once, and the peak
    # fits the card.
    wave_bytes = (keys.nbytes + ones.nbytes) // S
    total = torch.cuda.get_device_properties(0).total_memory
    if not wave_bytes <= hbm["peak_bytes"] <= total:
        raise AssertionError(f"observability: hub peak {hbm['peak_bytes']} "
                             f"outside [{wave_bytes}, {total}]")
    clock = ex.staging_seconds()
    hub_ops = [sess.telemetry._ops[op] for op in summary["ops"]
               if "waves" in summary["ops"][op]]
    hub_staged = sum(r.staging_s for r in hub_ops)
    hub_exposed = sum(r.exposed_s for r in hub_ops)
    if (sum(r.staged_waves for r in hub_ops) != clock["waves"]
            or abs(hub_staged - clock["staged_s"]) > 1e-9
            or abs(hub_exposed - clock["exposed_s"]) > 1e-9):
        raise AssertionError(f"observability: hub staging {hub_staged} / "
                             f"{hub_exposed} != staging_seconds {clock}")
    sess.shutdown()
    with open(trace_path) as fh:
        trace = json.load(fh)["traceEvents"]
    ntasks = len(iter_tasks(res.tasks))  # the Reduce's and the Const's
    complete = [e for e in trace if e["ph"] == "X"]
    if len(complete) != ntasks:
        raise AssertionError(f"observability: {len(complete)} complete "
                             f"trace events for {ntasks} tasks")
    overlap = summary["overlap_efficiency"]
    log(f"phase 26a: reduce-wave {n} rows with the hub: wall {wall:.4f} s, "
        f"vector {skew['rows']} (ratio {skew['ratio']}, hot "
        f"{skew['max_shard']}), launches {launches} = hub's, declared "
        f"bytes a map-side launch K1 {per_launch['hash_partition']:.0f} "
        f"K2 {per_launch['hash_aggregate']:.0f} (phase 2's bounds), peak "
        f"{peak} bytes = hub's (>= a wave's staged {wave_bytes}), staging {hub_staged:.6f} s exposed "
        f"{hub_exposed:.6f} s = staging_seconds(), overlap {overlap}, "
        f"{len(complete)} complete trace events, {len(events)} events, "
        f"on {card}")
    del res
    gc.collect()

    # -- (b) the local tier: rows routed a partition before the combine.
    lsess = bs.Session(executor=bs.LocalExecutor())
    lres = lsess.run(reduce_slice())
    read_all(lres)
    lsum = lsess.telemetry_summary()
    lskews = [e["skew"] for e in lsum["ops"].values() if "skew" in e]
    part_of, _ = ck.hash_partition_plain(
        [torch.arange(1 << 20, dtype=torch.int32)], S, 0, False, None)
    want_local = np.bincount(part_of.numpy()[keys], minlength=S).tolist()
    if len(lskews) != 1 or lskews[0]["rows"] != want_local:
        raise AssertionError(f"observability: local vector "
                             f"{[k['rows'] for k in lskews]} != "
                             f"{want_local}")
    log(f"phase 26b: local tier routed vector {want_local} = np.bincount "
        f"of the plain K1, bytes {lskews[0]['bytes']}")
    del lres
    gc.collect()

    # -- (c) the cost of the collection: ten alternating pairs.
    def run_once(telemetry_on: bool):
        if telemetry_on:
            os.environ.pop("BIGSLICE_TELEMETRY", None)
        else:
            os.environ["BIGSLICE_TELEMETRY"] = "0"
        try:
            s_ = bs.Session(executor=bs.MeshExecutor(auto_dense=False))
            t = time.perf_counter()
            r = s_.run(reduce_slice())
            read_all(r)
            torch.cuda.synchronize()
            return time.perf_counter() - t
        finally:
            os.environ.pop("BIGSLICE_TELEMETRY", None)

    run_once(False)
    run_once(True)  # warm both
    on_s, off_s = [], []
    for i in range(10):
        order = (False, True) if i % 2 == 0 else (True, False)
        for flag in order:
            (on_s if flag else off_s).append(run_once(flag))
        gc.collect()
    # Host syncs a run, each way after one uncounted warm-up count: the
    # first run counted under the sync debug mode can count one sync
    # more than the runs after it.
    syncs_off, syncs_on = [], []
    sites = {False: [], True: []}
    _count_syncs(lambda: run_once(False))
    _count_syncs(lambda: run_once(True))
    for _ in range(3):
        for flag, out in ((False, syncs_off), (True, syncs_on)):
            where: list = []
            out.append(_count_syncs(lambda: run_once(flag), where))
            sites[flag].append(collections.Counter(where))
    med_on, med_off = statistics.median(on_s), statistics.median(off_s)
    log(f"phase 26c: ten alternating pairs, hub on {med_on:.4f} s, off "
        f"{med_off:.4f} s (median), ratio {med_on / med_off:.4f}; on "
        f"{', '.join(f'{w:.4f}' for w in on_s)}; off "
        f"{', '.join(f'{w:.4f}' for w in off_s)}; host syncs a run: on "
        f"{syncs_on}, off {syncs_off}, on {card}")
    if syncs_on != syncs_off:
        for flag in (False, True):
            log(f"phase 26c: sync sites, hub {'on' if flag else 'off'}: "
                f"{[dict(c) for c in sites[flag]]}")
        raise AssertionError(f"observability: the hub changed the host "
                             f"syncs a run ({syncs_off} -> {syncs_on})")

    # -- (d) a profiler window around one run of (a): the window on this
    # thread (the profiler starts where its client registered), the run
    # on another once the window is up. The window closes when the run
    # has synchronised (its length is only a cap), and opens with the
    # profiler's warm-up burst (utils/xprof.py), which takes the first
    # device records that a session late in a long process drops.
    psess = bs.Session(executor=bs.MeshExecutor(auto_dense=False))
    prof = xprof.Profiler(device="cuda")
    failed = []
    run_done = threading.Event()
    run_s = []

    def run_in_window():
        try:
            # Run once the profiler records (its start takes a while).
            deadline = time.monotonic() + 60
            while not xprof.recording():
                if time.monotonic() > deadline:
                    raise AssertionError("observability: the profiler "
                                         "window never started")
                time.sleep(0.01)
            time.sleep(0.2)
            t = time.perf_counter()
            read_all(psess.run(reduce_slice()))
            torch.cuda.synchronize()
            run_s.append(time.perf_counter() - t)
            if not xprof.recording():
                raise AssertionError(f"observability: the profiler window "
                                     f"closed before the run ended "
                                     f"({run_s[0]:.4f} s)")
        except BaseException as e:  # noqa: BLE001 — re-raised below
            failed.append(e)
        finally:
            run_done.set()

    th = threading.Thread(target=run_in_window)
    th.start()
    t_window = time.perf_counter()
    window = prof.window(120.0, out_dir=os.path.join(out_dir, "w"),
                         until=run_done)
    held = time.perf_counter() - t_window
    th.join()
    if failed:
        raise failed[0]
    ptrace = os.path.join(window["dir"], "trace.json")
    if not os.path.exists(ptrace):
        raise AssertionError(f"observability: no trace in {window}")
    with open(ptrace) as fh:
        pevents = json.load(fh)["traceEvents"]
    kern_us = {"hash_partition": 0.0, "hash_aggregate": 0.0}
    kern_n = {"hash_partition": 0, "hash_aggregate": 0}
    for e in pevents:
        nm = str(e.get("name", ""))
        if e.get("cat") != "kernel":
            continue
        if "hash_partition_kernel" in nm:
            kern_us["hash_partition"] += float(e.get("dur", 0))
            kern_n["hash_partition"] += 1
        elif "agg_" in nm and "_kernel" in nm:
            kern_us["hash_aggregate"] += float(e.get("dur", 0))
            kern_n["hash_aggregate"] += 1
    psum = psess.telemetry_summary()["device"]["kernels"]
    plaunch = _hub_launches(psess.telemetry_summary())
    if not (kern_n["hash_partition"] and kern_n["hash_aggregate"]):
        raise AssertionError(f"observability: the profiler trace names no "
                             f"K1 or K2 kernel ({kern_n})")
    lag = _trace_launch_lags(pevents)
    if kern_n["hash_partition"] != plaunch["hash_partition"]:
        log(f"phase 26d: the window misses a K1 kernel: window held "
            f"{held:.4f} s around a run of {run_s[0]:.4f} s; {lag}")
        raise AssertionError(f"observability: the window holds "
                             f"{kern_n['hash_partition']} K1 kernels of the "
                             f"run's {plaunch['hash_partition']}")
    achieved = {}
    for name in kern_us:
        declared = sum(per[name]["bytes"] for per in psum.values()
                       if name in per)
        achieved[name] = declared / (kern_us[name] * 1e-6)
    log(f"phase 26d: profiler window held {held:.4f} s (cap "
        f"{window['seconds']} s) around a run of {run_s[0]:.4f} s, trace "
        f"{os.path.getsize(ptrace)} bytes, kernel events {kern_n}, device "
        f"us {kern_us}, achieved bytes/s K1 "
        f"{achieved['hash_partition']:.4e} K2 "
        f"{achieved['hash_aggregate']:.4e} (declared bytes over profiled "
        f"time; peak {HBM_BYTES_PER_S:.3e}), launch to kernel start "
        f"us min {lag['lag_us_min']} median {lag['lag_us_median']}, "
        f"launches with no kernel event {lag['orphans']} of "
        f"{lag['launches']} (the warm-up's {xprof.WARMUP_KERNELS} fills "
        f"included), {lag['orphans_after_warmup']} after the warm-up, on "
        f"{card}")

    # -- (e) user metrics: exact at 2**20 rows, a Python call a row.
    m = 1 << 20
    counter = metrics.new_counter("chip_smoke_rows")

    def count_row(x):
        counter.incr()
        return x

    mp = bs.Map(bs.Const(S, np.arange(m, dtype=np.int32)), count_row,
                out=[np.int32])
    if mp.mode != "host":
        raise AssertionError("observability: a counting Map is not host "
                             "tier")
    t0 = time.perf_counter()
    mres = bs.Session().run(mp)
    mwall = time.perf_counter() - t0
    got = counter.value(mres.scope)
    if got != m:
        raise AssertionError(f"observability: counter {got} != {m}")
    log(f"phase 26e: a Counter in a host-tier Map counted {got} rows "
        f"exactly in {mwall:.4f} s (cut to 2**20 rows: one Python call a "
        f"row)")

    # -- (f) the machine's packages, for the data plane's next slice.
    found = {}
    for pkg in ("pyarrow", "fsspec"):
        try:
            mod = __import__(pkg)
            found[pkg] = getattr(mod, "__version__", "present")
        except ImportError:
            found[pkg] = None
    log(f"phase 26f: pyarrow {found['pyarrow']}, fsspec {found['fsspec']}")
    return dict(launches=launches, wall_s=wall, rows=n,
                vector=skew["rows"], local_vector=want_local,
                peak_bytes=peak, staging=clock, overlap=overlap,
                declared_bytes_per_launch=per_launch,
                pairs_on_s=on_s, pairs_off_s=off_s, median_on_s=med_on,
                median_off_s=med_off, ratio=med_on / med_off,
                syncs_on=syncs_on, syncs_off=syncs_off,
                profiler_kernel_us=kern_us, achieved_bytes_per_s=achieved,
                counter_rows=got, packages=found)


# -- phase 27: the data plane (Parquet, URL stores, spill, cache) and kmeans


#: Phase 27's Parquet rows (phase 3's shape), key span and row groups.
PARQUET_ROWS = 1 << 25
PARQUET_SPAN = 1 << 20
PARQUET_GROUPS = 32
#: Phase 27's warm runs of each Parquet path (the median is reported).
PARQUET_WARM_RUNS = 2
#: Phase 27e: points, dimension, blobs and centroids, iterations, shards.
KMEANS_N, KMEANS_D, KMEANS_K, KMEANS_ITERS = 1 << 20, 128, 1024, 5
#: Phase 27e: the centroids' tolerance against float64 sums of the same
#: assignment (float32 accumulation of about n / k points a centroid).
KMEANS_RTOL, KMEANS_ATOL = 1e-4, 1e-3


def _parquet_input():
    """27a's rows: int64 keys uniform over 2**20 and int64 values over
    +-2**40 (each wraps when cast down to int32), from default_rng(27)."""
    rng = np.random.default_rng(27)
    n, span = PARQUET_ROWS >> SHIFT, PARQUET_SPAN >> SHIFT
    keys = rng.integers(0, span, n, dtype=np.int64)
    vals = rng.integers(-(1 << 40), 1 << 40, n, dtype=np.int64)
    return keys, vals


def _parquet_want(keys, vals):
    """Each present key (int32) and its sum as the device adds it (int32,
    wrapping), from numpy: the float64 bincount of the cast-down values
    is exact (each |sum| < 2**53)."""
    span = PARQUET_SPAN >> SHIFT
    sums = np.bincount(keys, weights=vals.astype(np.int32), minlength=span)
    present = np.nonzero(np.bincount(keys, minlength=span))[0]
    return (present.astype(np.int32),
            sums[present].astype(np.int64).astype(np.int32))


def _sum_check(want):
    """Rows of a summing Reduce against ``want``, each row in the shard
    the plain K1 names."""
    wk, wv = want

    def check(shards, S):
        k = np.concatenate([s[0] for s in shards])
        v = np.concatenate([s[1] for s in shards])
        o = np.argsort(k)
        if not (np.array_equal(k[o], wk) and np.array_equal(v[o], wv)):
            raise AssertionError("sums differ from numpy")
        _shard_keys_routed(shards, S)

    return check


def _parquet_files(url_prefix, S):
    """The shards ``Result.write_parquet`` wrote, read back with pyarrow
    as numpy columns (key, sum)."""
    import fsspec
    import pyarrow.parquet as pq

    out = []
    for s in range(S):
        with fsspec.open(f"{url_prefix}-{s:04d}-of-{S:04d}.parquet",
                         "rb") as fh:
            t = pq.read_table(fh)
        out.append([np.array(t.column(0)), np.array(t.column(1))])
    return out


def _kmeans_points():
    """27e's points: 2**20 float32 rows of d = 128 around 1024 centres
    (normal, sd 10 a coordinate) with unit Gaussian noise, from
    default_rng(27): a SIFT1M-shaped IVF training set."""
    rng = np.random.default_rng(27)
    n, d, k = KMEANS_N >> SHIFT, KMEANS_D, KMEANS_K >> SHIFT
    centres = rng.normal(0.0, 10.0, (k, d))
    labels = rng.integers(0, k, n)
    return (centres[labels] + rng.standard_normal((n, d))).astype(np.float32)


def _kmeans_check(sess, base, points_dev, before, after, it):
    """One iteration of the port's kmeans against float64 on the card,
    from the same centroids: the port's assignments (its device Map over
    ``base``, read on the card) against float64 argmin, a flip allowed
    only where the two distances lie within float32 rounding; the
    port's centroids against float64 means of the port's assignment.
    Returns (flips, largest centroid error)."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.models import kmeans as km

    res = sess.run(bs.Map(base, km._assign_vec, args=(before,)))
    port = torch.cat([f.cols[0] for s in range(res.num_shards)
                      for f in res.reader(s, ())]).to(points_dev.device,
                                                       torch.int64)
    x = points_dev.to(torch.float64)
    c = torch.from_numpy(before).to(points_dev.device, torch.float64)
    d2 = (torch.sum(c * c, 1)[None, :] - 2.0 * x @ c.T
          + torch.sum(x * x, 1)[:, None])
    ref = torch.argmin(d2, 1)
    flips = torch.nonzero(port != ref)[:, 0]
    if len(flips):
        # The float32 rank expansion's rounding: d products of |c||x|
        # and ||c||^2 terms, each within d * eps32 of its magnitude.
        eps = float(np.finfo(np.float32).eps)
        d = x.shape[1]
        xa = x[flips].abs()
        gap = (d2[flips, port[flips]] - d2[flips, ref[flips]]).abs()
        scale = torch.maximum(
            torch.sum(c[port[flips]] ** 2, 1)
            + 2 * torch.sum(c[port[flips]].abs() * xa, 1),
            torch.sum(c[ref[flips]] ** 2, 1)
            + 2 * torch.sum(c[ref[flips]].abs() * xa, 1))
        if bool((gap > 2 * d * eps * scale).any()):
            raise AssertionError(f"kmeans iteration {it}: an assignment "
                                 f"flipped beyond float32 rounding")
    k = c.shape[0]
    sums = torch.zeros_like(c).index_add_(0, port, x)
    counts = torch.bincount(port, minlength=k).to(torch.float64)
    want = torch.where(counts[:, None] > 0,
                       sums / counts.clamp(min=1)[:, None], c).cpu().numpy()
    err = np.abs(after.astype(np.float64) - want)
    if not np.all(err <= KMEANS_ATOL + KMEANS_RTOL * np.abs(want)):
        raise AssertionError(f"kmeans iteration {it}: centroids off by "
                             f"{err.max()} (rtol {KMEANS_RTOL}, atol "
                             f"{KMEANS_ATOL})")
    del res
    return len(flips), float(err.max())


def phase27_data_plane(card: str) -> dict:
    """data plane: the module docstring's (a) to (d)."""
    import shutil
    import tempfile

    import fsspec
    import pyarrow as pa
    import pyarrow.parquet as pq

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    S = 4
    tag = f"chip-smoke-{os.getpid()}"
    url = f"memory://{tag}/in/rows.parquet"
    keys, vals = _parquet_input()
    n = len(keys)
    want = _parquet_want(keys, vals)
    check = _sum_check(want)
    t0 = time.perf_counter()
    with fsspec.open(url, "wb") as fh:
        pq.write_table(pa.table({"k": keys, "v": vals}), fh,
                       row_group_size=n // PARQUET_GROUPS)
    write_s = time.perf_counter() - t0
    nbytes = fsspec.filesystem("memory").info(f"/{tag}/in/rows.parquet")[
        "size"]
    tmp = tempfile.mkdtemp(prefix="chip-smoke-parquet-")
    out = {}

    def add(a, b):
        return a + b

    def run(make, auto_dense, env=None):
        """A counted first run, then PARQUET_WARM_RUNS warm runs of
        ``Reduce(src, add)`` (``make()`` gives the reader and ``src``),
        each a new session and executor; every run checked."""
        saved = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        try:
            first = None
            walls, peaks, decode = [], [], []
            for i in range(1 + PARQUET_WARM_RUNS):
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ck.reset_launches()
                reader, src = make()
                ex = bs.MeshExecutor(auto_dense=auto_dense)
                sess = bs.Session(executor=ex)
                t0 = time.perf_counter()
                res = sess.run(bs.Reduce(src, add))
                shards = bs.result_shard_rows(res)
                wall = time.perf_counter() - t0
                check(shards, S)
                if i == 0:
                    first = dict(launches=dict(ck.LAUNCHES), first_s=wall,
                                 auto_dense_off=sorted(ex.auto_dense_off),
                                 hash_off=sorted(ex.hash_off),
                                 plans=sorted({f"{p.kind}/{p.reason}" for p
                                               in ex.shuffle_plans.values()}),
                                 stats=reader.stats(), res=res,
                                 shards=shards)
                else:
                    walls.append(wall)
                    peaks.append(torch.cuda.max_memory_allocated() / 2**30)
                    decode.append(reader.stats()["decode_s"])
                    sess.shutdown()
                    del res, sess
            return dict(first, walls_s=walls, wall_s=statistics.median(walls),
                        peak_gib=max(peaks), decode_s=decode,
                        rows_per_s=n / statistics.median(walls))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def report(label, r):
        log(f"phase 27{label}: warm wall {r['wall_s']:.4f} s (median of "
            f"{len(r['walls_s'])}: {', '.join(f'{w:.4f}' for w in r['walls_s'])}"
            f"), {r['rows_per_s']:.1f} rows/s, peak device memory "
            f"{r['peak_gib']:.3f} GiB; Parquet decode (the reader's timer, "
            f"summed over {S} shard threads) "
            f"{', '.join(f'{s:.4f}' for s in r['decode_s'])} s; first run "
            f"{r['first_s']:.4f} s, launches {r['launches']}, row groups "
            f"{r['stats']['row_groups']}, auto_dense_off "
            f"{r['auto_dense_off']}, hash_off {r['hash_off']}, plans "
            f"{r['plans']}; on {card}")

    def keep(r):
        return {k: v for k, v in r.items() if k not in ("res", "shards")}

    try:
        # -- (a) one file, row groups round-robin; K2's lowering, then
        # the default.
        def single():
            r = bs.ParquetReader(S, url, out=[np.int32, np.int32])
            return r, r

        log(f"phase 27a: {n} rows, {PARQUET_GROUPS} row groups, {nbytes} "
            f"bytes of Parquet in memory:// (written in {write_s:.4f} s)")
        ra = run(single, auto_dense=False)
        report("a parquet-reduce (auto_dense=False)", ra)
        if (ra["launches"]["hash_partition"] <= 0
                or ra["launches"]["hash_aggregate"] <= 0):
            raise AssertionError(f"parquet-reduce: launches {ra['launches']}")
        outp = f"memory://{tag}/out/sums"
        t0 = time.perf_counter()
        ra["res"].write_parquet(outp)
        wp_s = time.perf_counter() - t0
        back = _parquet_files(outp, S)
        check(back, S)
        log(f"phase 27a: write_parquet of {S} shards in {wp_s:.4f} s, read "
            f"back with pyarrow: every sum equal to numpy, every row in "
            f"its K1 shard")
        mesh_shards = ra["shards"]
        rd = run(single, auto_dense=True)
        report("a parquet-reduce (default)", rd)
        _same_rows(rd["shards"], mesh_shards, "27a default against "
                   "auto_dense=False")
        # -- (d) export 27a's result rows.
        res = ra["res"]
        t0 = time.perf_counter()
        table = res.to_arrow(names=["key", "sum"])
        arrow_s = time.perf_counter() - t0
        if table.num_rows != len(want[0]):
            raise AssertionError(f"to_arrow: {table.num_rows} rows")
        o = np.argsort(table.column(0).to_numpy())
        if not (np.array_equal(table.column(0).to_numpy()[o], want[0])
                and np.array_equal(table.column(1).to_numpy()[o], want[1])):
            raise AssertionError("to_arrow: rows differ from numpy")
        try:
            import pandas

            pandas_version = pandas.__version__
            t0 = time.perf_counter()
            df = res.to_pandas(names=["key", "sum"])
            pandas_s = time.perf_counter() - t0
            if len(df) != len(want[0]):
                raise AssertionError(f"to_pandas: {len(df)} rows")
        except ImportError:
            pandas_version, pandas_s = "absent", None
        log(f"phase 27d: to_arrow of {table.num_rows} rows in {arrow_s:.4f} "
            f"s (equal to numpy); pandas {pandas_version}"
            + (f", to_pandas {pandas_s:.4f} s" if pandas_s else ""))
        out["parquet-reduce"] = dict(keep(ra), write_parquet_s=wp_s,
                                     to_arrow_s=arrow_s, pandas=pandas_version,
                                     to_pandas_s=pandas_s, parquet_bytes=nbytes)
        out["parquet-reduce-default"] = keep(rd)
        del res, table

        # -- (b) 8 local files under a glob, a Reshuffle before the
        # Reduce (the host producer's boundary is the local store; the
        # device group's is spilled) under the spill exchange on a
        # memory:// base.
        files = 8
        per = n // files
        for i in range(files):
            pq.write_table(pa.table({"k": keys[i * per:(i + 1) * per],
                                     "v": vals[i * per:(i + 1) * per]}),
                           os.path.join(tmp, f"part-{i}.parquet"),
                           row_group_size=per // 4)
        spill = f"memory://{tag}/spill"

        def globbed():
            r = bs.ParquetReader(S, os.path.join(tmp, "part-*.parquet"),
                                 out=[np.int32, np.int32])
            return r, bs.Reshuffle(r)

        rb = run(globbed, auto_dense=False,
                 env={"BIGSLICE_SHUFFLE": "spill",
                      "BIGSLICE_SPILL_DIR": spill})
        _same_rows(rb["shards"], mesh_shards, "27b against 27a")
        spilled = fsspec.filesystem("memory").find(f"/{tag}/spill")
        if not spilled:
            raise AssertionError("27b: nothing spilled under the memory:// "
                                 "base")
        report(f"b parquet-glob-spill ({files} files, {len(spilled)} spill "
               f"files under memory://)", rb)
        out["parquet-glob-spill"] = dict(keep(rb), spill_files=len(spilled))

        # -- (c) 27a's Reduce under Cache on a memory:// prefix.
        cprefix = f"memory://{tag}/cache/sums"

        def cached():
            return bs.Cache(bs.Reduce(single()[1], add), cprefix)

        def crun():
            gc.collect()
            torch.cuda.synchronize()
            ck.reset_launches()
            sess = bs.Session(executor=bs.MeshExecutor(auto_dense=False))
            s = cached()
            t0 = time.perf_counter()
            shards = bs.result_shard_rows(sess.run(s))
            wall = time.perf_counter() - t0
            _same_rows(shards, mesh_shards, "27c against 27a")
            return s, wall, dict(ck.LAUNCHES)

        _, cw, cwl = crun()
        if cwl["hash_partition"] <= 0:
            raise AssertionError(f"27c: the cache write launched {cwl}")
        s, cr, crl = crun()
        if s.deps() != () or any(crl.values()):
            raise AssertionError(f"27c: the cached re-run launched {crl} "
                                 f"(deps {s.deps()})")
        rwalls = [crun()[1] for _ in range(PARQUET_WARM_RUNS)]
        log(f"phase 27c: Cache on memory://: write {cw:.4f} s, launches "
            f"{cwl}; cached re-run {cr:.4f} s, launches {crl}; warm cached "
            f"reads {', '.join(f'{w:.4f}' for w in rwalls)} s; rows equal "
            f"to 27a's; on {card}")
        out["parquet-cache-write"] = dict(launches=cwl, wall_s=cw, rows=n)
        out["parquet-cache-read"] = dict(launches=crl, wall_s=cr,
                                         walls_s=rwalls, rows=n)
    finally:
        mem = fsspec.filesystem("memory")
        if mem.exists(f"/{tag}"):
            mem.rm(f"/{tag}", recursive=True)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase27_kmeans(card: str) -> dict:
    """27e: ``models.kmeans.kmeans`` through ``Session()``, each
    iteration held to float64 on the card (``_kmeans_check``)."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.models import kmeans as km
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    S = 4
    pts = _kmeans_points()
    k = KMEANS_K >> SHIFT
    sess = bs.Session(executor=bs.MeshExecutor())
    iters = []

    def on_iter(i, before, after):
        torch.cuda.synchronize()
        iters.append((time.perf_counter(), before, after))

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    t0 = time.perf_counter()
    cents = km.kmeans(sess, pts, k=k, iters=KMEANS_ITERS, num_shards=S,
                      seed=27, on_iter=on_iter)
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not np.all(np.isfinite(cents)) or cents.shape != (k, KMEANS_D):
        raise AssertionError(f"kmeans: centroids {cents.shape}, finite "
                             f"{np.isfinite(cents).all()}")
    if launches["hash_partition"] <= 0:
        raise AssertionError(f"kmeans: launches {launches}")
    per_iter = [b[0] - a[0] for a, b in zip([(t0,)] + iters, iters)]
    csess = bs.Session(executor=bs.MeshExecutor())
    base = csess.run(bs.Const(S, pts))
    dev = torch.from_numpy(pts).cuda()
    flips, errs = [], []
    for i, (_, before, after) in enumerate(iters):
        f, e = _kmeans_check(csess, base, dev, before, after, i)
        flips.append(f)
        errs.append(e)
    log(f"phase 27e: kmeans n={len(pts)} d={KMEANS_D} k={k}, "
        f"{KMEANS_ITERS} iterations on {S} shards in {wall:.4f} s "
        f"({wall / KMEANS_ITERS:.4f} s an iteration; each "
        f"{', '.join(f'{s:.4f}' for s in per_iter)}), peak device memory "
        f"{peak:.3f} GiB, launches {launches}; against float64 on the "
        f"card: flips {flips} (each within float32 rounding), largest "
        f"centroid error {max(errs):.3e} (rtol {KMEANS_RTOL}, atol "
        f"{KMEANS_ATOL}); on {card}")
    return dict(launches=launches, wall_s=wall,
                s_per_iter=wall / KMEANS_ITERS, iter_s=per_iter,
                peak_gib=peak, flips=flips, centroid_err=errs, rows=len(pts))


#: Phase 28's plans: the JAX package's (tests/test_chaos.py:373 and the
#: local plan of its test_local_chaos_plan_recovers_bit_identical).
MESH_CHAOS_SPEC = ("5:mesh.dispatch=1.0x1~infra,staging.assemble=1.0x2,"
                   "shuffle.upload=1.0x2,store.read=0.25x4,"
                   "eval.resubmit=0.15x2")
LOCAL_CHAOS_SPEC = ("7:store.read=0.15x5,codec.read=0.2x3~flip,"
                    "io.read=0.3x4,store.put=0.3x3,eval.resubmit=0.1x2")
#: 28c's plan over the spill exchange: write transients, a spilled
#: partition lost, a spilled frame's bits flipped.
SPILL_CHAOS_SPEC = "9:spill.write=1.0x2,spill.read=1.0x1,codec.read=1.0x1~flip"


def _sorted_log(plan) -> list:
    return sorted((e["site"], e["kind"], e["inv_id"])
                  for e in plan.snapshot()["log"])


def _discard_run(ex, res) -> None:
    """Discard every task of a run: its outputs leave the device."""
    from bigslice_tpu_torch.exec.task import iter_tasks

    for t in iter_tasks(res.tasks):
        ex.discard(t)


def _read_shards(res):
    import bigslice_tpu_torch as bs

    for shard in range(res.num_shards):
        list(res.reader(shard, ()))
    return bs.result_shard_rows(res)


def _baseline(ex) -> tuple:
    """The card's allocated bytes and the arena's buffers handed out and
    not returned, after the device has drained."""
    torch.cuda.synchronize()
    gc.collect()
    return (torch.cuda.memory_allocated(),
            ex.staging_arena.stats()["outstanding"])


def _under_plan(spec, fn):
    """``fn()`` with the fault plan ``spec`` installed; the plan is
    cleared whatever happens. Returns (fn's value, the plan)."""
    from bigslice_tpu_torch.utils import faultinject

    plan = faultinject.install(faultinject.parse_plan(spec))
    try:
        return fn(), plan
    finally:
        faultinject.clear()


def _launch_delta(fn):
    """``fn()``'s value, its wall and the launches it made, by kernel."""
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(ck.LAUNCHES)


def phase28a_mesh_chaos(card: str) -> dict:
    """28a: phase 3's Reduce (2**25 rows over 2**20 keys, S = 4,
    ``auto_dense=False``) under the JAX package's mesh chaos plan, at
    prefetch depth 0 and 2 with the staging arena on and off: shards
    bit-equal to the fault-free run and to numpy, ``mesh.dispatch``
    fired once, the op on probation with its resubmissions on the inner
    LocalExecutor (counted), no fatal recovery, the same sorted
    injection log on a second run of the seed, and the card's memory
    and the arena's outstanding buffers back at their baselines."""
    import bigslice_tpu_torch as bs

    S = 4
    keys, ones = _reduce_wave_input()
    check = _count_check(keys)
    make = lambda: bs.Reduce(bs.Const(S, keys, ones),  # noqa: E731
                             lambda a, b: a + b)
    out = {"configs": {}}
    first = None
    for i, (depth, arena) in enumerate(((0, True), (0, False), (2, True),
                                        (2, False))):
        label = f"depth {depth}, arena {'on' if arena else 'off'}"

        def run(label=label, depth=depth, arena=arena):
            ex = bs.MeshExecutor(auto_dense=False, prefetch_depth=depth,
                                 staging_arena=arena)
            sess = bs.Session(executor=ex)
            res = sess.run(make())
            return ex, sess, res, _read_shards(res)

        (ex0, _, res0, base), base_wall, base_l = _launch_delta(run)
        check(base, S)
        _discard_run(ex0, res0)
        del res0
        mem0, _ = _baseline(ex0)
        ((ex, sess, res, got), plan), wall, launches = _launch_delta(
            lambda: _under_plan(MESH_CHAOS_SPEC, run))
        _same_rows(got, base, f"28a {label}: against the fault-free run")
        check(got, S)
        snap = plan.snapshot()
        if snap["injected"].get("mesh.dispatch") != 1:
            raise AssertionError(f"28a {label}: injected {snap['injected']}")
        rec = sess.telemetry_summary()["recovery"]
        if rec["fatal_total"] != 0:
            raise AssertionError(f"28a {label}: recovery {rec}")
        prob = ex.probation
        host_runs = sum(p["host_runs"] for p in prob.values())
        if len(prob) != 1 or host_runs < S:
            raise AssertionError(f"28a {label}: probation {prob}")
        log1 = _sorted_log(plan)
        _discard_run(ex, res)
        del res
        mem1, outstanding = _baseline(ex)
        if outstanding:
            raise AssertionError(f"28a {label}: {outstanding} arena buffers "
                                 f"not returned")
        replay = None
        if i == 0:
            # The first faulted run builds what the host tier builds once
            # a process: the replay's baseline is after it.
            ((ex2, _, res2, got2), plan2), _, _ = _launch_delta(
                lambda: _under_plan(MESH_CHAOS_SPEC, run))
            _same_rows(got2, got, "28a replay")
            replay = _sorted_log(plan2) == log1
            if not replay:
                raise AssertionError("28a: the seed's second run injected "
                                     "another sorted log")
            _discard_run(ex2, res2)
            del res2
            mem2, outstanding = _baseline(ex2)
            if mem2 != mem1 or outstanding:
                raise AssertionError(f"28a replay: memory {mem1} -> {mem2}, "
                                     f"outstanding {outstanding}")
        elif mem1 != mem0:
            raise AssertionError(f"28a {label}: memory {mem0} -> {mem1}")
        log(f"phase 28a: mesh chaos {label}: fault-free wall {base_wall:.4f} "
            f"s, launches {base_l}; faulted wall {wall:.4f} s, launches "
            f"{launches}; injected {snap['injected']}; recovered "
            f"{rec['recovered_total']} by site "
            f"{ {k: v['recovered'] for k, v in rec['by_site'].items()} }; "
            f"probation {prob}; memory {mem0} -> {mem1} B; replay "
            f"{'same sorted log' if replay else '-'}; hash_off "
            f"{sorted(ex.hash_off)}; on {card}")
        out["configs"][label] = dict(
            base_wall_s=base_wall, wall_s=wall, base_launches=base_l,
            launches=launches, injected=snap["injected"],
            recovered=rec["recovered_total"], host_runs=host_runs,
            hash_off=sorted(ex.hash_off))
        if first is None:
            first = launches
        del sess, ex, ex0
    out["launches"] = first
    return out


def phase28b_local_chaos(card: str) -> dict:
    """28b: phase 16's rows on ``LocalExecutor(procs=4)`` with a
    ``FileStore`` on local disk under the JAX package's local plan, over
    8 shards and 4 task threads as that package's test runs it: shards
    bit-equal to the fault-free run, files quarantined, ``store.read``
    among the recovered sites.

    Over phase 16's 4 shards the run makes fewer than 26 ``store.read``
    calls, so the seed's five losses (calls 26-36) all fall on the
    read-back, whose evaluations no monitor hears, and can all land on
    one task's retries: the evaluator's cap of five consecutive losses
    then fails it, the designed verdict for such a plan (on the chip,
    one run in one). 28b checks recovery, not the cap: it also raises
    ``MAX_CONSECUTIVE_LOST`` to 25 for its run, as the JAX package's
    ``test_reduce_survives_random_output_loss`` does (28a keeps the
    cap)."""
    import shutil
    import tempfile

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec import evaluate as evaluate_mod
    from bigslice_tpu_torch.exec import store as store_mod
    from bigslice_tpu_torch.models.wordcount import wordcount_ids

    S = 8
    keys, _ = _reduce_wave_input()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-chaos-")
    cap = evaluate_mod.MAX_CONSECUTIVE_LOST
    evaluate_mod.MAX_CONSECUTIVE_LOST = 25
    try:
        def run(sub):
            sess = bs.Session(executor=bs.LocalExecutor(
                procs=4, store=store_mod.FileStore(os.path.join(tmp, sub))))
            rows = _read_shards(sess.run(wordcount_ids(S, keys, 1 << 20)))
            # The summary's chaos section is the installed plan's.
            return sess, rows, sess.telemetry_summary()

        (_, base, _), base_wall, base_l = _launch_delta(lambda: run("base"))
        _count_check(keys)(base, S)
        ((sess, got, summary), plan), wall, launches = _launch_delta(
            lambda: _under_plan(LOCAL_CHAOS_SPEC, lambda: run("chaos")))
        _same_rows(got, base, "28b against the fault-free run")
        rec = summary["recovery"]
        quarantined = sess.executor.store.quarantined
        if not (quarantined > 0 and "store.read" in rec["by_site"]
                and rec["fatal_total"] == 0):
            raise AssertionError(f"28b: quarantined {quarantined}, recovery "
                                 f"{rec}")
        if summary["chaos"]["injected"] != plan.snapshot()["injected"]:
            raise AssertionError("28b: the summary's chaos section differs")
    finally:
        evaluate_mod.MAX_CONSECUTIVE_LOST = cap
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 28b: local chaos {len(keys)} rows, S={S}: fault-free wall "
        f"{base_wall:.4f} s, launches {base_l}; faulted wall {wall:.4f} s, "
        f"launches {launches}; injected {plan.snapshot()['injected']}; "
        f"quarantined {quarantined}; recovered by site "
        f"{ {k: v['recovered'] for k, v in rec['by_site'].items()} }; on "
        f"{card}")
    return dict(launches=launches, wall_s=wall, base_wall_s=base_wall,
                base_launches=base_l, quarantined=quarantined,
                injected=plan.snapshot()["injected"])


def phase28c_spill_chaos(card: str) -> dict:
    """28c: phase 13's spill path (reduce-wave, ``BIGSLICE_SHUFFLE=
    spill``) under spill.write transients, a spill.read loss and a
    codec.read flip on the spill files: bit-equal to the fault-free
    spilled run."""
    import bigslice_tpu_torch as bs

    S = 4
    keys, ones = _reduce_wave_input()
    os.environ["BIGSLICE_SHUFFLE"] = "spill"
    try:
        def run():
            ex = bs.MeshExecutor(auto_dense=False)
            sess = bs.Session(executor=ex)
            rows = _read_shards(sess.run(bs.Reduce(
                bs.Const(S, keys, ones), lambda a, b: a + b)))
            return ex, sess, rows

        (ex0, s0, base), base_wall, base_l = _launch_delta(run)
        s0.shutdown()
        _count_check(keys)(base, S)
        ((ex, sess, got), plan), wall, launches = _launch_delta(
            lambda: _under_plan(SPILL_CHAOS_SPEC, run))
        _same_rows(got, base, "28c against the fault-free spilled run")
        rec = sess.telemetry_summary()["recovery"]
        quarantined = ex._spill.quarantined
        sess.shutdown()
    finally:
        os.environ.pop("BIGSLICE_SHUFFLE", None)
    snap = plan.snapshot()
    if (snap["injected"] != {"spill.write": 2, "spill.read": 1,
                             "codec.read": 1} or rec["fatal_total"]
            or "spill.read" not in rec["by_site"]):
        raise AssertionError(f"28c: injected {snap['injected']}, recovery "
                             f"{rec}")
    log(f"phase 28c: spill chaos {len(keys)} rows: fault-free wall "
        f"{base_wall:.4f} s, launches {base_l}; faulted wall {wall:.4f} s, "
        f"launches {launches}; injected {snap['injected']}; quarantined "
        f"{quarantined}; recovered by site "
        f"{ {k: v['recovered'] for k, v in rec['by_site'].items()} }; on "
        f"{card}")
    return dict(launches=launches, wall_s=wall, base_wall_s=base_wall,
                base_launches=base_l, quarantined=quarantined)


def _quiesce_local(executors) -> None:
    """Wait until every worker thread of these local executors has
    exited. A worker holds its executor, and so its store's frames on
    the card, for ``WORKER_IDLE_SECS`` after its last task, and a
    coverage member that coverage made redundant runs on to its next
    cancellation check after the run has returned: a later phase's
    memory baseline must see neither."""
    deadline = time.monotonic() + 30.0 + max(
        (ex.WORKER_IDLE_SECS for ex in executors), default=0.0)
    while any(ex._workers > 0 for ex in executors):
        if time.monotonic() > deadline:
            raise AssertionError("local executor workers still alive: "
                                 f"{[ex._workers for ex in executors]}")
        time.sleep(0.05)


def phase28d_coded(card: str) -> dict:
    """28d: ``BIGSLICE_CODED=combine`` on phase 16's Reduce: bit-equal to
    ``off``; exactly r ``coded.cover`` losses complete with no
    recompute; r + 1 (the two owners of unit 0, one worker so the order
    is the members') recompute, loudly; a stuck member is cancelled once
    coverage settles. The phase returns once its executors' workers
    have exited (``_quiesce_local``)."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.task import TaskState, iter_tasks
    from bigslice_tpu_torch.models.wordcount import wordcount_ids

    S = 4
    keys, _ = _reduce_wave_input()
    executors = []

    def run(procs=None):
        sess = bs.Session(executor=bs.LocalExecutor(procs=procs))
        executors.append(sess.executor)
        res = sess.run(wordcount_ids(S, keys, 1 << 20))
        return sess, res, _read_shards(res)

    (_, _, off), off_wall, off_l = _launch_delta(run)
    _count_check(keys)(off, S)
    os.environ["BIGSLICE_CODED"] = "combine"
    try:
        (sess, res, got), wall, launches = _launch_delta(run)
        _same_rows(got, off, "28d coded against off")
        st = sess.telemetry.coded
        k, r = S, -(-S // 8)
        if st.count("covered") != 1 or st.count("group") != 1:
            raise AssertionError(f"28d: {st.summary()['counts']}")
        counts = {"engaged": dict(st.summary()["counts"])}
        walls = {"off": off_wall, "engaged": wall}
        for label, spec, procs in (
                ("r losses", f"5:coded.cover=1.0x{r}~lose", None),
                ("r + 1 losses", f"5:coded.cover=1.0x{r + 1}~lose", 1),
                ("stuck", "5:coded.cover=1.0x1~stuck", None)):
            ((sess, res, got), plan), w, _ = _launch_delta(
                lambda: _under_plan(spec, lambda: run(procs)))
            _same_rows(got, off, f"28d {label}")
            st = sess.telemetry.coded
            c = dict(st.summary()["counts"])
            members = [t for t in iter_tasks(res.tasks)
                       if getattr(t, "coded_group", None) is not None]
            if label == "r losses" and (c.get("recovered", 0)
                                        or c.get("covered") != 1):
                raise AssertionError(f"28d {label}: {c}")
            if label == "r + 1 losses" and not c.get("recovered", 0):
                raise AssertionError(f"28d {label}: no recompute, {c}")
            if label == "stuck" and not (
                    c.get("cancelled", 0) >= 1 and any(
                        t.state == TaskState.CANCELLED for t in members)):
                raise AssertionError(f"28d {label}: {c}")
            counts[label] = c
            walls[label] = w
    finally:
        os.environ.pop("BIGSLICE_CODED", None)
    del sess, res, got
    _quiesce_local(executors)
    log(f"phase 28d: coded k={k} r={r} over {len(keys)} rows: walls "
        f"{ {k: round(v, 4) for k, v in walls.items()} } s; counts "
        f"{counts}; launches off {off_l}, engaged {launches}; on {card}")
    return dict(launches=launches, walls_s=walls, counts=counts,
                off_launches=off_l)


def phase28e_deadline(card: str) -> dict:
    """28e: ``run(deadline_s=0.5)`` under ``task.run=1.0x1~stuck`` on the
    device executor at prefetch depth 2 (its host tier one task thread):
    DeadlineExceeded within 0.5 s + DEADLINE_DRAIN_SECS, every task
    pending, the card's memory and the arena at their baselines, and a
    fresh run with no plan on the same session equal to numpy."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.evaluate import (DEADLINE_DRAIN_SECS,
                                                  DeadlineExceeded)

    S = 4
    keys, ones = _reduce_wave_input()
    ex = bs.MeshExecutor(prefetch_depth=2, fallback_procs=1,
                         auto_dense=False)
    sess = bs.Session(executor=ex)

    def graph():
        # A host-tier batch stage (the stuck task's), then the device
        # reduce side at depth 2.
        s = bs.MapBatches(bs.Const(S, keys, ones), lambda f: f,
                          out=[np.int32, np.int32])
        return bs.Reduce(s, lambda a, b: a + b)

    mem0, out0 = _baseline(ex)

    def expire():
        t0 = time.perf_counter()
        try:
            sess.run(graph(), deadline_s=0.5)
        except DeadlineExceeded as e:
            return e, time.perf_counter() - t0
        raise AssertionError("28e: the run met its deadline")

    (err, raised_s), plan = _under_plan("5:task.run=1.0x1~stuck", expire)
    mem1, out1 = _baseline(ex)
    if not (0.5 <= raised_s < 0.5 + DEADLINE_DRAIN_SECS
            and err.pending == 2 * S and mem1 == mem0 and out1 == out0
            and plan.snapshot()["injected"] == {"task.run": 1}):
        raise AssertionError(f"28e: raised after {raised_s:.3f} s, pending "
                             f"{err.pending}, memory {mem0} -> {mem1}, "
                             f"arena outstanding {out0} -> {out1}")
    res, wall, launches = _launch_delta(lambda: sess.run(graph()))
    rows = _read_shards(res)
    _count_check(keys)(rows, S)
    dl = sess.telemetry_summary()["deadline"]
    log(f"phase 28e: deadline 0.5 s: DeadlineExceeded after "
        f"{raised_s:.4f} s, pending {err.pending}, memory {mem0} -> {mem1} "
        f"B, arena outstanding {out0} -> {out1}; fresh run {wall:.4f} s, "
        f"launches {launches}, equal to numpy; deadline plane {dl}; on "
        f"{card}")
    return dict(launches=launches, raised_s=raised_s, pending=err.pending,
                fresh_wall_s=wall, memory=[mem0, mem1])


def _skew_keys() -> np.ndarray:
    """Phase 3's keys with key 0 repeated 2**24 times more."""
    keys, _ = _reduce_wave_input()
    return np.concatenate([keys, np.zeros(1 << 24, np.int32)])


def phase28f_adaptive(card: str) -> dict:
    """28f: each adaptive policy against ``off``, bit-equal: skew (28f's
    hot key through a Reshuffle and a Map into the Reduce, S = 8: the
    consumer waves run as K row slices), cost (no
    ``device_budget_bytes``: phase 3's reduce-wave shaped from
    ``hbm_budget()`` × ``BIGSLICE_ADAPTIVE_HEADROOM=0.01``) and spec (a
    ``task.run`` slow fault on the local tier, raced by a duplicate)."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.models.wordcount import wordcount_ids

    out = {}
    skeys = _skew_keys()
    sones = np.ones(len(skeys), np.int32)

    def skew_run():
        ex = bs.MeshExecutor(auto_dense=False)
        sess = bs.Session(executor=ex)
        res = sess.run(bs.Reduce(bs.Map(
            bs.Reshuffle(bs.Const(8, skeys, sones)), lambda k, v: (k, v + 0)),
            lambda a, b: a + b))
        return ex, sess, _read_shards(res)

    def with_env(env, fn):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            return fn()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    (_, _, off), off_wall, off_l = _launch_delta(skew_run)
    _count_check(skeys)(off, 8)
    (ex, sess, got), wall, launches = _launch_delta(
        lambda: with_env({"BIGSLICE_ADAPTIVE": "skew"}, skew_run))
    _same_rows(got, off, "28f skew against off")
    st = sess.adaptive.stats
    splits = [d for d in st.summary()["decisions"] if d["action"] == "split"]
    if not splits or not any(k >= 2 for k in ex.split_runs.values()):
        raise AssertionError(f"28f skew: no split ({st.summary()['counts']})")
    log(f"phase 28f: skew {len(skeys)} rows, S=8: off {off_wall:.4f} s "
        f"(launches {off_l}), skew {wall:.4f} s (launches {launches}); K "
        f"{splits[0]['k']}, ratio {splits[0]['ratio']}, skew_splits "
        f"{st.skew_splits}, split_runs {ex.split_runs}; on {card}")
    out["adaptive-skew"] = dict(launches=launches, wall_s=wall,
                                off_wall_s=off_wall, off_launches=off_l,
                                K=splits[0]["k"], skew_splits=st.skew_splits)

    keys, ones = _reduce_wave_input()

    def cost_run():
        ex = bs.MeshExecutor(auto_dense=False, prefetch_depth=2)
        sess = bs.Session(executor=ex)
        return ex, sess, _read_shards(sess.run(bs.Reduce(
            bs.Const(4, keys, ones), lambda a, b: a + b)))

    (_, _, off), off_wall, _ = _launch_delta(cost_run)
    (ex, sess, got), wall, launches = _launch_delta(
        lambda: with_env({"BIGSLICE_ADAPTIVE": "cost",
                          "BIGSLICE_ADAPTIVE_HEADROOM": "0.01"}, cost_run))
    _same_rows(got, off, "28f cost against off")
    doc = sess.adaptive.stats.summary()
    budget = [d for d in doc["decisions"] if d["action"] == "wave_budget"]
    K = sorted(set(ex.split_runs.values()))
    if not budget or not K or K[0] < 2:
        raise AssertionError(f"28f cost: {doc['counts']}, split {K}")
    log(f"phase 28f: cost reduce-wave: off {off_wall:.4f} s, cost "
        f"{wall:.4f} s (launches {launches}); budget "
        f"{budget[0]['budget_bytes']} B of {budget[0]['hbm_limit_bytes']} "
        f"B (headroom {budget[0]['headroom']}), sub-waves K {K}, counts "
        f"{doc['counts']}; on {card}")
    out["adaptive-cost"] = dict(launches=launches, wall_s=wall,
                                off_wall_s=off_wall,
                                budget_bytes=budget[0]["budget_bytes"],
                                K=K[0], counts=doc["counts"])

    def spec_run():
        sess = bs.Session(executor=bs.LocalExecutor())
        sess.telemetry.straggler_factor = 2.0
        res = sess.run(wordcount_ids(4, keys, 1 << 20))
        return sess, _read_shards(res)

    (_, off), off_wall, _ = _launch_delta(spec_run)
    ((sess, got), plan), wall, launches = _launch_delta(
        lambda: with_env({"BIGSLICE_ADAPTIVE": "spec",
                          "BIGSLICE_CHAOS_SLOW_S": "2.0"},
                         lambda: _under_plan("3:task.run=1.0x1~slow",
                                             spec_run)))
    _same_rows(got, off, "28f spec against off")
    st = sess.adaptive.stats
    deadline = time.monotonic() + 30.0
    while (st.speculative_won + st.speculative_wasted
           < st.speculative_launched and time.monotonic() < deadline):
        time.sleep(0.01)
    if not (st.speculative_launched >= 1 and st.speculative_won
            + st.speculative_wasted == st.speculative_launched):
        raise AssertionError(f"28f spec: {st.summary()['speculative']}")
    # The slowed original finishes its (wasted) body on its own thread:
    # wait for its permit, so that 28g's pairs time an idle card.
    lim = sess.executor._limiter
    while lim._avail < lim.capacity and time.monotonic() < deadline:
        time.sleep(0.01)
    torch.cuda.synchronize()
    log(f"phase 28f: spec local-reduce: off {off_wall:.4f} s, slowed and "
        f"raced {wall:.4f} s (launches {launches}); speculative "
        f"{st.summary()['speculative']}; on {card}")
    out["adaptive-spec"] = dict(launches=launches, wall_s=wall,
                                off_wall_s=off_wall,
                                speculative=st.summary()["speculative"])
    return out


def phase28g_seam_cost(card: str) -> dict:
    """28g: phase 3's reduce-wave in ten alternating pairs, no plan
    against a plan of rate 0 on every site (each seam reached, none
    fires): both medians and the host syncs a run (asserted equal); with
    no plan ``faultinject.fire`` is never reached and the summary holds
    no chaos, coded or adaptive section."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.utils import faultinject

    keys, ones = _reduce_wave_input()

    def once():
        ex = bs.MeshExecutor(auto_dense=False)
        sess = bs.Session(executor=ex)
        t0 = time.perf_counter()
        _read_shards(sess.run(bs.Reduce(bs.Const(4, keys, ones),
                                        lambda a, b: a + b)))
        return time.perf_counter() - t0, sess

    def run(armed: bool):
        if armed:
            return _under_plan("1:*=0.0", once)[0][0]
        return once()[0]

    calls0 = faultinject.CALLS
    (_, sess), wall, launches = _launch_delta(once)
    if faultinject.CALLS != calls0:
        raise AssertionError("28g: a seam reached faultinject with no plan")
    doc = sess.telemetry_summary()
    text = sess.telemetry.prometheus_text()
    if {"chaos", "coded", "adaptive", "deadline"} & set(doc) or any(
            f in text for f in ("bigslice_fault_injected",
                                "bigslice_coded", "bigslice_adaptive",
                                "bigslice_deadline")):
        raise AssertionError("28g: a robustness sample with no knob set")
    run(False)
    run(True)
    plain, armed = [], []
    for i in range(10):
        for flag in ((False, True) if i % 2 == 0 else (True, False)):
            (armed if flag else plain).append(run(flag))
        gc.collect()
    _count_syncs(lambda: run(False))
    _count_syncs(lambda: run(True))
    syncs_plain = [_count_syncs(lambda: run(False)) for _ in range(2)]
    syncs_armed = [_count_syncs(lambda: run(True)) for _ in range(2)]
    reached = faultinject.CALLS - calls0
    med_p, med_a = statistics.median(plain), statistics.median(armed)
    log(f"phase 28g: seam cost, ten alternating pairs: no plan {med_p:.4f} "
        f"s, rate-0 plan on every site {med_a:.4f} s (median), ratio "
        f"{med_a / med_p:.4f}; no plan {', '.join(f'{w:.4f}' for w in plain)}"
        f"; armed {', '.join(f'{w:.4f}' for w in armed)}; host syncs a run "
        f"{syncs_plain} against {syncs_armed}; seams reached {reached} over "
        f"the armed runs; launches {launches}; on {card}")
    if syncs_plain != syncs_armed:
        raise AssertionError(f"28g: armed seams changed the host syncs "
                             f"({syncs_plain} -> {syncs_armed})")
    return dict(launches=launches, wall_s=wall, plain_median_s=med_p,
                armed_median_s=med_a, plain_s=plain, armed_s=armed,
                syncs_plain=syncs_plain, syncs_armed=syncs_armed)


def phase28h_chaosslice(card: str) -> dict:
    """28h: ``python -m bigslice_tpu_torch.tools.chaosslice`` as two
    subprocesses on the card at once, with the JAX package's CLI plans
    (its ``test_chaosslice_cli_local`` and ``_spill``): the local one on
    a FileStore, the spill one on the device executor; each exits 0
    with a bit-identical JSON summary."""
    import tempfile

    d = tempfile.mkdtemp(prefix="chip-smoke-cli-")
    runs = {
        "local": ["-chaos", "7:store.read=0.2x3,io.read=0.5x2,"
                  "codec.read=0.3x1~flip", "-rows", str(1 << 20),
                  "-shards", "4"],
        "spill": ["-chaos", "7:spill.read=0.5x2,spill.write=0.5x2",
                  "-rows", str(1 << 20), "-shards", "16", "-mesh",
                  "-shuffle", "spill"],
    }
    t0 = time.perf_counter()
    procs = {label: subprocess.Popen(
        [sys.executable, "-m", "bigslice_tpu_torch.tools.chaosslice",
         *args, "-json", os.path.join(d, f"{label}.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for label, args in runs.items()}
    out = {}
    for label, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=300)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        wall = time.perf_counter() - t0
        if p.returncode != 0:
            raise AssertionError(f"28h {label}: exit {p.returncode}\n"
                                 f"{stdout[-2000:]}\n{stderr[-2000:]}")
        with open(os.path.join(d, f"{label}.json")) as fh:
            doc = json.load(fh)
        if not (doc["ok"] and doc["bit_identical"]
                and doc["device"] == "cuda"):
            raise AssertionError(f"28h {label}: {doc}")
        log(f"phase 28h: chaosslice {label}: exit 0, done {wall:.2f} s "
            f"after both started, matrix "
            f"{[(r['site'], r['injected'], r['recovered']) for r in doc['matrix']]}"
            f", walls {doc['wall_s']}; on {card}")
        out[label] = dict(wall_s=wall, matrix=doc["matrix"],
                          walls=doc["wall_s"])
    return out


def phase28_robustness(card: str) -> dict:
    """Phase 28, the robustness plane: 28a-28h, each with its wall and
    its launches by kernel on its own lines."""
    t0 = time.perf_counter()
    paths = {}
    for name, fn in (("chaos-mesh", phase28a_mesh_chaos),
                     ("chaos-local", phase28b_local_chaos),
                     ("chaos-spill", phase28c_spill_chaos),
                     ("coded", phase28d_coded),
                     ("deadline", phase28e_deadline)):
        t = time.perf_counter()
        paths[name] = fn(card)
        log(f"phase 28: {name} took {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    paths.update(phase28f_adaptive(card))
    log(f"phase 28: adaptive took {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    paths["seam-cost"] = phase28g_seam_cost(card)
    log(f"phase 28: seam-cost took {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    cli = phase28h_chaosslice(card)
    log(f"phase 28: chaosslice took {time.perf_counter() - t:.2f} s")
    log(f"phase 28: robustness in {time.perf_counter() - t0:.2f} s")
    paths["chaos-mesh"]["cli"] = cli
    return paths


# -- phase 29: the operator plane (the debug server, kernel selection,
# slicetrace and obsdump)

#: One Prometheus text-format sample line (the JAX package's
#: tests/test_debughttp.py:19-24).
_PROM_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\")*\})?"
    r" [-+]?([0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?|Inf|NaN)$"
)
#: Phase 29a: every route of the debug server and the status it answers.
DEBUG_ROUTES = {
    "/debug": 200, "/debug/status": 200, "/debug/tasks": 200,
    "/debug/trace": 200, "/debug/resources": 200, "/debug/metrics": 200,
    "/debug/device": 200, "/debug/fleet": 200,
    "/debug/fleet?format=prom": 200,
}
#: Phase 29a: alternating pairs of the hub-on run with and without a
#: client polling the debug server.
POLL_PAIRS = 5


def _http_get(port: int, path: str, timeout: float = 60.0) -> tuple:
    """(status, body) of one GET on 127.0.0.1:port."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _kernel_events(trace_path: str) -> dict:
    """K1's and K2's kernel events in a torch.profiler Chrome trace."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    n = {"hash_partition": 0, "hash_aggregate": 0}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        nm = str(e.get("name", ""))
        if "hash_partition_kernel" in nm:
            n["hash_partition"] += 1
        elif "agg_" in nm and "_kernel" in nm:
            n["hash_aggregate"] += 1
    return n


def _wait_recording(what: str) -> None:
    from bigslice_tpu_torch.utils import xprof

    deadline = time.monotonic() + 60
    while not xprof.recording():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: the profile window never started")
        time.sleep(0.005)


def _p29_reduce(bs, keys, ones, S=4):
    # One source line: every phase-29 Reduce is the same op site, so the
    # kernel selector's decisions and re-selection see one op.
    return bs.Reduce(bs.Const(S, keys, ones), lambda a, b: a + b)


def _p29_run(sess, keys, ones, S=4):
    """One run of the phase's Reduce, every shard read back, synchronised."""
    import bigslice_tpu_torch as bs

    res = sess.run(_p29_reduce(bs, keys, ones, S))
    for shard in range(S):
        list(res.reader(shard, ()))
    torch.cuda.synchronize()
    return res


def phase29a_debug_server(card: str, out_dir: str) -> dict:
    """29a: reduce-wave through ``Session(debug_port=0, trace_path=...)``,
    every route polled while the run is live and after it; the device
    route's launches against the hub's and ``LAUNCHES``; the metrics
    parsed; a profile window around a run, and a second one refused;
    the hub-on wall with and without a polling client; close() drains."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    S = 4
    keys, ones = _reduce_wave_input()
    check = _count_check(keys)
    trace_path = os.path.join(out_dir, "trace-29a.json")
    sess = bs.Session(executor=bs.MeshExecutor(auto_dense=False),
                      debug_port=0, trace_path=trace_path)
    port = sess.debug.port

    live = {}
    done = threading.Event()

    def poll():
        # At least one full pass, the first one while the run is live.
        while True:
            for path in DEBUG_ROUTES:
                live.setdefault(path, set()).add(_http_get(port, path)[0])
            if done.is_set():
                return

    torch.cuda.synchronize()
    ck.reset_launches()
    th = threading.Thread(target=poll)
    th.start()
    t0 = time.perf_counter()
    try:
        res = _p29_run(sess, keys, ones, S)
    finally:
        done.set()
        th.join()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    check(bs.result_shard_rows(res), S)
    after = {path: _http_get(port, path) for path in DEBUG_ROUTES}
    for path, want in DEBUG_ROUTES.items():
        if live[path] != {want} or after[path][0] != want:
            raise AssertionError(f"29a: {path} answered {live[path]} live, "
                                 f"{after[path][0]} after, not {want}")
    fleet = json.loads(after["/debug/fleet"][1])
    if (fleet.get("scope") != "fleet" or fleet.get("ranks") != [0]
            or "bigslice_fleet_ranks 1" not in
            after["/debug/fleet?format=prom"][1]):
        raise AssertionError(f"29a: /debug/fleet is not this process's "
                             f"fleet merge: {after['/debug/fleet'][1][:200]!r}")
    device = json.loads(after["/debug/device"][1])
    served = {name: 0 for name in PATH_KERNELS}
    for per_kernel in device["kernels"].values():
        for name, k in per_kernel.items():
            served[name] += k["launches"]
    hub = _hub_launches(sess.telemetry_summary())
    if not (served == hub == launches) or not (
            launches["hash_partition"] and launches["hash_aggregate"]):
        raise AssertionError(f"29a: /debug/device launches {served}, hub "
                             f"{hub}, LAUNCHES {launches}")
    if device["compile"] != {} or not device["hbm"].get("samples"):
        raise AssertionError(f"29a: /debug/device compile "
                             f"{device['compile']}, hbm {device['hbm']}")
    samples = 0
    for line in after["/debug/metrics"][1].splitlines():
        if not line or line.startswith("#"):
            continue
        if not _PROM_SAMPLE_RE.match(line):
            raise AssertionError(f"29a: unparseable metrics line {line!r}")
        samples += 1
    tasks = json.loads(after["/debug/tasks"][1])
    log(f"phase 29a: reduce-wave {len(keys)} rows with the debug server "
        f"live: wall {wall:.4f} s, every route answered while live and "
        f"after ({', '.join(f'{p} {c}' for p, c in DEBUG_ROUTES.items())}), "
        f"/debug/device launches {served} = hub's = LAUNCHES, {samples} "
        f"metrics samples parsed, {len(tasks['nodes'])} tasks and "
        f"{len(tasks['links'])} links, on {card}")

    # A profile window around a live run, and a second window refused.
    got = []
    wt = threading.Thread(target=lambda: got.append(
        _http_get(port, "/debug/profile?seconds=0.5", timeout=180)))
    wt.start()
    _wait_recording("29a")
    busy = _http_get(port, "/debug/profile?seconds=0.1")
    t0 = time.perf_counter()
    _p29_run(sess, keys, ones, S)
    run_s = time.perf_counter() - t0
    wt.join()
    if busy[0] != 409:
        raise AssertionError(f"29a: a second window got {busy[0]}, not 409")
    if got[0][0] != 200:
        raise AssertionError(f"29a: the profile window answered {got[0]}")
    window = json.loads(got[0][1])
    kev = _kernel_events(os.path.join(window["dir"], "trace.json"))
    if not (kev["hash_partition"] and kev["hash_aggregate"]):
        raise AssertionError(f"29a: the window holds no K1 or K2 kernel "
                             f"event ({kev}) around a run of {run_s:.4f} s")
    log(f"phase 29a: /debug/profile?seconds=0.5 around a run of "
        f"{run_s:.4f} s: kernel events {kev}; a second window: "
        f"{busy[0]}")

    # The hub-on wall with and without a client polling the server.
    def timed(polling: bool) -> float:
        stop = threading.Event()

        def client():
            while not stop.is_set():
                for path in ("/debug/metrics", "/debug/status",
                             "/debug/device"):
                    _http_get(port, path)

        cl = threading.Thread(target=client) if polling else None
        if cl is not None:
            cl.start()
        try:
            t = time.perf_counter()
            _p29_run(sess, keys, ones, S)
            return time.perf_counter() - t
        finally:
            stop.set()
            if cl is not None:
                cl.join()

    quiet_s, polled_s = [], []
    for i in range(POLL_PAIRS):
        for polling in ((False, True) if i % 2 == 0 else (True, False)):
            (polled_s if polling else quiet_s).append(timed(polling))
        gc.collect()
    med_q, med_p = statistics.median(quiet_s), statistics.median(polled_s)
    log(f"phase 29a: {POLL_PAIRS} alternating pairs, hub on, no client "
        f"{med_q:.4f} s, a client polling /debug/metrics, /debug/status "
        f"and /debug/device {med_p:.4f} s (median), ratio "
        f"{med_p / med_q:.4f}; quiet {', '.join(f'{w:.4f}' for w in quiet_s)}"
        f"; polled {', '.join(f'{w:.4f}' for w in polled_s)}, on {card}")

    # close() drains: a window in flight completes; then the socket is
    # gone.
    got = []
    wt = threading.Thread(target=lambda: got.append(
        _http_get(port, "/debug/profile?seconds=0.3", timeout=180)))
    wt.start()
    _wait_recording("29a close")
    t0 = time.perf_counter()
    sess.shutdown()  # closes the server (and writes the trace)
    drained_s = time.perf_counter() - t0
    wt.join()
    if got[0][0] != 200:
        raise AssertionError(f"29a: the request in flight at close got "
                             f"{got[0][0]}")
    try:
        _http_get(port, "/debug", timeout=5)
    except OSError:
        pass
    else:
        raise AssertionError("29a: the server answered after close()")
    log(f"phase 29a: close() drained a 0.3 s window in flight in "
        f"{drained_s:.4f} s (200), then refused connections")
    del res
    gc.collect()
    return dict(launches=launches, wall_s=wall, metrics_samples=samples,
                profile_kernel_events=kev, poll_quiet_s=quiet_s,
                poll_polled_s=polled_s, median_quiet_s=med_q,
                median_polled_s=med_p, drained_s=drained_s,
                trace=trace_path)


def _kselect_decisions(sess) -> list:
    return sess.kernel_select.stats.summary()["decisions"]


def phase29b_static(card: str, phase3_launches: dict) -> dict:
    """29b: ``BIGSLICE_KERNEL_SELECT=static`` over three corpora of 2**25
    rows: sparse int32 keys (hash, static:cuda-kernel, bit-equal to the
    unset run, whose launches are phase 3's), float32 keys with +-0.0
    (sort, hash-ineligible, no K2) and small contiguous keys (dense,
    dense-bound, at the executor's default auto-dense); then phase 21's
    misprobe of 2**24 rows, whose retracted op decides again (dense, then
    hash with static:cuda-kernel) with the unset run's rows and
    launches."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    S = 4
    keys, ones = _reduce_wave_input()
    bc = np.bincount(keys, minlength=1 << 20)
    present = np.nonzero(bc)[0]
    # Sparse: a bijection of the 2**20 keys onto [0, 2**30), out of any
    # dense bound's reach.
    sparse = ((keys.astype(np.int64) * 92821 + 17) % (1 << 30)).astype(
        np.int32)
    sp_keys = ((present.astype(np.int64) * 92821 + 17) % (1 << 30)).astype(
        np.int32)
    sp_order = np.argsort(sp_keys)
    # Float: 2**16 distinct float32 values (multiples of 1/64), the first
    # two 0.0 and -0.0, one drawn a row; the oracle folds -0.0 onto 0.0.
    pool = ((np.arange(1 << 16) - (1 << 15)) / 64.0).astype(np.float32)
    pool[1 << 15] = 1024.5  # the zero's own slot takes a fresh value
    pool[0], pool[1] = 0.0, -0.0
    idx = keys & 0xFFFF
    floats = pool[idx]
    if not (idx == 0).any() or not (idx == 1).any():
        raise AssertionError("29b: the float keys lack 0.0 or -0.0")
    f_keys, f_inv = np.unique(np.where(pool == 0, np.float32(0), pool),
                              return_inverse=True)
    f_counts = np.bincount(f_inv, weights=np.bincount(
        idx, minlength=1 << 16)).astype(np.int64)
    f_keys, f_counts = f_keys[f_counts > 0], f_counts[f_counts > 0]
    # Dense: keys over 2**16 contiguous values.
    dense = keys & 0xFFFF

    def flat(shards):
        return (np.concatenate([s[0] for s in shards]),
                np.concatenate([s[1] for s in shards]))

    def check_sparse(shards):
        k, v = flat(shards)
        o = np.argsort(k)
        if not (np.array_equal(k[o], sp_keys[sp_order])
                and np.array_equal(v[o], bc[present][sp_order])):
            raise AssertionError("29b: sparse counts differ from numpy")
        _shard_keys_routed(shards, S)

    def check_float(shards):
        k, v = flat(shards)
        if (k == 0).sum() != 1:
            raise AssertionError("29b: +-0.0 are not one key")
        k = np.where(k == 0, np.float32(0), k)
        o = np.argsort(k)
        if not (np.array_equal(k[o], f_keys)
                and np.array_equal(v[o], f_counts)):
            raise AssertionError("29b: float counts differ from numpy")
        _shard_keys_routed(shards, S)

    def check_dense(shards):
        k, v = flat(shards)
        dbc = np.bincount(dense, minlength=1 << 16)
        o = np.argsort(k)
        if not (np.array_equal(k[o], np.nonzero(dbc)[0])
                and np.array_equal(v[o], dbc[dbc > 0])):
            raise AssertionError("29b: dense counts differ from numpy")

    def counted(k, auto_dense=False):
        sess = bs.Session(executor=bs.MeshExecutor(auto_dense=auto_dense))
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.perf_counter()
        res = _p29_run(sess, k, ones, S)
        wall = time.perf_counter() - t0
        return sess, bs.result_shard_rows(res), wall, dict(ck.LAUNCHES)

    os.environ.pop("BIGSLICE_KERNEL_SELECT", None)
    base_sess, base_rows, base_wall, base_launches = counted(sparse)
    check_sparse(base_rows)
    if base_sess.kernel_select is not None:
        raise AssertionError("29b: a selector exists with the knob unset")
    for name in ("hash_partition", "hash_aggregate"):
        if base_launches[name] != phase3_launches[name]:
            raise AssertionError(f"29b: unset launches {base_launches} are "
                                 f"not phase 3's {phase3_launches}")
    del base_sess
    out = {}
    os.environ["BIGSLICE_KERNEL_SELECT"] = "static"
    try:
        for label, k, chk, auto, want in (
                ("sparse", sparse, check_sparse, False,
                 ("hash", "static:cuda-kernel")),
                ("float", floats, check_float, False,
                 ("sort", "hash-ineligible")),
                ("dense", dense, check_dense, True,
                 ("dense", "dense-bound"))):
            sess, rows, wall, launches = counted(k, auto_dense=auto)
            chk(rows)
            dec = {(d["kernel"], d["reason"])
                   for d in _kselect_decisions(sess)}
            if dec != {want}:
                raise AssertionError(f"29b {label}: decisions {dec}, not "
                                     f"{want}")
            if label == "sparse":
                _same_rows(rows, base_rows, "29b sparse against unset")
                if launches != base_launches:
                    raise AssertionError(f"29b sparse: launches {launches} "
                                         f"!= unset {base_launches}")
            if label == "float" and launches["hash_aggregate"]:
                raise AssertionError(f"29b float: K2 launched "
                                     f"{launches['hash_aggregate']} times")
            log(f"phase 29b: static, {label} keys, {len(k)} rows: "
                f"{sorted(dec)}, wall {wall:.4f} s, launches {launches}"
                f"{' = the unset run' if label == 'sparse' else ''}, on "
                f"{card}")
            out[f"kselect-static-{label}"] = dict(
                launches=launches, wall_s=wall, decisions=sorted(dec))
            del sess, rows
            gc.collect()
    finally:
        os.environ.pop("BIGSLICE_KERNEL_SELECT", None)
    log(f"phase 29b: unset, sparse keys: wall {base_wall:.4f} s, launches "
        f"{base_launches} (phase 3's K1 and K2)")

    # The misprobe: a retracted dense bound must not leave its op's
    # cached "dense" verdict standing.
    mk = _misprobe_keys(S)
    mones = np.ones(len(mk), np.int32)

    def misprobe(mode):
        if mode is None:
            os.environ.pop("BIGSLICE_KERNEL_SELECT", None)
        else:
            os.environ["BIGSLICE_KERNEL_SELECT"] = mode
        try:
            sess = bs.Session(executor=bs.MeshExecutor())
        finally:
            os.environ.pop("BIGSLICE_KERNEL_SELECT", None)
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.perf_counter()
        res = _p29_run(sess, mk, mones, S)
        wall = time.perf_counter() - t0
        return (sess, bs.result_shard_rows(res), wall, dict(ck.LAUNCHES),
                sorted(sess.executor.auto_dense_off))

    _, m_base, m_base_wall, m_base_launches, m_base_off = misprobe(None)
    _count_check(mk, span=1 << 21)(m_base, S)
    sess, m_rows, m_wall, m_launches, m_off = misprobe("static")
    _same_rows(m_rows, m_base, "29b misprobe against unset")
    by_op = {}
    for d in _kselect_decisions(sess):
        by_op.setdefault(d["op"].split("@")[0], []).append(
            (d["kernel"], d["reason"]))
    if (m_launches != m_base_launches or m_off != m_base_off
            or not m_base_off
            or by_op.get("reduce") != [("dense", "dense-bound"),
                                       ("hash", "static:cuda-kernel")]):
        raise AssertionError(f"29b misprobe: launches {m_launches} against "
                             f"unset {m_base_launches}, retracted {m_off} "
                             f"against {m_base_off}, decisions {by_op}")
    log(f"phase 29b: static, phase 21's misprobe, {len(mk)} rows: "
        f"decisions {by_op}, retracted {[o.split('@')[0] for o in m_off]}, "
        f"wall {m_wall:.4f} s (unset {m_base_wall:.4f} s), launches "
        f"{m_launches} = the unset run's, on {card}")
    out["kselect-static-misprobe"] = dict(
        launches=m_launches, wall_s=m_wall, decisions=by_op)
    out["kselect-unset-misprobe"] = dict(launches=m_base_launches,
                                         wall_s=m_base_wall)
    del sess, m_rows, m_base
    gc.collect()
    out["kselect-unset-sparse"] = dict(launches=base_launches,
                                       wall_s=base_wall)
    return out


def phase29c_measured(card: str, out_dir: str) -> dict:
    """29c: ``BIGSLICE_KERNEL_SELECT=measured`` at the reduce-wave shape:
    the probe's medians and samples, the verdict, the probe's launches
    (kind kselect) apart from the op's wave launches, rows bit-equal to
    the unset run's; then the same op over a hot key, whose max partition
    moves by RESELECT_RATIO: one re-selection, and the op decides
    again; then the race at eight other op shapes."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.parallel import cuda_kernels as ck
    from bigslice_tpu_torch.parallel import kernelselect as ks

    S = 4
    keys, ones = _reduce_wave_input()
    os.environ.pop("BIGSLICE_KERNEL_SELECT", None)
    base = bs.result_shard_rows(_p29_run(
        bs.Session(executor=bs.MeshExecutor(auto_dense=False)), keys, ones,
        S))
    trace_path = os.path.join(out_dir, "trace-29c.json")
    os.environ["BIGSLICE_KERNEL_SELECT"] = "measured"
    try:
        sess = bs.Session(executor=bs.MeshExecutor(auto_dense=False),
                          trace_path=trace_path)
    finally:
        os.environ.pop("BIGSLICE_KERNEL_SELECT", None)
    if sess.kernel_select is None or sess.kernel_select.mode != "measured":
        raise AssertionError("29c: no measured selector")
    st = sess.kernel_select.stats
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    res = _p29_run(sess, keys, ones, S)
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    _same_rows(bs.result_shard_rows(res), base, "29c measured against unset")
    summary = sess.telemetry_summary()
    probe_launches = {name: 0 for name in PATH_KERNELS}
    for per_kernel in summary["device"].get("kselect", {}).values():
        for name, k in per_kernel.items():
            probe_launches[name] += k["launches"]
    wave_launches = _hub_launches(summary)
    if {n: wave_launches[n] + probe_launches[n] for n in PATH_KERNELS} \
            != launches:
        raise AssertionError(f"29c: wave {wave_launches} + probe "
                             f"{probe_launches} != LAUNCHES {launches}")
    probed = [d for d in _kselect_decisions(sess) if "walls_ms" in d]
    if not probed:
        raise AssertionError(f"29c: no probe ran: {_kselect_decisions(sess)}")
    # Each probe: one warm-up and PROBE_ITERS timed calls of the hash
    # core (a decision may reuse a probe of the same shape).
    per_probe = 1 + ks.PROBE_ITERS
    k2 = probe_launches["hash_aggregate"]
    if not (k2 and k2 % per_probe == 0 and k2 <= per_probe * len(probed)
            and probe_launches["hash_partition"] == 0):
        raise AssertionError(f"29c: the probes launched {probe_launches} "
                             f"for {len(probed)} probed decisions")
    for d in probed:
        if not all(np.isfinite(v) and v > 0 for v in d["walls_ms"].values()):
            raise AssertionError(f"29c: probe medians {d['walls_ms']}")
        log(f"phase 29c: measured, op {d['op']} site {d['site']}: probe at "
            f"{d['probe_rows']} rows, medians ms {d['walls_ms']}, samples "
            f"ms {d['walls_all_ms']}"
            f"{', hash overflow rows ' + str(d['hash_overflow_rows']) if 'hash_overflow_rows' in d else ''}"
            f" -> {d['kernel']} ({d['reason']}), on {card}")
    verdicts = [(d["op"], d["kernel"], d["reason"])
                for d in _kselect_decisions(sess) if d["kernel"] != "reselect"]
    log(f"phase 29c: measured, reduce-wave {len(keys)} rows: wall "
        f"{wall:.4f} s, rows = the unset run's, verdicts {verdicts}, "
        f"launches {launches}: the op's waves {wave_launches}, the probe "
        f"(kselect) {probe_launches}, on {card}")

    # The same op over a hot key: 31 rows in 32 on key 0, the rest
    # uniform, so the map side's rows a partition fall by more than
    # RESELECT_RATIO.
    rng = np.random.RandomState(2929)
    hot = np.where(rng.randint(0, 32, len(keys)) == 0, keys, 0).astype(
        np.int32)
    r0, d0 = st.count("reselect", "measured:skew-shift"), len(
        _kselect_decisions(sess))
    res2 = _p29_run(sess, hot, ones, S)
    _count_check(hot)(bs.result_shard_rows(res2), S)
    new = _kselect_decisions(sess)[d0:]
    reselects = st.count("reselect", "measured:skew-shift") - r0
    decided = [d for d in new if d["kernel"] != "reselect"]
    shifted = [d for d in new if d["kernel"] == "reselect"]
    if reselects != 1 or len(decided) != 1:
        raise AssertionError(f"29c: the hot run made {reselects} "
                             f"re-selections and decisions {decided}")
    log(f"phase 29c: the same op over a hot key: decided again "
        f"({decided[0]['kernel']}, {decided[0]['reason']}, probe at "
        f"{decided[0].get('probe_rows')} rows, medians ms "
        f"{decided[0].get('walls_ms')}), then {reselects} re-selection "
        f"(max rows a partition {decided[0].get('max_rows')} -> "
        f"{shifted[0]['max_rows']}), on {card}")
    # After the re-selection the op decides again, against the hot
    # profile, which the same run does not shift.
    d1 = len(_kselect_decisions(sess))
    res3 = _p29_run(sess, hot, ones, S)
    _same_rows(bs.result_shard_rows(res3), bs.result_shard_rows(res2),
               "29c hot run twice")
    again = _kselect_decisions(sess)[d1:]
    if [d["kernel"] == "reselect" for d in again] != [False]:
        raise AssertionError(f"29c: after the re-selection: {again}")
    log(f"phase 29c: after it, the op decided again ({again[0]['kernel']}, "
        f"{again[0]['reason']}, probe at {again[0].get('probe_rows')} rows, "
        f"medians ms {again[0].get('walls_ms')}), no further re-selection")
    sess.shutdown()  # writes the trace

    # The race at other op shapes: the probe's two row ends, one and two
    # key columns, one and four value lanes (add, max, min, add), so that
    # a shape where the sort core wins would show. Outside the counted
    # runs.
    sweep = []
    racer = ks.KernelSelector("measured", None, device="cuda")
    for rows in (256, ks.MAX_PROBE_ROWS):
        for nkeys, nvals in ((1, 1), (2, 1), (1, 4), (2, 4)):
            ops = ("add", "max", "min", "add")[:nvals]
            p = racer._run_probe("sweep", None, rows, max(1, rows // 4),
                                 nkeys, nvals, ops, ("int32",) * nvals)
            w = p["walls_ms"]
            if not all(np.isfinite(v) and v > 0 for v in w.values()):
                raise AssertionError(f"29c sweep: medians {w}")
            sweep.append(dict(rows=rows, nkeys=nkeys, nvals=nvals,
                              walls_ms=w, winner=p["winner"],
                              sort_over_hash=round(w["sort"] / w["hash"], 4),
                              hash_overflow_rows=p.get(
                                  "hash_overflow_rows", 0)))
            log(f"phase 29c: probe sweep, {rows} rows ({rows // 4} "
                f"distinct), {nkeys} key(s), {nvals} value lane(s) {ops}: "
                f"medians ms {w}, sort/hash {w['sort'] / w['hash']:.4f}, "
                f"{p['winner']} wins, hash overflow rows "
                f"{p.get('hash_overflow_rows', 0)}, samples ms "
                f"{p['walls_all_ms']}, on {card}")
    sort_wins = [(d["rows"], d["nkeys"], d["nvals"]) for d in sweep
                 if d["winner"] == "sort"]
    log(f"phase 29c: probe sweep: the sort core wins at "
        f"{sort_wins or 'no swept shape'}")
    del res, res2, res3
    gc.collect()
    return dict(launches=launches, wall_s=wall,
                probe_launches=probe_launches, wave_launches=wave_launches,
                probes=[dict(op=d["op"], rows=d["probe_rows"],
                             walls_ms=d["walls_ms"],
                             walls_all_ms=d["walls_all_ms"],
                             kernel=d["kernel"], reason=d["reason"])
                        for d in probed + decided + again
                        if "walls_ms" in d],
                verdicts=verdicts, reselects=reselects, sweep=sweep,
                trace=trace_path)


def phase29d_tools(card: str, out_dir: str, traces: list) -> dict:
    """29d: slicetrace over 29a's and 29c's traces (each section, and
    ``--merge`` of the two into rank lanes), and obsdump's workload on the
    card (a trace and a summary whose device section lists K1 and K2)."""
    from bigslice_tpu_torch.parallel import cuda_kernels as ck
    from bigslice_tpu_torch.tools import obsdump, slicetrace

    trace_a, trace_c = traces
    report_c = slicetrace.analyze(trace_c)
    report_a = slicetrace.analyze(trace_a)
    for want in (":kernels", ":skew", ":overlap", "measured:"):
        if want not in report_c:
            raise AssertionError(f"29d: 29c's report lacks {want}")
    for report in (report_a, report_c):
        if ":recovery" in report or ":skew" not in report:
            raise AssertionError("29d: a report without skew, or with a "
                                 "recovery section after no fault")
    merged = slicetrace.analyze_merged([trace_a, trace_c])
    if "fleet: 2 rank trace(s) merged" not in merged or ":lanes" not in \
            merged:
        raise AssertionError("29d: --merge rendered no rank lanes")
    t_path = os.path.join(out_dir, "obsdump-trace.json")
    s_path = os.path.join(out_dir, "obsdump-summary.json")
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    rc = obsdump.main(["--trace", t_path, "--summary", s_path])
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    with open(s_path) as fh:
        summary = json.load(fh)
    with open(t_path) as fh:
        n_events = len(json.load(fh)["traceEvents"])
    listed = _hub_launches(summary)
    if (rc != 0 or listed != launches
            or not (listed["hash_partition"] and listed["hash_aggregate"])
            or not summary["workload"]["device"].startswith("cuda")):
        raise AssertionError(f"29d: obsdump rc {rc}, device kernels "
                             f"{listed}, LAUNCHES {launches}, workload "
                             f"{summary['workload']}")
    log(f"phase 29d: slicetrace of 29c's trace: "
        f"{len(report_c.splitlines())} lines with :kernels, :skew, "
        f":overlap, no :recovery; --merge of 29a's and 29c's traces: "
        f"{merged.splitlines()[0]}; obsdump on the card: exit {rc} in "
        f"{wall:.4f} s, {n_events} trace events, workload "
        f"{summary['workload']}, device kernels {listed} = LAUNCHES, on "
        f"{card}")
    return dict(launches=launches, wall_s=wall, report_lines=len(
        report_c.splitlines()), obsdump_workload=summary["workload"])


def phase29_operator_plane(card: str, phase3_launches: dict) -> dict:
    """Phase 29, the operator plane: 29a-29d, each with its wall and its
    launches by kernel on its own lines."""
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="chip-smoke-ops-")
    t0 = time.perf_counter()
    paths = {}
    t = time.perf_counter()
    paths["debug-server"] = phase29a_debug_server(card, out_dir)
    log(f"phase 29: debug-server took {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    paths.update(phase29b_static(card, phase3_launches))
    log(f"phase 29: kselect static took {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    paths["kselect-measured"] = phase29c_measured(card, out_dir)
    log(f"phase 29: kselect measured took {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    paths["obsdump"] = phase29d_tools(
        card, out_dir, [paths["debug-server"].pop("trace"),
                        paths["kselect-measured"].pop("trace")])
    log(f"phase 29: tools took {time.perf_counter() - t:.2f} s")
    log(f"phase 29: operator plane in {time.perf_counter() - t0:.2f} s")
    return paths


# -- phase 30: the serving plane ---------------------------------------------

#: Phase 30's pipelines read their data from here: module-level
#: functions keep one identity (and one op site) across sessions, as a
#: served pipeline's do.
_P30 = {}


def _p30_add(a, b):
    return a + b


def _p30_reduce():
    """Phase 3's Reduce: 2**25 rows over 2**20 keys, S = 4."""
    import bigslice_tpu_torch as bs

    return bs.Reduce(bs.Const(4, _P30["keys"], _P30["ones"]), _p30_add)


def _p30_qps():
    """The JAX package's serve-qps pipeline: 2**20 rows over 2**12 keys,
    S = 2 (two waves on one card)."""
    import bigslice_tpu_torch as bs

    return bs.Reduce(bs.Const(2, _P30["qkeys"], _P30["qones"]), _p30_add)


def _p30_small(n_keys=4096):
    """A 2**22-row Reduce for the admission, cost and cache parts."""
    import bigslice_tpu_torch as bs

    return bs.Reduce(bs.Const(4, _P30["skeys"] % np.int32(n_keys),
                              _P30["sones"]), _p30_add)


def _p30_post(port: int, doc: dict, timeout: float = 300.0) -> tuple:
    """(status, decoded JSON) of one POST /serve/invoke."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/serve/invoke",
        data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _p30_rows_check(doc: dict, bc, what: str) -> np.ndarray:
    """Every row of a served count against np.bincount; the rows as a
    sorted [n, 2] array."""
    rows = np.asarray(doc["rows"], dtype=np.int64).reshape(-1, 2)
    rows = rows[np.argsort(rows[:, 0])]
    present = np.nonzero(bc)[0]
    if (doc["rows_truncated"] or doc["num_rows"] != len(present)
            or not np.array_equal(rows[:, 0], present)
            or not np.array_equal(rows[:, 1], bc[present])):
        raise AssertionError(f"{what}: the served rows differ from "
                             f"np.bincount ({doc['num_rows']} rows)")
    return rows


def _p30_counts(sess) -> dict:
    t = sess.telemetry_summary()["device"]["totals"]
    return {k: t[k] for k in ("program_builds", "cache_hits",
                              "cross_session_hits")}


def phase30ab_full_width(card: str, phase3: dict) -> tuple:
    """30a: phase 3's Reduce registered on ``ServeServer(Session(...),
    port=0, slots=2, queue_depth=64)`` and invoked over HTTP once with
    every row: the rows against np.bincount, K1 and K2 launches equal to
    phase 3's. 30b: the server attached to a fresh Session and invoked
    again: bit-equal rows, the program cache's hits risen, and no group
    program built after a miss in the fresh Session."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.parallel import cuda_kernels as ck
    from bigslice_tpu_torch.serve import programcache
    from bigslice_tpu_torch.serve.server import ServeServer

    n, span = 1 << 25, 1 << 20
    _P30["keys"] = np.random.RandomState(42).randint(
        0, span, n).astype(np.int32)
    _P30["ones"] = np.ones(n, np.int32)
    bc = np.bincount(_P30["keys"], minlength=span)
    sess_a = bs.Session(executor=bs.MeshExecutor(auto_dense=False))
    server = ServeServer(sess_a, port=0, slots=2, queue_depth=64)
    server.register("reduce-wave", _p30_reduce)
    req = {"pipeline": "reduce-wave", "tenant": "chip", "max_rows": 1 << 21}
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    code, doc = _p30_post(server.port, req)
    wall_a = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    if code != 200:
        raise AssertionError(f"30a: {code} {str(doc)[:2000]}")
    rows_a = _p30_rows_check(doc, bc, "30a")
    want = {k: phase3[k] for k in ("hash_partition", "hash_aggregate")}
    got = {k: launches[k] for k in want}
    if got != want or got != {"hash_partition": 4, "hash_aggregate": 8}:
        raise AssertionError(f"30a: launches {launches}, phase 3's {phase3}")
    counts_a = _p30_counts(sess_a)
    lat_a = doc["latency_s"]
    log(f"phase 30a: reduce-wave served over HTTP, {n} rows, "
        f"{doc['num_rows']} rows back = np.bincount: latency_s "
        f"{doc['latency_s']} (server), {wall_a:.4f} s at the client, "
        f"against phase 3's warm wall {phase3['wall_s']:.4f} s; launches "
        f"{launches}; programs {counts_a}; on {card}")
    del doc

    pc0 = programcache.global_program_cache().stats()
    sess_b = bs.Session(executor=bs.MeshExecutor(auto_dense=False))
    server.attach_session(sess_b)
    sess_a.shutdown()
    ck.reset_launches()
    t0 = time.perf_counter()
    code, doc = _p30_post(server.port, req)
    wall_b = time.perf_counter() - t0
    launches_b = dict(ck.LAUNCHES)
    if code != 200:
        raise AssertionError(f"30b: {code} {str(doc)[:2000]}")
    rows_b = _p30_rows_check(doc, bc, "30b")
    pc1 = programcache.global_program_cache().stats()
    counts_b = _p30_counts(sess_b)
    if not np.array_equal(rows_a, rows_b):
        raise AssertionError("30b: the fresh Session's rows differ")
    if (counts_b["program_builds"] != 0
            or counts_b["cross_session_hits"] < 2
            or pc1["hits"] - pc0["hits"] != counts_b["cross_session_hits"]
            or launches_b != dict(launches)):
        raise AssertionError(f"30b: programs {counts_b}, cache {pc0} -> "
                             f"{pc1}, launches {launches_b}")
    saved = pc1["compile_s_saved"] - pc0["compile_s_saved"]
    log(f"phase 30b: a fresh Session attached: latency_s "
        f"{doc['latency_s']} (server), {wall_b:.4f} s at the client, rows "
        f"bit-equal to 30a's; programs {counts_b} (none built after a "
        f"miss); global hits {pc0['hits']} -> {pc1['hits']}, "
        f"compile_s_saved +{saved:.6f} s (build seconds); launches "
        f"{launches_b}; on {card}")
    lat_b = doc["latency_s"]
    del doc, rows_a, rows_b
    _P30.pop("keys")
    _P30.pop("ones")
    out = dict(launches=launches, latency_s=wall_a, server_latency_s=lat_a,
               fresh_latency_s=wall_b, fresh_server_latency_s=lat_b,
               programs_first=counts_a, programs_fresh=counts_b,
               cache_hits=pc1["hits"] - pc0["hits"],
               compile_s_saved=saved)
    return server, sess_b, out


def phase30c_sustained(card: str, server) -> dict:
    """30c: the JAX package's serve-qps shape (bench.py:1218-1330) on a
    fresh ``Session()`` (the default executor): 8 closed-loop HTTP
    clients over 4 tenants for 10 s, ``rows: false``; every response's
    ``num_rows`` checked; QPS, p50, p99, rows/s and shed recorded."""
    import threading

    import bigslice_tpu_torch as bs

    rows, span = 1 << 20, 1 << 12
    _P30["qkeys"] = np.random.RandomState(42).randint(
        0, span, rows).astype(np.int32)
    _P30["qones"] = np.ones(rows, np.int32)
    want = len(np.unique(_P30["qkeys"]))
    old = server.session
    server.attach_session(bs.Session())
    old.shutdown()
    server.register("qps", _p30_qps)
    shed0 = server.stats.summary()["totals"]["shed"]
    for tenant in ("t0", "t1", "t2", "t3"):  # the first wave of each
        code, doc = _p30_post(server.port, {"pipeline": "qps",
                                            "tenant": tenant, "rows": False})
        if code != 200 or doc["num_rows"] != want:
            raise AssertionError(f"30c warm-up: {code} {doc}")
    seconds, clients = 10.0, 8
    lats, bad, errors = [], [], []
    lock = threading.Lock()
    stop_at = time.perf_counter() + seconds

    def client(i):
        tenant = f"t{i % 4}"
        while time.perf_counter() < stop_at:
            t0 = time.perf_counter()
            try:
                code, doc = _p30_post(server.port, {
                    "pipeline": "qps", "tenant": tenant, "rows": False})
            except Exception as e:  # noqa: BLE001 — reported below
                with lock:
                    errors.append(repr(e))
                return
            dt = time.perf_counter() - t0
            with lock:
                if code == 200 and doc.get("num_rows") == want:
                    lats.append(dt)
                elif code != 503:
                    bad.append((code, str(doc)[:200]))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors or bad or not lats:
        raise AssertionError(f"30c: errors {errors[:3]}, bad {bad[:3]}, "
                             f"{len(lats)} good")
    shed = server.stats.summary()["totals"]["shed"] - shed0
    qps = len(lats) / wall
    p50 = float(np.percentile(lats, 50))
    p99 = float(np.percentile(lats, 99))
    log(f"phase 30c: serve-qps ({rows} rows over {span} keys, S=2, "
        f"{clients} clients over 4 tenants, slots=2, rows false) for "
        f"{wall:.2f} s: {len(lats)} ok, {qps:.2f} QPS, p50 {p50:.4f} s, "
        f"p99 {p99:.4f} s, {qps * rows:.1f} rows/s, shed {shed}; on {card}")
    return dict(qps=qps, p50_s=p50, p99_s=p99, rows_per_s=qps * rows,
                shed=shed, requests=len(lats), wall_s=wall)


def phase30d_admission(card: str) -> dict:
    """30d: a gated slow pipeline gives 503 with the queue full and 429
    at the quota; the predictive 504 fires, and a mid-flight 504 frees
    its slot for the queued request. Then the cost gate: under
    ``BIGSLICE_ADAPTIVE=cost`` the sole invocation's declared launch
    bytes (the sum of ``cuda_kernels.cost`` over its counted launches)
    become its prediction, and with a budget below two invocations'
    bytes the second concurrent one is shed "predicted cost"."""
    import tempfile
    import threading

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.parallel import cuda_kernels as ck
    from bigslice_tpu_torch.serve.server import ServeServer

    n = 1 << 22
    _P30["skeys"] = np.random.RandomState(30).randint(
        0, 1 << 20, n).astype(np.int32)
    _P30["sones"] = np.ones(n, np.int32)
    gate, started = threading.Event(), threading.Event()

    def slow():
        started.set()
        if not gate.wait(60):
            raise AssertionError("30d: the gate was never opened")
        return _p30_small()

    cache_dir = tempfile.mkdtemp(prefix="chip-smoke-serve-")
    sess = bs.Session(executor=bs.MeshExecutor(auto_dense=False))
    srv = ServeServer(sess, port=0, slots=1, queue_depth=0, tenant_quota=1,
                      result_cache_dir=cache_dir)
    srv.register("slow", slow)
    srv.register("fast", _p30_small)
    out = {}

    def occupy(key, req):
        out[key] = srv.invoke_request(req)

    def hold(key, req):
        gate.clear()
        started.clear()
        t = threading.Thread(target=occupy, args=(key, req))
        t.start()
        if not started.wait(60):
            raise AssertionError("30d: the slow pipeline never started")
        return t

    t0 = time.perf_counter()
    t = hold("a", {"pipeline": "slow", "tenant": "a"})
    full = srv.invoke_request({"pipeline": "fast", "tenant": "b"})
    srv.queue_depth = 4
    quota = srv.invoke_request({"pipeline": "fast", "tenant": "a"})
    gate.set()
    t.join(120)
    if full[0] != 503 or quota[0] != 429 or out["a"][0] != 200:
        raise AssertionError(f"30d: queue full {full}, quota {quota}, "
                             f"first {out['a'][0]}")
    # The predictive 504: the EWMA of "fast" (its run above) times a
    # budget it cannot meet.
    code, doc = srv.invoke_request({"pipeline": "fast", "tenant": "c",
                                    "deadline_s": 60})
    ewma = srv._pipe_latency["fast"]
    code2, doc2 = srv.invoke_request({"pipeline": "fast", "tenant": "c",
                                      "deadline_s": ewma / 4})
    if code != 200 or code2 != 504 or "predicted wall" not in doc2["error"]:
        raise AssertionError(f"30d predictive: {code}, {code2} {doc2}")
    # Mid-flight: a 0.25 s budget expires while the slow pipeline holds
    # the slot; its 504 frees the slot for the queued request.
    t = hold("mid", {"pipeline": "slow", "tenant": "d", "deadline_s": 0.25})
    waiter = threading.Thread(target=occupy, args=(
        "queued", {"pipeline": "fast", "tenant": "e"}))
    waiter.start()
    deadline = time.monotonic() + 30
    while srv.stats.queued < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    time.sleep(0.3)
    gate.set()
    t.join(120)
    waiter.join(120)
    if (out["mid"][0] != 504 or "pending_tasks" not in out["mid"][1]
            or out["queued"][0] != 200):
        raise AssertionError(f"30d mid-flight: {out['mid']}, queued "
                             f"{out['queued'][0]}")
    outcomes = srv.stats.summary()["tenants"]
    log(f"phase 30d: admission: queue full 503, quota 429, predictive 504 "
        f"(EWMA {ewma:.4f} s, budget {ewma / 4:.4f} s), mid-flight 504 "
        f"then the queued request 200; outcomes "
        f"{ {t: o['outcomes'] for t, o in outcomes.items()} } in "
        f"{time.perf_counter() - t0:.2f} s; on {card}")

    # 30e rides this server: its result cache.
    result_cache = phase30e_result_cache(card, srv)
    sess.shutdown()

    # The cost gate: its own session, built under the knob.
    saved = {k: os.environ.get(k) for k in
             ("BIGSLICE_ADAPTIVE", "BIGSLICE_SERVE_COST_BUDGET_BYTES")}
    os.environ["BIGSLICE_ADAPTIVE"] = "cost"
    os.environ.pop("BIGSLICE_SERVE_COST_BUDGET_BYTES", None)
    try:
        csess = bs.Session(executor=bs.MeshExecutor(auto_dense=False))
        csrv = ServeServer(csess, port=0, slots=2, queue_depth=4)
        cgate, cstarted = threading.Event(), threading.Event()

        def cost_pipe(gated=False):
            if gated:
                cstarted.set()
                if not cgate.wait(60):
                    raise AssertionError("30d cost: the gate was never "
                                         "opened")
            return _p30_small()

        csrv.register("cost", cost_pipe)
        spied = []
        count = ck._count

        def spy(name, **shape):
            spied.append(ck.cost(name, **shape)["bytes"])
            count(name, **shape)

        ck._count = spy
        try:
            code, doc = csrv.invoke_request({"pipeline": "cost"})
        finally:
            ck._count = count
        predicted = csrv._pipe_cost.get("cost")
        if code != 200 or not spied or predicted != sum(spied):
            raise AssertionError(f"30d cost: {code}, predicted {predicted} "
                                 f"against {sum(spied)} declared over "
                                 f"{len(spied)} launches")
        budget = predicted * 3 // 2
        os.environ["BIGSLICE_SERVE_COST_BUDGET_BYTES"] = str(budget)
        th = threading.Thread(target=lambda: out.__setitem__(
            "cost_a", csrv.invoke_request({"pipeline": "cost",
                                           "args": [True]})))
        th.start()
        if not cstarted.wait(60):
            raise AssertionError("30d cost: the first invocation never "
                                 "started")
        shed = csrv.invoke_request({"pipeline": "cost"})
        cgate.set()
        th.join(120)
        counts = csess.adaptive.stats.summary()["counts"]["cost"]
        if (shed[0] != 503 or "predicted cost" not in shed[1]["error"]
                or out["cost_a"][0] != 200 or counts.get("serve_shed") != 1):
            raise AssertionError(f"30d cost: shed {shed}, first "
                                 f"{out['cost_a'][0]}, counts {counts}")
        log(f"phase 30d: cost gate: predicted {predicted} bytes = the sum "
            f"of cuda_kernels.cost over the sole run's {len(spied)} "
            f"launches; budget {budget}: the second concurrent invocation "
            f"shed 503 ({shed[1]['error']}); adaptive counts {counts}; on "
            f"{card}")
        csess.shutdown()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return dict(predicted_bytes=predicted, cost_launches=len(spied),
                budget_bytes=budget, ewma_s=ewma,
                result_cache=result_cache)


def phase30e_result_cache(card: str, srv) -> dict:
    """30e: a ``cache=True`` pipeline: the first invocation computes and
    writes (K1 and K2 launched), the second is a hit with no K1 or K2
    launch and the same rows."""
    from bigslice_tpu_torch.ops import cache as cache_mod
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    srv.register("cached", _p30_small, cache=True)
    req = {"pipeline": "cached", "args": [1 << 16], "max_rows": 1 << 17}
    walls, launches = [], []
    docs = []
    c0 = cache_mod.result_cache_counts()
    for _ in range(2):
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.perf_counter()
        code, doc = srv.invoke_request(dict(req))
        walls.append(time.perf_counter() - t0)
        launches.append(dict(ck.LAUNCHES))
        if code != 200:
            raise AssertionError(f"30e: {code} {doc}")
        docs.append(sorted(map(tuple, doc["rows"])))
    c1 = cache_mod.result_cache_counts()
    bc = np.bincount(_P30["skeys"] % (1 << 16), minlength=1 << 16)
    present = np.nonzero(bc)[0]
    if (docs[0] != docs[1] or len(docs[0]) != len(present)
            or [k for k, _ in docs[0]] != present.tolist()
            or [v for _, v in docs[0]] != bc[present].tolist()):
        raise AssertionError("30e: the cached rows differ from np.bincount")
    if (not (launches[0]["hash_partition"] and launches[0]["hash_aggregate"])
            or launches[1]["hash_partition"] or launches[1]["hash_aggregate"]
            or c1["hit"] - c0["hit"] < 1 or c1["miss"] - c0["miss"] < 1):
        raise AssertionError(f"30e: launches {launches}, counts {c0} -> "
                             f"{c1}")
    log(f"phase 30e: result cache: miss {walls[0]:.4f} s (launches "
        f"{launches[0]}), hit {walls[1]:.4f} s (launches {launches[1]}), "
        f"counts {c0} -> {c1}; on {card}")
    return dict(miss_s=walls[0], hit_s=walls[1], launches=launches)


def phase30f_cli(card: str) -> dict:
    """30f: ``python -m bigslice_tpu_torch.tools.sliceserve --port 0`` in
    a subprocess: its JSON line, one ``reduce`` invocation, SIGTERM; exit
    0 and the final snapshot line on stderr. Spawn to the first 200 is a
    fresh process's cold start (interpreter and torch import, the CUDA
    context, the kernel library loaded from its digest's ``.so``)."""
    import signal as signal_mod

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "bigslice_tpu_torch.tools.sliceserve",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()
        ready_s = time.perf_counter() - t0
        if not first:
            proc.wait(60)
            raise AssertionError(f"30f: no JSON line, exit {proc.returncode}"
                                 f"\n{proc.stderr.read()[-3000:]}")
        info = json.loads(first)
        code, doc = _p30_post(info["port"], {"pipeline": "reduce"})
        first_200_s = time.perf_counter() - t0
        code2, doc2 = _p30_post(info["port"], {"pipeline": "reduce"})
        keys = np.random.RandomState(42).randint(
            0, 1 << 12, 1 << 18).astype(np.int32)
        want = len(np.unique(keys))
        if (code, code2) != (200, 200) or doc["num_rows"] != want or \
                doc2["num_rows"] != want:
            raise AssertionError(f"30f: {code} {str(doc)[:300]}; {code2}")
        proc.send_signal(signal_mod.SIGTERM)
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0 or "sliceserve: shutdown after" not in stderr:
        raise AssertionError(f"30f: exit {proc.returncode}\n{stderr[-3000:]}")
    snap = [ln for ln in stderr.splitlines()
            if "sliceserve: shutdown after" in ln][0]
    log(f"phase 30f: sliceserve CLI: JSON line after {ready_s:.3f} s, "
        f"first 200 after {first_200_s:.3f} s (server latency_s "
        f"{doc['latency_s']}), second latency_s {doc2['latency_s']}; "
        f"SIGTERM -> exit 0, {snap!r}; on {card}")
    return dict(ready_s=ready_s, first_200_s=first_200_s,
                first_latency_s=doc["latency_s"],
                second_latency_s=doc2["latency_s"])


def phase30_serving(card: str, phase3: dict) -> dict:
    """Phase 30, the serving plane: 30a-30f, each with its wall on its
    own line. The counted run of the path is 30a's invocation."""
    t0 = time.perf_counter()
    t = time.perf_counter()
    server, _, ab = phase30ab_full_width(card, phase3)
    log(f"phase 30: full width and program cache took "
        f"{time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    ab["sustained"] = phase30c_sustained(card, server)
    server.session.shutdown()
    _P30.clear()
    gc.collect()
    log(f"phase 30: sustained took {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    ab["admission"] = phase30d_admission(card)
    log(f"phase 30: admission, cost gate and result cache took "
        f"{time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    ab["cli"] = phase30f_cli(card)
    log(f"phase 30: CLI took {time.perf_counter() - t:.2f} s")
    _P30.clear()
    gc.collect()
    log(f"phase 30: serving plane in {time.perf_counter() - t0:.2f} s")
    return {"serving": ab}


# -- phase 31: attention, the one-card tools, the staging breakdown ---------

#: 31a's shape: the JAX package's attention benchmark at one device
#: (seq 2**13, 2 heads of 128, causal) and its forward operation count,
#: 4 * seq**2 * heads * head_dim.
ATT_SEQ, ATT_HEADS, ATT_HD = 1 << 13, 2, 128
ATT_FLOPS = 4 * ATT_SEQ ** 2 * ATT_HEADS * ATT_HD
#: The reference tests' tolerances: fp32 and bf16 products.
ATT_TOL = {"float32": 3e-4, "bfloat16": 3e-2}
#: Limits on ||out - ref|| / ||ref||. At 31a's inputs (0.3 * randn) the
#: softmax is nearly uniform and the elementwise tolerances would pass
#: a body that ignored q k^T and returned the causal running mean of v
#: (its relative error is about 8e-2 there); bf16 rounding of q, k, v
#: and p gives about 2e-3.
ATT_REL = {"float32": 1e-5, "bfloat16": 1e-2}


def _att_inputs(seq: int, seed: int):
    """(q, k, v) as [seq, heads * hd] float32 columns, and the float64
    oracle over them (causal), computed on the host."""
    from bigslice_tpu_torch.parallel.ulysses import dense_mha_reference

    rng = np.random.RandomState(seed)
    d = ATT_HEADS * ATT_HD
    cols = [(rng.randn(seq, d) * 0.3).astype(np.float32) for _ in range(3)]
    ref = dense_mha_reference(
        *(c.reshape(seq, ATT_HEADS, ATT_HD) for c in cols),
        causal=True).reshape(seq, d)
    return cols, ref


def _att_check(what: str, out: np.ndarray, ref: np.ndarray,
               tol: float, rel_tol: float = ATT_REL["float32"]):
    """Hold ``out`` against the oracle elementwise at ``tol`` and by the
    norm of the difference at ``rel_tol``: (max |err|, relative err)."""
    if out.shape != ref.shape or not np.isfinite(out).all():
        raise AssertionError(f"{what}: shape {out.shape} or non-finite "
                             f"values, expected {ref.shape}")
    diff = out.astype(np.float64) - ref
    err = float(np.abs(diff).max())
    rel = float(np.linalg.norm(diff) / np.linalg.norm(ref))
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol,
                               err_msg=f"{what} against the oracle")
    if not rel <= rel_tol:
        raise AssertionError(f"{what}: relative error {rel:.3e} against "
                             f"the oracle, limit {rel_tol}")
    return err, rel


def _att_rows(res) -> np.ndarray:
    """A SelfAttend result's o column in row order, shard by shard (the
    global sequence order; ``result_shard_rows`` would sort it)."""
    from bigslice_tpu_torch.frame.frame import to_numpy

    return np.concatenate([to_numpy(f.cols[0])
                           for shard in range(res.num_shards)
                           for f in res.reader(shard, ())])


def _att_run(bs, S, cols, **kw):
    """Build a session, run SelfAttend over ``Const(S, q, k, v)`` and
    read its rows back: (output [seq, d], executor)."""
    ex = bs.MeshExecutor()
    res = bs.Session(executor=ex).run(
        bs.SelfAttend(bs.Const(S, *cols), causal=True, heads=ATT_HEADS, **kw))
    out = _att_rows(res)
    torch.cuda.synchronize()
    return out, ex


def _att_counted(bs, S, cols, **kw):
    """The counted run: ``_att_run`` with the launches it made."""
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    out, ex = _att_run(bs, S, cols, **kw)
    wall = time.perf_counter() - t0
    return out, ex, wall, {k: ck.LAUNCHES[k] for k in PATH_KERNELS}


def phase31a_device_tier(card: str) -> dict:
    """31a: SelfAttend at full width on the device tier (S = 1, seq
    2**13, 2 heads of 128, causal) in three lowerings: ``auto`` in fp32
    (Ulysses), ``auto`` in bf16 and the ring in bf16 tiled at
    ``block_q = max(128, seq // 64)``. Each once counted and three times
    warm, against the host's float64 oracle, with the stage's device
    time (CUDA events around the executor's attend stage over the staged
    columns), TFLOP/s of the forward's operations over it, the peak
    device memory and the launches; then scaled_dot_product_attention
    on the same q, k, v as a yardstick that is not on the path."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.meshexec import MeshExecutor, StagedInput

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: fp32 attention needs it off")
    cols, ref = _att_inputs(ATT_SEQ, 31)
    block_q = max(128, ATT_SEQ // 64)
    lowerings = [
        ("attention-ulysses-fp32", dict(), "ulysses"),
        ("attention-ulysses-bf16", dict(dtype=torch.bfloat16), "ulysses"),
        ("attention-ring-bf16", dict(dtype=torch.bfloat16, method="ring",
                                     block_q=block_q), "ring"),
    ]
    dev_cols = [torch.from_numpy(c).cuda() for c in cols]
    counts = torch.tensor([ATT_SEQ], dtype=torch.int32, device="cuda")
    staged = StagedInput(dev_cols, counts, ATT_SEQ, False, None)
    scratch = MeshExecutor()
    out_paths = {}
    for name, kw, method in lowerings:
        dt = "bfloat16" if "dtype" in kw else "float32"
        out, ex, counted_s, launches = _att_counted(bs, 1, cols, **kw)
        if set(ex.attend_methods.values()) != {method}:
            raise AssertionError(f"{name}: attend_methods "
                                 f"{ex.attend_methods}, expected {method}")
        err, rel = _att_check(name, out, ref, ATT_TOL[dt], ATT_REL[dt])
        del out, ex
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            out, _ = _att_run(bs, 1, cols, **kw)
            walls.append(time.perf_counter() - t0)
        _att_check(name, out, ref, ATT_TOL[dt], ATT_REL[dt])
        peak = torch.cuda.max_memory_allocated() / 2**30
        att = bs.SelfAttend(bs.Const(1, *cols), causal=True,
                            heads=ATT_HEADS, **kw)
        stage_ms = time_ms(lambda: scratch._attend("phase31", att, staged),
                           reps=5, warmup=1)
        out_paths[name] = dict(
            wall_s=round(statistics.median(walls), 4),
            walls_s=[round(w, 4) for w in walls],
            counted_s=round(counted_s, 4), stage_ms=round(stage_ms, 4),
            tflops=round(ATT_FLOPS / (stage_ms * 1e-3) / 1e12, 3),
            peak_gib=round(peak, 4), max_abs_err=err, rel_err=rel,
            method=method,
            launches=launches)
        log(f"phase 31a: {name} ({method}, {dt}) warm wall "
            f"{out_paths[name]['wall_s']} s (runs {out_paths[name]['walls_s']}"
            f"), stage {stage_ms:.4f} ms device = "
            f"{out_paths[name]['tflops']} TFLOP/s of {ATT_FLOPS:.3e}, peak "
            f"{peak:.4f} GiB, max |err| {err:.3e} (tol {ATT_TOL[dt]}), "
            f"relative err {rel:.3e} (limit {ATT_REL[dt]}), "
            f"launches {launches}, on {card}")
        for k in PATH_KERNELS:
            if launches[k]:
                raise AssertionError(f"{name}: {k} launched {launches[k]}x; "
                                     f"the attend path has no shuffle")
    if not (out_paths["attention-ring-bf16"]["peak_gib"]
            < out_paths["attention-ulysses-fp32"]["peak_gib"]):
        raise AssertionError("the tiled ring's peak is not below Ulysses'")
    # The yardstick: one library call on the same q, k, v, not on the path.
    qh, kh, vh = (c.reshape(ATT_SEQ, ATT_HEADS, ATT_HD).transpose(0, 1)[None]
                  for c in dev_cols)
    sdpa = {}
    for dt in (torch.float32, torch.bfloat16):
        q4, k4, v4 = (x.to(dt).contiguous() for x in (qh, kh, vh))
        sdpa[str(dt).split(".")[1]] = round(time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True), reps=5, warmup=1), 4)
    log(f"phase 31a: scaled_dot_product_attention (yardstick, not on the "
        f"path) ms {sdpa}, on {card}")
    out_paths["attention-ulysses-fp32"]["sdpa_ms"] = sdpa
    del staged, dev_cols, scratch
    gc.collect()
    torch.cuda.empty_cache()
    return out_paths


def phase31b_host_tier(card: str) -> dict:
    """31b: S = 4 > the one device slot: the group runs on the host tier
    (no attend lowering recorded), shard 0's float64 oracle over the
    broadcast read, against an independent oracle, seq 2**12."""
    import bigslice_tpu_torch as bs

    cols, ref = _att_inputs(1 << 12, 32)
    out, ex, wall, launches = _att_counted(bs, 4, cols)
    if ex.attend_methods:
        raise AssertionError(f"attention-host: the device stage ran "
                             f"({ex.attend_methods})")
    err, _ = _att_check("attention-host", out, ref, 1e-5)
    log(f"phase 31b: attention-host (S = 4, host tier) wall {wall:.4f} s, "
        f"max |err| {err:.3e}, launches {launches}, on {card}")
    return {"wall_s": round(wall, 4), "max_abs_err": err,
            "launches": launches}


def phase31c_fused_map(card: str) -> dict:
    """31c: Map(o * 2) fused after the attend stage, S = 1, seq 2**12."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    cols, ref = _att_inputs(1 << 12, 33)
    ex = bs.MeshExecutor()
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    res = bs.Session(executor=ex).run(bs.Map(
        bs.SelfAttend(bs.Const(1, *cols), causal=True, heads=ATT_HEADS),
        lambda o: o * 2.0))
    out = _att_rows(res)
    wall = time.perf_counter() - t0
    launches = {k: ck.LAUNCHES[k] for k in PATH_KERNELS}
    ops = {t.op.split("@")[0] for t in ex._task_index}
    if "attend_map" not in ops or not ex.attend_methods:
        raise AssertionError(f"attention-map: the Map did not fuse into the "
                             f"device attend group ({ops})")
    err, _ = _att_check("attention-map", out, 2.0 * ref, ATT_TOL["float32"])
    log(f"phase 31c: attention-map (o * 2 fused) wall {wall:.4f} s, max "
        f"|err| {err:.3e}, launches {launches}, on {card}")
    return {"wall_s": round(wall, 4), "max_abs_err": err,
            "launches": launches}


#: 31d's checker source: six problems, on lines 7, 8, 10, 12, 13, 14.
_TYPED_SRC = (
    "import bigslice_tpu_torch as bs\n"
    "@bs.func\n"
    "def pipe(n: int, name: str, rate: np.float32, free):\n"
    "    return None\n"
    "x = 'hello'\n"
    "sess.run(pipe, 4, 'corpus', 0.5, object())\n"
    "sess.run(pipe, 'four', 'corpus', 0.5, 1)\n"
    "sess.run(pipe, 4, 7, 0.5, 1)\n"
    "sess.run(pipe, 4, x, 2, 1)\n"
    "sess.run(pipe, 4, [1], 0.5, 1)\n"
    "sess.run(pipe, dynamic_thing, 'c', 0.5, 1)\n"
    "sess.run(pipe, 4, 'c', 0.5, lambda: 1)\n"
    "sess.run(pipe, 4, 'c', 0.5, open('f'))\n"
    "sess.run(pipe, 4, 'c', 0.5, (i for i in x))\n"
)
_MICROBENCH_NAMES = {"eval_chain", "eval_fanout", "frame_hash",
                     "frame_partition", "frame_sort", "codec_encode",
                     "codec_decode", "device_reduce", "wave_stress"}


def phase31d_tools(card: str) -> dict:
    """31d: the one-card tools on the card: every slicer mode (each
    checks its own result and exits 0), ``microbench --quick`` with
    every line parsed, and ``slicetypecheck`` over a source with six
    known problems."""
    import contextlib
    import io
    import tempfile

    from bigslice_tpu_torch.parallel import cuda_kernels as ck
    from bigslice_tpu_torch.tools import microbench, slicer, slicetypecheck

    torch.cuda.synchronize()
    ck.reset_launches()
    walls = {}
    for mode in sorted(slicer.MODES):
        rows = "100000" if mode == "oom" else "200000"
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = slicer.main([mode, "-rows", rows, "-shards", "8"])
        walls[mode] = round(time.perf_counter() - t0, 3)
        if rc != 0 or f"slicer {mode}:" not in buf.getvalue():
            raise AssertionError(f"slicer {mode}: rc {rc}, {buf.getvalue()}")
        log(f"phase 31d: {buf.getvalue().strip()}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = microbench.main(["--quick"])
    walls["microbench"] = round(time.perf_counter() - t0, 3)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    names = {ln.split()[0] for ln in lines}
    if rc != 0 or names != _MICROBENCH_NAMES:
        raise AssertionError(f"microbench --quick: rc {rc}, lines {lines}")
    for ln in lines:
        rate = re.search(r"([0-9.]+) (us/task|Mrows/s|Krows/s)", ln)
        if rate is None or not float(rate.group(1)) > 0:
            raise AssertionError(f"microbench: unparsed line {ln!r}")
        log(f"phase 31d: microbench {ln}")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "pipe.py")
        with open(path, "w") as fh:
            fh.write(_TYPED_SRC)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = slicetypecheck.main([path])
    got = sorted(int(ln.split(":")[1]) for ln in buf.getvalue().splitlines())
    if rc != 1 or got != [7, 8, 10, 12, 13, 14]:
        raise AssertionError(f"slicetypecheck: rc {rc}, lines {got}")
    launches = {k: ck.LAUNCHES[k] for k in PATH_KERNELS}
    log(f"phase 31d: slicetypecheck found problems on lines {got}; tool "
        f"walls s {walls}, launches {launches}, on {card}")
    return {"walls_s": walls, "launches": launches}


def phase31e_staging_breakdown(card: str) -> dict:
    """31e: phase 3's reduce-wave with the hub on: the source group's
    ``staging_breakdown`` holds read, assemble and upload seconds, each
    non-negative, their sum within its staged seconds."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    S, n, span = 4, 1 << 25, 1 << 20
    keys = np.random.RandomState(42).randint(0, span, n).astype(np.int32)
    ones = np.ones(n, np.int32)
    sess = bs.Session(executor=bs.MeshExecutor(auto_dense=False))
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    res = sess.run(bs.Reduce(bs.Const(S, keys, ones), lambda a, b: a + b))
    total = sum(int(sh[1].astype(np.int64).sum())
                for sh in bs.result_shard_rows(res))
    wall = time.perf_counter() - t0
    launches = {k: ck.LAUNCHES[k] for k in PATH_KERNELS}
    if total != n:
        raise AssertionError(f"staging-breakdown: counts sum {total} != {n}")
    waves = {op.split("@")[0]: o["waves"]
             for op, o in sess.telemetry_summary()["ops"].items()
             if "waves" in o}
    sess.shutdown()
    src = waves.get("const", {})
    parts = src.get("staging_breakdown")
    if (not parts or not {"read_s", "assemble_s", "upload_s"} <= set(parts)
            or min(parts.values()) < 0
            or sum(parts.values()) > src["staging_s"] + 1e-6):
        raise AssertionError(f"staging-breakdown: {src}")
    log(f"phase 31e: staging breakdown s {parts} within staged "
        f"{src['staging_s']} s over {src['staged']} waves; wall {wall:.4f} "
        f"s, launches {launches}, on {card}")
    return {"wall_s": round(wall, 4), "breakdown": parts,
            "staging_s": src["staging_s"], "launches": launches}


def phase31_attention(card: str) -> dict:
    """Phase 31: 31a-31e, each with its wall on its own line."""
    t0 = time.perf_counter()
    paths = {}
    for label, key, fn in (("31a", None, phase31a_device_tier),
                           ("31b", "attention-host", phase31b_host_tier),
                           ("31c", "attention-map", phase31c_fused_map),
                           ("31d", "tools", phase31d_tools),
                           ("31e", "staging-breakdown",
                            phase31e_staging_breakdown)):
        t = time.perf_counter()
        out = fn(card)
        if key is None:
            paths.update(out)
        else:
            paths[key] = out
        gc.collect()
        log(f"phase {label} took {time.perf_counter() - t:.2f} s")
    log(f"phase 31: attention, tools and staging breakdown in "
        f"{time.perf_counter() - t0:.2f} s")
    return paths


#: Phase 32's ranks: two processes share the one card over gloo (NCCL
#: refuses two ranks on one GPU).
SPMD_RANKS = 2
#: Phase 32's deadline a launch (the phase must take under 120 s).
SPMD_DEADLINE_S = 150.0


def _spmd_reports(out: str, n: int) -> list:
    """The ranks' reports (a wedged rank writes none)."""
    reports = []
    for r in range(n):
        path = os.path.join(out, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as fh:
                reports.append(json.load(fh))
    return reports


def _spmd_launch(n: int, out: str, args: list, env=None,
                 phase: str = "32"):
    """``multihost_smoke``'s ranks (the port's launcher): fresh
    processes, never forked from this one, which holds a CUDA context."""
    from bigslice_tpu_torch.tools import multihost_smoke as ms

    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", "bigslice_tpu_torch.tools.multihost_smoke",
           "--worker", "--out", out] + args
    res = ms.launch(n, cmd, deadline_s=SPMD_DEADLINE_S, env=env)
    if res.rc != 0:
        raise AssertionError(
            f"phase {phase}: {n} rank(s) {args[:2]} exit {res.rcs} after "
            f"{res.seconds:.1f} s (timed out {res.timed_out}); stderr "
            f"tails: {[e[-2000:] for e in res.stderr]}")
    return res, _spmd_reports(out, n)


def phase32_spmd(card: str) -> dict:
    """32: ``spmd``, the device executor over 2 ranks on the one card.
    (a) reduce-wave at full width, the JAX package's ``bench.py``
    scenario (2**25 rows, keys uniform over 2**20 from RandomState(42))
    at S = 4 x N = 8 shards, so 4 waves a rank, through
    ``MeshExecutor(mesh=global_mesh(), auto_dense=False)``
    on both ranks over gloo (the card's tensors handed to gloo, which
    stages them through the host): one
    counted run and one warm one, every shard's rows
    against numpy and every row in the shard the plain K1 names, K1 and
    K2 launched on each rank, the registry digest equal on both; the
    mesh k-means step at phase 27e's shape (2**20 points, d = 128, k =
    1024) against a one-rank step on the same points. (b) one rank over
    NCCL on the card runs the exchange seam's own path (int32, uint32,
    bool planes) and a psum. (c) a wedged rank (its keepalive stopped):
    its peer raises PeerLostError before the next collective."""
    import tempfile

    t0 = time.perf_counter()
    # The ranks' own contexts share the card with this process's cache.
    gc.collect()
    torch.cuda.empty_cache()
    base = tempfile.mkdtemp(prefix="chip-spmd-")
    n = SPMD_RANKS
    rows, keyspace, S = 1 << 25, 1 << 20, 4 * SPMD_RANKS
    res, reps = _spmd_launch(n, os.path.join(base, "a"), [
        "--backend", "gloo", "--rows", str(rows), "--keyspace",
        str(keyspace), "--shards", str(S), "--warm", "1", "--points",
        str(KMEANS_N), "--dim", str(KMEANS_D), "--k", str(KMEANS_K),
        "--threads", str(max(1, (os.cpu_count() or 2) // n))])
    if len(reps) != n:
        raise AssertionError(f"phase 32a: {len(reps)} reports of {n}")
    launches = {name: 0 for name in PATH_KERNELS}
    for r in reps:
        if not r["ok"]:
            raise AssertionError(f"phase 32a: rank {r['rank']}: {r}")
        if r["jax_loaded"] or r["bigslice_tpu_loaded"]:
            raise AssertionError(f"phase 32a: rank {r['rank']} loaded JAX")
        for name in ("hash_partition", "hash_aggregate"):
            if r["launches"].get(name, 0) <= 0:
                raise AssertionError(f"phase 32a: rank {r['rank']} never "
                                     f"launched {name}: {r['launches']}")
        for name in PATH_KERNELS:
            launches[name] += r["launches"].get(name, 0)
    if len({r["digest"] for r in reps}) != 1:
        raise AssertionError(f"phase 32a: digests {[r['digest'] for r in reps]}")
    if len({tuple(r["shard_rows"]) for r in reps}) != 1 or sum(
            reps[0]["shard_rows"]) != len(np.unique(np.random.RandomState(
                42).randint(0, keyspace, rows))):
        raise AssertionError("phase 32a: ranks disagree on the rows")
    warm = [statistics.median(r["reduce_warm_s"]) for r in reps]
    log(f"phase 32a: spmd reduce-wave {rows} rows over {keyspace} keys, "
        f"S = {S} on {n} ranks of {card}: backend {reps[0]['backend']}, "
        f"{reps[0]['transport']} tensors handed to {reps[0]['backend']} "
        f"(gloo stages them through the host), "
        f"exchanged bytes a rank {[r['exchanged_bytes'] for r in reps]} "
        f"(counted run); per-rank counted walls "
        f"{[round(r['reduce_counted_s'], 4) for r in reps]} s, warm "
        f"medians {[round(w, 4) for w in warm]} s (runs "
        f"{[[round(x, 4) for x in r['reduce_warm_s']] for r in reps]}), "
        f"launches a rank {[r['launches'] for r in reps]}, collectives "
        f"{reps[0]['collectives']}, a warm run's host seconds inside them "
        f"{[{k: round(v, 4) for k, v in r['warm_collective_s'].items()} for r in reps]}, "
        f"hash_off {reps[0]['hash_off']}; "
        f"k-means step n={KMEANS_N} d={KMEANS_D} k={KMEANS_K} against one "
        f"rank: max abs err {[r['kmeans_max_abs_err'] for r in reps]}, "
        f"mesh step {[round(r['kmeans_mesh_s'], 4) for r in reps]} s; "
        f"ranks up to done {res.seconds:.2f} s")
    _, (nccl,) = _spmd_launch(1, os.path.join(base, "b"),
                              ["--mode", "nccl1"])
    if not nccl["ok"]:
        raise AssertionError(f"phase 32b: {nccl}")
    log(f"phase 32b: one rank over {nccl['backend']} on the card: the "
        f"exchange seam's path {nccl['checks']}")
    _, wedge = _spmd_launch(n, os.path.join(base, "c"), [
        "--mode", "wedge", "--backend", "gloo"],
        env={"BIGSLICE_KEEPALIVE_INTERVAL": "0.2",
             "BIGSLICE_KEEPALIVE_TIMEOUT": "1"})
    (w0,) = [r for r in wedge if r["rank"] == 0]
    if not w0["ok"]:
        raise AssertionError(f"phase 32c: {w0}")
    secs = time.perf_counter() - t0
    log(f"phase 32c: a wedged rank detected by its peer in "
        f"{w0['detect_s']:.2f} s (keepalive timeout {w0['timeout_s']} s), "
        f"the run refused with {w0['raised'][:160]}")
    log(f"phase 32: spmd in {secs:.2f} s on {card}")
    return {"spmd": dict(launches=launches, wall_s=statistics.median(warm),
                         counted_s=[r["reduce_counted_s"] for r in reps],
                         warm_s=[r["reduce_warm_s"] for r in reps],
                         exchanged_bytes=[r["exchanged_bytes"] for r in reps],
                         warm_collective_s=[r["warm_collective_s"]
                                            for r in reps],
                         backend=reps[0]["backend"],
                         transport=reps[0]["transport"],
                         kmeans_err=[r["kmeans_max_abs_err"] for r in reps],
                         nccl=nccl["checks"], wedge_detect_s=w0["detect_s"],
                         seconds=secs)}


#: Phase 33a's grid: 4 ranks sharing the card as BIGSLICE_MESH_SHAPE=2x2.
HIER_SHAPE, HIER_RANKS, HIER_SHARDS = "2x2", 4, 16


def _fleet_check(fleet_dir: str, merged: dict) -> dict:
    """Phase 33d: rank 0's fleet merge against the ranks' own exported
    snapshots, summed here independently of ``merge_snapshots``: each
    op's partition rows and task-duration histogram, the task states,
    and the device plane's counters."""
    from bigslice_tpu_torch.utils import fleettelemetry as fleet_mod

    snaps = fleet_mod.load_snapshots(fleet_dir)
    if sorted(s["rank"] for s in snaps) != list(range(HIER_RANKS)):
        raise AssertionError(f"phase 33d: snapshots of ranks "
                             f"{[s['rank'] for s in snaps]}")
    if merged["ranks"] != list(range(HIER_RANKS)):
        raise AssertionError(f"phase 33d: merged ranks {merged['ranks']}")
    states: dict = {}
    for s in snaps:
        for k, v in s["task_states"].items():
            states[k] = states.get(k, 0) + v
    if merged["task_states"] != states:
        raise AssertionError(f"phase 33d: task states "
                             f"{merged['task_states']} against the ranks' "
                             f"sum {states}")
    nops = 0
    for op, entry in merged["ops"].items():
        rows, buckets, count = [], None, 0
        for s in snaps:
            o = s["ops"].get(op)
            if o is None:
                continue
            pr = o["part_rows"]
            rows += [0] * (len(pr) - len(rows))
            for i, r in enumerate(pr):
                rows[i] += r
            h = o["durations"]
            buckets = (list(h["buckets"]) if buckets is None
                       else [a + b for a, b in zip(buckets, h["buckets"])])
            count += h["count"]
        if rows and entry["skew"]["rows"] != rows:
            raise AssertionError(f"phase 33d: {op} rows {entry['skew']}")
        if count and (entry["tasks"]["hist"]["buckets"] != buckets
                      or entry["tasks"]["n"] != count):
            raise AssertionError(f"phase 33d: {op} task histogram")
        nops += 1
    totals = merged["device"]["totals"]
    for key in ("compiles", "dcn_messages", "ici_bytes"):
        want = sum(o.get(key, 0) for s in snaps
                   for o in s["device"]["ops"].values())
        if totals[key] != want:
            raise AssertionError(f"phase 33d: device {key} {totals[key]} "
                                 f"against the ranks' sum {want}")
    return {"ops": nops, "task_states": states,
            "dcn_messages": totals["dcn_messages"],
            "dcn_bytes": totals["dcn_bytes"],
            "ici_bytes": totals["ici_bytes"]}


def phase33_plane(card: str) -> dict:
    """33: the rest of the multi-process plane on the one card, its
    ranks fresh processes sharing it over gloo. (a) ``hier``: phase 3's
    reduce-wave at full width (2**25 rows, keys uniform over 2**20 from
    RandomState(42)) on 4 ranks as ``BIGSLICE_MESH_SHAPE=2x2``,
    ``auto_dense=False``, S = 16, then on the flat mesh over the same
    4 ranks, then on the grid again (its first run pays the processes'
    first-use costs): every shard's rows against numpy and in the shard the plain
    K1 names, the two layouts' shards equal, K1 and K2 launched on each
    rank, each stage's bytes and host seconds. (b) ``hostdist``: phase
    17's word count (2**21 Zipf-like words, str keys) on 2 ranks against
    collections.Counter, each host task owned by exactly one rank, each
    rank's fetches exactly the remote partitions it read. (c)
    ``attend``: SelfAttend at phase 31a's shape (seq 2**13, 2 heads of
    128, causal) over the 2 ranks through the ring and Ulysses in fp32
    and bf16, against the float64 oracle at 31a's tolerances, each
    rank's stage timed. (d) ``fleet``: (a)'s ranks export to a
    FileStore directory; rank 0's merge equals the ranks' counters and
    histograms summed. (e) ``elastic``: one process, an injected
    ``peer.lost`` (seed 0, rate 0.5: the reduce side's dispatch, once)
    during reduce-wave at S = 8 with ``Session(elastic=1)``: exact rows,
    the lost group rerun over the salvaged map side. (f) ``aotcheck``:
    the sm_90a build of every ``csrc/*.cu`` with its registers and
    shared memory."""
    import tempfile

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.parallel import cuda_kernels as ck
    from bigslice_tpu_torch.tools import aotcheck
    from bigslice_tpu_torch.utils import faultinject

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    base = tempfile.mkdtemp(prefix="chip-plane-")
    launches = {name: 0 for name in PATH_KERNELS}
    # (a) and (d): the 2-D mesh against the flat one, and the fleet.
    rows, keyspace = 1 << 25, 1 << 20
    fleet_dir = os.path.join(base, "fleet")
    ta = time.perf_counter()
    res, reps = _spmd_launch(HIER_RANKS, os.path.join(base, "a"), [
        "--mode", "hier", "--backend", "gloo", "--rows", str(rows),
        "--keyspace", str(keyspace), "--shards", str(HIER_SHARDS),
        "--fleet-dir", fleet_dir, "--threads",
        str(max(1, (os.cpu_count() or 4) // HIER_RANKS))],
        env={"BIGSLICE_MESH_SHAPE": HIER_SHAPE}, phase="33a")
    if len(reps) != HIER_RANKS or not all(r["ok"] for r in reps):
        raise AssertionError(f"phase 33a: {reps}")
    for r in reps:
        for name in ("hash_partition", "hash_aggregate"):
            if r["hier"]["launches"].get(name, 0) <= 0:
                raise AssertionError(f"phase 33a: rank {r['rank']} never "
                                     f"launched {name} on the grid")
        for name in PATH_KERNELS:
            launches[name] += r["hier"]["launches"].get(name, 0)
    if len({tuple(r["hier"]["digests"]) for r in reps}) != 1:
        raise AssertionError("phase 33a: ranks disagree on the rows")
    for lay in ("hier", "flat", "hier-warm"):
        log(f"phase 33a: {lay} reduce-wave {rows} rows over {keyspace} "
            f"keys, S = {HIER_SHARDS} on {HIER_RANKS} ranks "
            f"({'flat' if lay == 'flat' else HIER_SHAPE}) of {card}: "
            f"counted walls {[round(r[lay]['wall_s'], 4) for r in reps]} s, "
            f"bytes a rank by axis {[r[lay]['axis_bytes'] for r in reps]} "
            f"(exchanged {[r[lay]['exchanged_bytes'] for r in reps]}), "
            f"host seconds in each collective a rank "
            f"{[{k: round(v, 4) for k, v in r[lay]['collective_s'].items()} for r in reps]}, "
            f"launches a rank {[r[lay]['launches'] for r in reps]}, "
            f"hash_off {reps[0][lay]['hash_off']}")
    log(f"phase 33a: every shard's rows equal numpy, in the shard K1 "
        f"names, and equal between the 2x2 grid and the flat ranks; "
        f"ranks up to done {res.seconds:.2f} s "
        f"({time.perf_counter() - ta:.2f} s with the launch), on {card}")
    with open(os.path.join(base, "a", "fleet_merged.json")) as fh:
        merged = json.load(fh)
    fleet = _fleet_check(fleet_dir, merged)
    log(f"phase 33d: rank 0's fleet merge of {HIER_RANKS} snapshots equals "
        f"their sum: {fleet['ops']} ops (partition rows, duration "
        f"histograms), task states {fleet['task_states']}, DCN messages "
        f"{fleet['dcn_messages']} ({fleet['dcn_bytes']} bytes), ICI bytes "
        f"{fleet['ici_bytes']}, on {card}")
    # (b) and (c): the host tier and the attend stage over 2 ranks.
    corpus = os.path.join(base, "corpus.txt")
    wordcount_corpus(corpus)
    cols, ref = _att_inputs(ATT_SEQ, 31)
    att = os.path.join(base, "att.npz")
    np.savez(att, q=cols[0], k=cols[1], v=cols[2])
    gc.collect()
    tb = time.perf_counter()
    res, reps = _spmd_launch(SPMD_RANKS, os.path.join(base, "b"), [
        "--mode", "plane", "--backend", "gloo", "--corpus", corpus,
        "--att", att, "--threads",
        str(max(1, (os.cpu_count() or 2) // SPMD_RANKS))], phase="33b")
    if len(reps) != SPMD_RANKS or not all(r["ok"] for r in reps):
        raise AssertionError(f"phase 33b: {reps}")
    log(f"phase 33b: hostdist word count of {WC_LINES * WC_WORDS_A_LINE} "
        f"words over {SPMD_RANKS} ranks of {card}: equal to "
        f"collections.Counter, {reps[0]['host_tasks']} host tasks each run "
        f"on one rank (owned {[r['owned'] for r in reps]}), fetched "
        f"partitions {[r['fetched'] for r in reps]} (exactly the remote "
        f"ones each rank read), walls "
        f"{[round(r['wordcount_s'], 4) for r in reps]} s")
    attend = {}
    for name in reps[0]["attend"]:
        method, dt = name.split("-")
        out = np.load(os.path.join(base, "b", f"attend-{name}.npy"))
        err, rel = _att_check(f"phase 33c {name}", out, ref, ATT_TOL[dt],
                              ATT_REL[dt])
        stage = [r["attend"][name]["stage_ms"] for r in reps]
        walls = [r["attend"][name]["wall_s"] for r in reps]
        attend[name] = dict(max_abs_err=err, rel_err=rel, stage_ms=stage,
                            wall_s=walls)
        if {r["attend"][name]["method"] for r in reps} != {method}:
            raise AssertionError(f"phase 33c: {name} ran "
                                 f"{[r['attend'][name] for r in reps]}")
        log(f"phase 33c: SelfAttend {name} seq {ATT_SEQ}, {ATT_HEADS} heads "
            f"of {ATT_HD}, causal, over {SPMD_RANKS} ranks of {card}: "
            f"max |err| {err:.3e} (tol {ATT_TOL[dt]}), relative "
            f"{rel:.3e} (limit {ATT_REL[dt]}), stage ms a rank "
            f"{[round(x, 4) for x in stage]} (CUDA events, median of 3), "
            f"run walls {[round(w, 4) for w in walls]} s")
    log(f"phase 33b/c: ranks up to done {res.seconds:.2f} s "
        f"({time.perf_counter() - tb:.2f} s with the launch), collectives "
        f"rank 0 {reps[0]['collectives']}")
    del cols, ref
    # (e) elastic, in this process.
    keys = np.random.RandomState(42).randint(0, keyspace, rows).astype(
        np.int32)
    want = np.bincount(keys, minlength=keyspace)
    events = []
    ck.reset_launches()
    plan = faultinject.install(faultinject.parse_plan("0:peer.lost=0.5x1"))
    te = time.perf_counter()
    try:
        ex = bs.MeshExecutor(auto_dense=False)
        sess = bs.Session(executor=ex, elastic=1,
                          eventer=lambda name_, **f: events.append(name_))
        got = bs.result_shard_rows(sess.run(bs.Reduce(
            bs.Const(8, keys, np.ones(rows, np.int32)),
            lambda a, b: a + b)))
    finally:
        faultinject.clear()
    elastic_s = time.perf_counter() - te
    el_launches = dict(ck.LAUNCHES)
    snap = plan.snapshot()
    k = np.concatenate([g[0] for g in got])
    v = np.concatenate([g[1] for g in got])
    if not (len(k) == int((want > 0).sum()) and bool((want[k] == v).all())):
        raise AssertionError("phase 33e: rows differ from numpy")
    if (snap["injected"] != {"peer.lost": 1} or snap["log"][0]["inv_id"] != 1
            or "bigslice:elasticRetry" not in events
            or ex.device_group_count() != 2):
        raise AssertionError(f"phase 33e: injected {snap['injected']}, "
                             f"events {events}, groups "
                             f"{ex.device_group_count()}")
    for name in PATH_KERNELS:
        launches[name] += el_launches.get(name, 0)
    sess.shutdown()
    del sess, ex, got, keys
    log(f"phase 33e: elastic reduce-wave {rows} rows, S = 8, one process on "
        f"{card}: peer.lost injected at the reduce side's dispatch "
        f"({snap['calls']['peer.lost']} checks), the map side salvaged to "
        f"the host and the reduce side rerun, rows exact, in "
        f"{elastic_s:.4f} s with the recovery; launches {el_launches}")
    # (f) the sm_90a build check.
    report = aotcheck.check(os.path.join(base, "aot.json"))
    for src, entry in report["sources"].items():
        if not entry["kernels"]:
            raise AssertionError(f"phase 33f: {src} has no kernel")
        for kname, kk in entry["kernels"].items():
            log(f"phase 33f: sm_90a {src} {kname}: {kk.get('registers')} "
                f"registers, {kk.get('shared_bytes')} B shared, "
                f"{kk.get('local_bytes')} B local, spills "
                f"{kk.get('spill_store_bytes', 0)}/"
                f"{kk.get('spill_load_bytes', 0)} B, on {card}")
    log(f"phase 33f: aotcheck built {len(report['sources'])} sources in "
        f"{report['seconds']} s")
    secs = time.perf_counter() - t0
    log(f"phase 33: multi-process plane in {secs:.2f} s on {card}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"multiprocess-plane": dict(
        launches=launches, attend=attend, fleet=fleet, elastic_s=elastic_s,
        aot=report["sources"], seconds=secs)}


#: Phase 34b: reduce-wave's widths with a vector payload.
VECTOR_NARROW_ROWS, VECTOR_NARROW_SPAN, VECTOR_NARROW_G = 1 << 23, 1 << 20, 8
#: Phase 34a's tolerance: a key's float32 sum against float64, as a share
#: of the absolute sum of its summands (the map side's atomics and the
#: reduce side add in arrival order).
VECTOR_RTOL = 1e-4


def _vector_sums(keys, vals):
    """Per-key sums of [n, G] rows on the host: ``(present keys, sums,
    absolute sums)``, sums in float64 for float rows and int64 else."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    acc = np.float64 if vals.dtype.kind == "f" else np.int64
    v = vals[order].astype(acc)
    sums = np.add.reduceat(v, starts, axis=0)
    abs_sums = np.add.reduceat(np.abs(v), starts, axis=0)
    return k[starts], sums, abs_sums


def _vector_check(label, keys, vals, exact):
    """A check for ``drive``: the result's rows against ``_vector_sums``
    (exact, or within ``VECTOR_RTOL`` of the absolute sums), each row in
    the shard K1 names, and no op on the sort path."""
    import bigslice_tpu_torch as bs

    want_k, want_v, want_abs = _vector_sums(keys, vals)

    def check(sess, res):
        off = sess.executor.hash_off
        if off:
            raise AssertionError(f"{label}: ops on the sort path: {off}")
        shards = bs.result_shard_rows(res)
        k = np.concatenate([s[0] for s in shards])
        v = np.concatenate([s[1] for s in shards])
        o = np.argsort(k)
        if not np.array_equal(k[o], want_k) or v.shape != want_v.shape:
            raise AssertionError(f"{label}: keys or shapes differ")
        if exact:
            if not np.array_equal(v[o].astype(np.int64), want_v):
                raise AssertionError(f"{label}: sums differ from numpy")
            note = ", rows exact"
        else:
            err = np.abs(v[o].astype(np.float64) - want_v)
            if not np.all(err <= VECTOR_RTOL * want_abs):
                raise AssertionError(
                    f"{label}: sums off by {(err / want_abs).max():.3e} of "
                    f"their absolute sums (limit {VECTOR_RTOL})")
            note = (f", largest error {(err / want_abs).max():.3e} of the "
                    f"absolute sums")
        _shard_keys_routed(shards, len(shards))
        return f"{note}, hash_off empty"

    return check


def phase34_vector_reduce(card: str) -> dict:
    """34: an undeclared vector-value ``Reduce`` on K2 at full width.
    (a) the k-means point sums of phase 27e's points (2**20 x 128
    float32, 512 MiB) over keys in [0, 1024) from default_rng(34), S =
    4; (b) 2**23 rows over 2**20 keys (RandomState(42), reduce-wave's
    widths) with int32 [n, 8]
    values in [-1000, 1000) from RandomState(34), about 300 MB, S = 4.
    Both ``MeshExecutor(auto_dense=False)``, every row checked."""
    import bigslice_tpu_torch as bs

    t0 = time.perf_counter()
    S = 4
    pts = _kmeans_points()
    n = len(pts)
    kkeys = np.random.default_rng(34).integers(0, 1024, n).astype(np.int32)

    def add(a, b):
        return a + b

    out = {}
    out["vector-wide"] = drive(
        "34a", "vector-wide (k-means point sums, [n, 128] float32)",
        lambda: bs.Reduce(bs.Const(S, kkeys, pts), add),
        _vector_check("34a", kkeys, pts, exact=False),
        ("hash_partition", "hash_aggregate"), n, card, auto_dense=False)
    del pts, kkeys
    gc.collect()
    nkeys, _ = _reduce_wave_input(VECTOR_NARROW_ROWS, VECTOR_NARROW_SPAN)
    vals = np.random.RandomState(34).randint(
        -1000, 1000, (VECTOR_NARROW_ROWS, VECTOR_NARROW_G)).astype(np.int32)
    out["vector-narrow"] = drive(
        "34b", "vector-narrow (reduce-wave widths, [n, 8] int32)",
        lambda: bs.Reduce(bs.Const(S, nkeys, vals), add),
        _vector_check("34b", nkeys, vals, exact=True),
        ("hash_partition", "hash_aggregate"), VECTOR_NARROW_ROWS, card,
        auto_dense=False)
    del nkeys, vals
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 34: vector-value Reduce on K2 in "
        f"{time.perf_counter() - t0:.2f} s on {card}")
    return out


def nbytes_of(*arrays) -> int:
    return int(sum(a.nbytes for a in arrays))


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the measurements to OUT/chip_smoke.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = torch.device("cuda")
    # Each phase's wall, logged at the end: where the script's time goes.
    walls = {}

    def timed(label, fn, *fargs):
        t = time.perf_counter()
        out = fn(*fargs)
        walls[label] = round(time.perf_counter() - t, 2)
        return out

    card = phase0_card()
    timed("1", phase1_build)
    kern = timed("2", phase2_kernels, device)
    slice_ = timed("3", phase3_slice, card)
    mesh_shards = slice_.pop("shards")
    paths = {"reduce-wave": slice_,
             "lww-wave": timed("4", phase4_lww, card),
             "float-key": timed("5", phase5_float_key, card),
             "overflow-fallback": timed("6", phase6_overflow, card),
             "sortshuffle": timed("7", phase7_sortshuffle, card),
             "join": timed("8", phase8_join, card),
             "join-sort": timed("9", phase9_join_sort, card),
             "groupby": timed("10", phase10_groupby, card)}
    paths["pipeline"] = timed("11", phase11_pipeline, card)
    paths["budget-split"] = timed("12", phase12_budget_split, card,
                                  slice_["peak_gib"])
    paths["spill"] = timed("13", phase13_spill, card)
    paths["cogroup-join"] = timed("14", phase14_cogroup_join, card)
    paths["cogroup-hotkey"] = timed("15", phase15_cogroup_hotkey, card)
    paths["local-reduce"] = timed("16", phase16_local_reduce, card,
                                  mesh_shards)
    paths["wordcount"] = timed("17", phase17_wordcount, card)
    wc_shards = paths["wordcount"].pop("shards")
    paths.update(timed("18", phase18_fold, card))
    paths["fold-hotkey"] = timed("19", phase19_fold_hotkey, card)
    paths.update(timed("20", phase20_func_api, card))
    paths.update(timed("21", phase21_dense, card, device))
    paths.update(timed("22", phase22_host_fallback, card, wc_shards))
    del wc_shards
    paths.update(timed("23", phase23_urls, card))
    paths["dict-wordcount"] = timed(
        "24", phase24_dict_wordcount, card, paths["wordcount"],
        paths["fallback-wordcount"])
    paths.update(timed("25", phase25_cache, card, mesh_shards))
    del mesh_shards
    paths["observability"] = timed("26", phase26_observability, card, kern)
    paths.update(timed("27", phase27_data_plane, card))
    paths["kmeans"] = timed("27e", phase27_kmeans, card)
    paths.update(timed("28", phase28_robustness, card))
    paths.update(timed("29", phase29_operator_plane, card,
                       paths["reduce-wave"]["launches"]))
    paths.update(timed("30", phase30_serving, card, dict(
        paths["reduce-wave"]["launches"],
        wall_s=paths["reduce-wave"]["wall_s"])))
    paths.update(timed("31", phase31_attention, card))
    paths.update(timed("32", phase32_spmd, card))
    paths.update(timed("33", phase33_plane, card))
    paths.update(timed("34", phase34_vector_reduce, card))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
            json.dump({"card": card, "kernels": kern, "paths": paths}, fh,
                      indent=1)
    # Launches: the counted runs of every path, summed, and by path.
    line = {"kernels": [
        dict(name=name, route="cuda", source=SOURCES[name],
             replaces=REPLACES[name],
             launches=sum(p["launches"][name] for p in paths.values()),
             launches_by_path={k: p["launches"][name]
                               for k, p in paths.items()},
             match=True, **{k: kern[name][k] for k in LINE_KEYS})
        for name in PATH_KERNELS
    ]}
    log(f"chip_smoke: phase walls s {walls}")
    log(f"chip_smoke: phases 0-34 in {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
