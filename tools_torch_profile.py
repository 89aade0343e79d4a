"""Where the time goes in the PyTorch port's runs on one GPU.

    python3 tools_torch_profile.py
        [--path reduce-wave|lww-wave|join|join-sort|groupby|
                cogroup-join|cogroup-hotkey]
        [--prefetch-depth N] [--spill] [--auto-dense on|off] [--out DIR]
    python3 tools_torch_profile.py --executor local
        [--path reduce-wave|wordcount] [--procs N] [--out DIR]

``reduce-wave`` (the default) runs Session().run(Reduce(Const(4, keys,
ones), add)) at the shape of the JAX package's reduce-wave scenario
(2**25 rows, keys uniform over 2**20 from RandomState(42)); ``lww-wave``
runs chip_smoke.py's phase-4 chain at the same shape: Map (keys folded
to 2**20), Filter (a timestamp watermark) and a Reduce keeping the
latest record per key, on the sort lowering; ``join``, ``join-sort``
and ``groupby`` run chip_smoke.py's phases 8-10 on their inputs (the
JAX package's ``bench.py join`` scenario, two sides of 2**23 keys, on
the hash join and on the tagged-sort alignment; a Map over
GroupByKey(capacity=64) of 2**22 rows); ``cogroup-join`` and
``cogroup-hotkey`` run chip_smoke.py's phases 14-15 (a two-input
Cogroup of 2 x 2**22 rows; a one-input Cogroup of 2**20 rows with a
4096-row group). The executor runs the wave
pipeline at ``--prefetch-depth`` (default 1, the executor's default;
0 is the serial loop), and with ``--spill`` every shuffle boundary
takes the spill exchange (``BIGSLICE_SHUFFLE=spill``). ``--auto-dense``
(default on, the executor's default) sets the executor's auto-dense
discovery: on, reduce-wave's producer discovers its keys dense, so its
map side takes the sort combine-shuffle and its reduce side the dense
table; off keeps K2 on both sides. Each path runs once to warm up,
then:

1. a layer breakdown: host wall time of each executor layer closed by
   torch.cuda.synchronize() on the group thread (wave dispatch, settle,
   cross-wave merge, subid split, result readback) and, inside them,
   of the sort lowering's parts (the sort, the segmented scan), the
   kernels' wrappers, the join stage (its claim cascade inside it), the
   Cogroup's aligner (its sort inside it) and decode, and the Cogroup
   capacities.
   Staging is read from the executor's own clock, never synchronized
   (its prefetcher thread overlaps the programs): all of it, the part
   the group threads waited for (exposed) and the rest (hidden). The
   two sides of a join run their producer groups on two threads, so
   there the layers overlap and their sum exceeds the wall;
2. the host syncs of one run, counted by torch's sync debug mode (each
   operation that waits for the device: a nonzero, an item, a copy to
   the host), by message; among them the auto-dense key-range probes
   (``MeshExecutor._key_range``: one readback a group's first wave);
3. one run under torch.profiler: device time by kernel, total device
   busy time and the device's idle share of the run's wall time, and
   the device time of each hand-written kernel's wrapper (K2's passes
   summed) and of torch's sort kernels.

With ``--executor local`` the path runs through ``LocalExecutor()``
(``--procs`` task threads, default its own) instead: ``reduce-wave`` is
chip_smoke.py's phase 16 (``wordcount_ids(4, keys, 2**20)``), and
``wordcount`` its phase 17 (the word count over the generated corpus of
2**21 words). The layer breakdown is then the local executor's, each
layer's own time (a layer nested in another is subtracted from it):
placement (``Frame.to``: host-to-device copies), map-side routing
(``Frame.partition_ids``, K1 for device keys, the host CRC for str
keys), ``partition_frame``, the map-side pre-combine and the
reduce-side combine (``FrameCombiner.combine`` in a producer task and in
a consumer task), the host functions (the readers of host-tier Map and
Flatmap), the store (``put`` and ``read``) and the readback. With
several task threads the layers overlap and their sum exceeds the
wall; ``--procs 1`` gives a serial breakdown.

Prints all three, with the card's name and power limit, and writes the
profiler table to DIR/profile.txt (default profile_out). Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import functools
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--path", default="reduce-wave",
                    choices=("reduce-wave", "lww-wave", "join",
                             "join-sort", "groupby", "cogroup-join",
                             "cogroup-hotkey", "wordcount"))
    ap.add_argument("--executor", default="mesh", choices=("mesh", "local"))
    ap.add_argument("--procs", type=int, default=None,
                    help="the local executor's task threads")
    ap.add_argument("--prefetch-depth", type=int, default=1)
    ap.add_argument("--spill", action="store_true",
                    help="run every shuffle boundary through the spill "
                         "exchange (BIGSLICE_SHUFFLE=spill)")
    ap.add_argument("--auto-dense", default="on", choices=("on", "off"),
                    help="the device executor's auto-dense discovery")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tools_torch_profile: needs a GPU", file=sys.stderr)
        return 2
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec import meshexec
    from bigslice_tpu_torch.parallel import cogroup as cogroup_mod
    from bigslice_tpu_torch.parallel import cuda_kernels, hashagg, segment

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    n, S = 1 << 25, 4
    rng = np.random.RandomState(42)
    if args.path == "wordcount" and args.executor != "local":
        ap.error("--path wordcount needs --executor local")
    tmp = None
    if args.path == "reduce-wave":
        from bigslice_tpu_torch.models.wordcount import wordcount_ids

        keys = rng.randint(0, 1 << 20, n).astype(np.int32)
        ones = np.ones(n, np.int32)

        def make():
            if args.executor == "local":
                return wordcount_ids(S, keys, 1 << 20)
            return bs.Reduce(bs.Const(S, keys, ones), lambda a, b: a + b)
    elif args.path == "wordcount":
        import tempfile

        import chip_smoke
        from bigslice_tpu_torch.models.wordcount import wordcount

        tmp = tempfile.mkdtemp(prefix="profile-wordcount-")
        corpus = os.path.join(tmp, "corpus.txt")
        n = len(chip_smoke.wordcount_corpus(corpus))

        def make():
            return wordcount(S, corpus)
    elif args.path in ("join", "join-sort"):
        import chip_smoke

        ak, bk = chip_smoke._join_keys()
        av = bv = np.ones(len(ak), np.int32)
        fb = lambda a, b: a + b  # noqa: E731
        if args.path == "join-sort":
            av, bv = chip_smoke._join_sort_values()
            fb = lambda a, b: a ^ b  # noqa: E731
        n = 2 * len(ak)

        def make():
            return bs.JoinAggregate(bs.Const(S, ak, av), bs.Const(S, bk, bv),
                                    lambda a, b: a + b, fb)
    elif args.path == "groupby":
        import chip_smoke

        keys, vals = chip_smoke._groupby_input()
        n = len(keys)

        def make():
            g = bs.GroupByKey(bs.Const(S, keys, vals), capacity=64)
            return bs.Map(g, lambda k, grp, cnt: (k, grp.sum(), cnt))
    elif args.path == "cogroup-join":
        import chip_smoke

        (ak, av), (bk, bv) = chip_smoke._cogroup_join_inputs()
        n = len(ak) + len(bk)

        def make():
            return bs.Cogroup(bs.Const(S, ak, av), bs.Const(S, bk, bv))
    elif args.path == "cogroup-hotkey":
        import chip_smoke

        keys, vals = chip_smoke._cogroup_hotkey_input()
        n = len(keys)

        def make():
            return bs.Cogroup(bs.Const(S, keys, vals))
    else:
        keys = rng.randint(0, 1 << 24, n).astype(np.int32)
        ts = rng.permutation(n).astype(np.int32)
        vals = rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32)

        def make():
            s = bs.Map(bs.Const(S, keys, ts, vals),
                       lambda k, t, v: (k & 0xFFFFF, t, v))
            s = bs.Filter(s, lambda k, t, v: t >= 1 << 22)
            return bs.Reduce(s, lambda a, b: (
                torch.maximum(a[0], b[0]),
                torch.where(a[0] >= b[0], a[1], b[1])))

    if args.spill:
        os.environ["BIGSLICE_SHUFFLE"] = "spill"
    executors = []

    def run():
        if args.executor == "local":
            ex = bs.LocalExecutor(procs=args.procs)
        else:
            ex = bs.MeshExecutor(prefetch_depth=args.prefetch_depth,
                                 auto_dense=args.auto_dense == "on")
        executors.append(ex)
        sess = bs.Session(executor=ex)
        res = sess.run(make())
        for shard in range(S):
            list(res.reader(shard, ()))
        sess.shutdown()

    run()
    torch.cuda.synchronize()
    if args.executor == "local":
        setting = f"LocalExecutor, procs {executors[-1].procs}"
        try:
            local_layers(run, args.path, n, S, setting, card)
            syncs_and_device_time(run, setting, card, args.out)
        finally:
            if tmp is not None:
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
        return 0
    setting = (f"prefetch depth {args.prefetch_depth}, auto-dense "
               f"{args.auto_dense}"
               + (", spill exchange" if args.spill else ""))

    # 1. Layer breakdown: wrap the executor's layer methods with
    # synchronized host timers.
    spent = collections.defaultdict(float)
    calls = collections.Counter()
    E = meshexec.MeshExecutor
    layers = {
        (E, "_dispatch_wave"): "wave program (route, combine, compact)",
        (E, "_settle_wave"): "settle (signals, slack/hash reruns)",
        (E, "_key_range"): "  of dispatch: auto-dense key-range probe",
        (segment, "sort_permutation"): "  of it: sort (packing, torch.sort)",
        (segment, "segmented_combine"): "  of it: segmented scan",
        (cuda_kernels, "hash_partition"): "  of it: K1 hash_partition wrapper",
        (cuda_kernels, "hash_aggregate"): "  of it: K2 hash_aggregate wrapper",
        (E, "_join_prelude"): "  of it: join stage (align)",
        (hashagg, "claim_cascade"): "  of it: claim cascade (hash join)",
        (cogroup_mod, "make_cogroup_align"):
            "  of it: cogroup align (sort, ranks, scatter)",
        (E, "_build_wave_views"): "  of staging: subid split for consumers",
        (E, "_merge_outputs"): "cross-wave merge",
        (E, "_frames_by_name"): "result readback to host",
        (cogroup_mod, "ragged_from_padded"): "  of it: decode to lists",
    }
    # Factories whose returned function is the layer.
    factories = {(cogroup_mod, "make_cogroup_align")}
    originals = {}
    for (owner, name), label in layers.items():
        orig = getattr(owner, name)
        originals[owner, name] = orig

        def timed(*a, _orig=orig, _key=label, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _orig(*a, **k)
            torch.cuda.synchronize()
            spent[_key] += time.perf_counter() - t0
            calls[_key] += 1
            return out

        def factory(*a, _orig=orig, _timed=timed, **k):
            return functools.partial(_timed, _orig=_orig(*a, **k))

        wrap = factory if (owner, name) in factories else timed
        setattr(owner, name, functools.wraps(orig)(wrap))
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    for (owner, name), orig in originals.items():
        setattr(owner, name, orig)
    clock = executors[-1].staging_seconds()
    print(f"layer breakdown, {args.path} {n} rows, S={S}, {setting}, on "
          f"{card}: wall {wall:.4f} s (synchronized per layer)")
    print(f"  {'staging (read shards, assemble, copy)':45s} "
          f"{clock['staged_s']:.4f} s in {clock['waves']} wave(s): exposed "
          f"{clock['exposed_s']:.4f} s, hidden {clock['hidden_s']:.4f} s")
    for label in layers.values():
        print(f"  {label:45s} {spent[label]:.4f} s in {calls[label]} "
              f"call(s)")
    top_level = [label for label in layers.values()
                 if not label.startswith(" ")]
    other = wall - clock["exposed_s"] - sum(spent[k] for k in top_level)
    print(f"  {'other (planning, evaluator, threads)':45s} "
          + (f"{other:.4f} s" if other >= 0 else
             "not measured (concurrent groups' layers overlap)"))
    if executors[-1].cogroup_caps:
        print(f"  cogroup caps: {executors[-1].cogroup_caps}")

    syncs_and_device_time(run, setting, card, args.out)
    return 0


def local_layers(run, path, n, S, setting, card) -> None:
    """The local executor's layer breakdown of one ``run()``: each
    layer's own time, synchronized at its ends, with the layers nested
    in it subtracted."""
    import threading

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec import local, store
    from bigslice_tpu_torch.frame.frame import Frame
    from bigslice_tpu_torch.ops import mapops
    from bigslice_tpu_torch.ops.reduce import FrameCombiner
    from bigslice_tpu_torch.ops.source import ScanReader

    spent = collections.defaultdict(float)
    calls = collections.Counter()
    tls = threading.local()

    def combine_label(_args):
        task = getattr(tls, "task", None)
        if task is not None and task.num_partition > 1:
            return "map-side pre-combine (producer tasks)"
        return "reduce-side combine (consumer tasks)"

    L = local.LocalExecutor
    layers = [
        (L, "_execute", "task bodies (every layer below)"),
        (Frame, "to", "placement (Frame.to, host to device)"),
        (Frame, "partition_ids", "map-side routing (K1 / host CRC)"),
        (local, "partition_frame", "partition_frame (sort, split)"),
        (FrameCombiner, "combine", combine_label),
        (mapops.Map, "reader", "host Map (per row)"),
        (mapops.Flatmap, "_read_host", "host Flatmap (per row)"),
        (ScanReader, "reader", "source (ScanReader lines)"),
        (store.MemoryStore, "put", "store put"),
        (store.MemoryStore, "read", "store read"),
        (bs.Result, "reader", "result readback"),
    ]
    generators = {(mapops.Map, "reader"), (mapops.Flatmap, "_read_host"),
                  (ScanReader, "reader"), (bs.Result, "reader")}
    originals = {}

    def timed_call(fn, label, a, k):
        if callable(label):
            label = label(a)
        stack = tls.__dict__.setdefault("stack", [])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stack.append(0.0)
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            nested = stack.pop()
            spent[label] += dt - nested
            calls[label] += 1
            if stack:
                stack[-1] += dt

    for owner, name, label in layers:
        orig = getattr(owner, name)
        originals[owner, name] = orig
        if (owner, name) in generators:
            def wrap(*a, _orig=orig, _label=label, **k):
                gen = _orig(*a, **k)

                def stepped():
                    while True:
                        try:
                            f = timed_call(next, _label, (gen,), {})
                        except StopIteration:
                            return
                        yield f
                return stepped()
        elif name == "_execute":
            def wrap(self, task, _orig=orig, _label=label):
                tls.task = task
                try:
                    return timed_call(_orig, _label, (self, task), {})
                finally:
                    tls.task = None
        else:
            def wrap(*a, _orig=orig, _label=label, **k):
                return timed_call(_orig, _label, a, k)
        setattr(owner, name, functools.wraps(orig)(wrap))
    try:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    finally:
        for (owner, name), orig in originals.items():
            setattr(owner, name, orig)
    print(f"layer breakdown, {path} {n} rows, S={S}, {setting}, on {card}: "
          f"wall {wall:.4f} s (each layer synchronized; own time, nested "
          f"layers subtracted)")
    for label in sorted(spent, key=lambda k: -spent[k]):
        print(f"  {label:45s} {spent[label]:.4f} s in {calls[label]} "
              f"call(s)")


def syncs_and_device_time(run, setting, card, out) -> None:
    """Host syncs of one run (torch's sync debug mode) and device time
    by kernel of one run under torch.profiler."""
    # 2. Host syncs: every operation that waits for the device warns
    # under the sync debug mode. The auto-dense probes are counted
    # apart: one readback each.
    from bigslice_tpu_torch.exec import meshexec

    E = meshexec.MeshExecutor
    key_range = E._key_range
    probes = [0]

    def counted(*a, **k):
        probes[0] += 1
        return key_range(*a, **k)

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        E._key_range = counted
        try:
            run()
        finally:
            E._key_range = key_range
            torch.cuda.set_sync_debug_mode("default")
    # Each by the line of Python that waited (the warning's frame).
    syncs = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    print(f"host syncs in one run ({setting}): {sum(syncs.values())}, of "
          f"them {probes[0]} auto-dense key-range probe(s), one readback "
          f"each")
    for where, count in syncs.most_common(12):
        print(f"  {count:6d}x  {where}")

    # 3. Device time by kernel under torch.profiler.
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    dev_us = sum(getattr(e, attr) for e in events)
    table = events.table(sort_by=attr,
                         row_limit=25)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile.txt"), "w") as fh:
        fh.write(f"{card}\n{table}\n")
    top = sorted(events, key=lambda e: -getattr(e, attr))[:12]
    print(f"profiled run: wall {pwall:.4f} s, device busy "
          f"{dev_us / 1e6:.4f} s, idle share "
          f"{1 - dev_us / 1e6 / pwall:.4f}" if dev_us else
          "profiled run: no device time recorded (not measured)")
    for e in top:
        print(f"  {getattr(e, attr) / 1e3:10.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")
    # The hand-written kernels by wrapper: K2 runs several device kernels
    # (its passes, all named agg_*) per wrapper call.
    for label, pattern in (("hash_aggregate (all passes)", r"\bagg_\w+"),
                           ("hash_partition", r"\bhash_partition_kernel"),
                           ("torch sort kernels", r"(?i)radix|sort")):
        mine = [e for e in events if re.search(pattern, e.key)]
        print(f"  {label}: {sum(getattr(e, attr) for e in mine) / 1e3:.3f} "
              f"ms device time, "
              + ", ".join(f"{e.key.split('(')[0]} {e.count}x "
                          f"{getattr(e, attr) / 1e3:.3f} ms" for e in mine))
    print(f"card: {card}")


if __name__ == "__main__":
    sys.exit(main())
