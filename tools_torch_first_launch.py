"""Time a fresh process's first launch of K1 and K2 on the card.

    python3 tools_torch_first_launch.py [--rows N] [--tag NAME]

Builds (or loads) the kernel library and runs the build probe, then
queues a busy-wait of about 0.1 s on the current stream and calls the
K1 wrapper (``cuda_kernels.hash_partition``) behind it, then the same
for K2 (``cuda_kernels.hash_aggregate``), then both again. For each
call it prints the host milliseconds the wrapper took to return and
whether the busy-wait had finished by then: a launch that waits for the
device returns only after the busy-wait, about 100 ms later; one that
does not returns in well under a millisecond. Under CUDA's lazy module
loading a kernel's first launch in a process loads its module and waits
(ROADMAP C2.19). The last line is one JSON object with every figure,
the card's name and power limit (``nvidia-smi``) and the tag.

Run it in a fresh process for each reading: the first launch is a
once-a-process event. To compare two trees, run the script from each
(``PYTHONPATH`` set to the tree) in turns within one call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

#: GPU cycles of the busy-wait behind each timed call (about 0.1 s).
SLEEP_CYCLES = 200_000_000


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _timed_behind_sleep(fn) -> dict:
    """Queue the busy-wait, call ``fn()``, and read whether the
    busy-wait had finished when ``fn`` returned."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    slept = torch.cuda.Event()
    slept.record()
    t0 = time.perf_counter()
    fn()
    ms = (time.perf_counter() - t0) * 1e3
    waited = slept.query()
    torch.cuda.synchronize()
    return {"ms": round(ms, 4), "waited": bool(waited)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("first_launch: no CUDA device is available", file=sys.stderr)
        return 2
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    t0 = time.perf_counter()
    if not ck.kernels_available():
        raise RuntimeError("the kernels did not build or the probe failed")
    ready_s = time.perf_counter() - t0
    n = args.rows
    rng = np.random.RandomState(5)
    key = torch.from_numpy(rng.randint(0, 1 << 18, n).astype(np.int32)).cuda()
    one = torch.ones_like(key)
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    part = ck.hash_partition_plain([key], 4, 0, with_counts=False,
                                   valid=valid)[0]
    torch.cuda.synchronize()

    def k1():
        ck.hash_partition([key], 4, 0, with_counts=False, valid=valid)

    def k2():
        ck.hash_aggregate(valid, [key], [one], ["add"], part, 4, 1 << 17)

    out = {"tag": args.tag, "rows": n, "card": _card(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "build_and_probe_s": round(ready_s, 4)}
    for name, fn in (("k1", k1), ("k2", k2)):
        out[f"{name}_first"] = _timed_behind_sleep(fn)
    for name, fn in (("k1", k1), ("k2", k2)):
        out[f"{name}_second"] = _timed_behind_sleep(fn)
    for key_ in ("k1_first", "k2_first", "k1_second", "k2_second"):
        print(f"first_launch{' ' + args.tag if args.tag else ''}: {key_} "
              f"returned in {out[key_]['ms']:.4f} ms, busy-wait done "
              f"{out[key_]['waited']}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
