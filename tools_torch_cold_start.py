"""Where a fresh serving process's time goes before its first answer.

    python3 tools_torch_cold_start.py [--top N]

In one fresh process, on the card: imports torch, makes the CUDA
context, builds the ``sliceserve`` server (``build_server``: the
Session, the kernel library's load and probe, the demo pipelines), then
invokes the demo ``reduce`` twice, the first time under ``cProfile``.
Prints each step's seconds, the profile's top ``N`` entries by
cumulative and by own time, and as the last line one JSON object with
the steps, the count and seconds of modules compiled from source during
the first request (``builtins.compile``) and the card's name and power
limit (``nvidia-smi``). Run it in a fresh process for each reading.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    import torch

    steps = {"import_torch_s": time.perf_counter() - t0}
    if not torch.cuda.is_available():
        print("cold_start: no CUDA device is available", file=sys.stderr)
        return 2
    t = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    steps["context_s"] = time.perf_counter() - t
    t = time.perf_counter()
    from bigslice_tpu_torch.tools import sliceserve

    server = sliceserve.build_server(port=0)
    steps["build_server_s"] = time.perf_counter() - t
    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.enable()
    code, doc = server.invoke_request({"pipeline": "reduce"})
    prof.disable()
    steps["first_request_s"] = time.perf_counter() - t
    t = time.perf_counter()
    code2, _ = server.invoke_request({"pipeline": "reduce"})
    steps["second_request_s"] = time.perf_counter() - t
    server.session.shutdown()
    if (code, code2) != (200, 200):
        raise RuntimeError(f"cold_start: the requests answered {code}, "
                           f"{code2}: {doc}")
    stats = pstats.Stats(prof)
    compiled = [(cc, tt) for (fn, _, name), (cc, _, tt, _, _)
                in stats.stats.items() if name == "<built-in method "
                "builtins.compile>"]
    for key in ("cumulative", "tottime"):
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats(key).print_stats(args.top)
        print(out.getvalue(), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    result = {k: round(v, 4) for k, v in steps.items()}
    result.update(
        compiled_modules=sum(cc for cc, _ in compiled),
        compile_s=round(sum(tt for _, tt in compiled), 4),
        card=card, torch=torch.__version__, cuda=torch.version.cuda)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
