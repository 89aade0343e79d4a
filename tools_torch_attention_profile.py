"""Break the device executor's attend stage down by operation on the card.

    python3 tools_torch_attention_profile.py [--seq N] [--rows 14]

Stages q, k and v of ``chip_smoke.py`` phase 31a's shape (seq 2**13, 2
heads of 128, RandomState(31)) on the card once, then for each
lowering (the tiled ring in bf16 and fp32 at ``block_q = 128``, the
ring in bf16 at ``block_q = 1024``, Ulysses in fp32) calls the
executor's attend stage (``MeshExecutor._attend``) over them: two warm
calls, three timed (the wall of a call, synchronized), then one under
``torch.profiler`` whose operations are printed by device time (the
table's "Self CUDA time total" is the call's device time). The card's
name and power limit (``nvidia-smi``) come first.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

import bigslice_tpu_torch as bs
from bigslice_tpu_torch.exec.meshexec import MeshExecutor, StagedInput

HEADS, HEAD_DIM = 2, 128
LOWERINGS = (
    ("ring-bf16-bq128", dict(dtype=torch.bfloat16, method="ring",
                             block_q=128)),
    ("ring-fp32-bq128", dict(method="ring", block_q=128)),
    ("ring-bf16-bq1024", dict(dtype=torch.bfloat16, method="ring",
                              block_q=1024)),
    ("ulysses-fp32", dict()),
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=1 << 13)
    ap.add_argument("--rows", type=int, default=14,
                    help="operations printed a lowering")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rng = np.random.RandomState(31)
    host = [(rng.randn(args.seq, HEADS * HEAD_DIM) * 0.3).astype(np.float32)
            for _ in range(3)]
    cols = [torch.from_numpy(c).cuda() for c in host]
    counts = torch.tensor([args.seq], dtype=torch.int32, device="cuda")
    staged = StagedInput(cols, counts, args.seq, False, None)
    ex = MeshExecutor()
    for name, kw in LOWERINGS:
        att = bs.SelfAttend(bs.Const(1, *host), causal=True, heads=HEADS,
                            **kw)
        for _ in range(2):
            ex._attend("profile", att, staged)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            ex._attend("profile", att, staged)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 3 * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            ex._attend("profile", att, staged)
            torch.cuda.synchronize()
        print(f"== {name}: wall {wall_ms:.3f} ms a call", flush=True)
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=args.rows), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
