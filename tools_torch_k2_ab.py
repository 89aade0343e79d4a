"""Time K2 on the tree this script sits in, for comparing two trees.

    python3 tools_torch_k2_ab.py [--tag NAME] [--reps N]

Times, on the card, with the ``chip_smoke.py`` of the same tree:

- K2's scalar map side, the bare kernel (all three passes, buffers
  allocated once: ``chip_smoke.bare_aggregate_ms``) at phase 2's shape:
  2**23 rows, keys uniform over 2**20 (``torch.Generator`` seed 20),
  int32 add, 4 regions of 2**21 slots;
- K2's scalar reduce side, the bare kernel, on reduce wave 0's input as
  the main path builds it (``chip_smoke._reduce_side_input``);
- the wrapper (``cuda_kernels.hash_aggregate``, allocation and any
  scatter after the kernel included) on [n, G] add columns at phase 2's
  timed vector shapes: 34a (2**18 float32 rows of 128 over keys in
  [0, 1024), 4 regions of 2**16), 34b (2**21 int32 rows of 8 over
  2**20 keys, 4 regions of 2**19) and G = 4 (2**18 int32 rows over
  2**16 keys, 4 regions of 2**16).

Each time is the median of ``--reps`` runs between CUDA events after a
warm-up. The last line is one JSON object with the times, the tag and
the card's name and power limit. To compare two trees, copy this script
into each and run them in turns within one call (parent, change,
change, parent): the kernel library is built from the tree the script
runs in.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

#: (label, G, dtype, rows, R, key span), 4 regions each.
VECTOR_SHAPES = (
    ("34a", 128, torch.float32, 1 << 18, 1 << 16, 1 << 10),
    ("34b", 8, torch.int32, 1 << 21, 1 << 19, 1 << 20),
    ("G=4", 4, torch.int32, 1 << 18, 1 << 16, 1 << 16),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tools_torch_k2_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bigslice_tpu_torch.parallel import cuda_kernels as ck

    card = cs.phase0_card()
    ck.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    out = {"tag": args.tag, "card": card}

    n, nparts, R = 1 << 23, 4, 1 << 21
    key = torch.randint(0, 1 << 20, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    one = torch.ones(n, dtype=torch.int32, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    part, _ = ck.hash_partition([key], nparts, 0, with_counts=False)
    nkeys = int(ck.hash_aggregate(valid, [key], [one], ["add"], part,
                                  nparts, R)[0].sum())
    out["scalar_map_ms"] = cs.time_bare_ms(
        lambda: None, _bare(cs, ck, valid, [key], [one], part, nparts, R),
        reps=args.reps)
    cs.bare_aggregate_ms(valid, [key], [one], ["add"], part, nparts, R,
                         nkeys)  # checks the keys placed
    del key, one, valid, part

    rvalid, rkey, rval, _ = cs._reduce_side_input(dev)
    R = rkey.shape[0]
    rpart = torch.zeros(R, dtype=torch.int32, device=dev)
    out["scalar_reduce_ms"] = cs.time_bare_ms(
        lambda: None, _bare(cs, ck, rvalid, [rkey], [rval], rpart, 1, R),
        reps=args.reps)
    del rvalid, rkey, rval, rpart

    out["vector_wrapper_ms"] = {}
    for label, G, dtype, n, R, span in VECTOR_SHAPES:
        key = torch.randint(0, span, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        v = (torch.randn((n, G), generator=gen, device=dev)
             if dtype == torch.float32 else
             torch.randint(-1000, 1000, (n, G), generator=gen, device=dev,
                           dtype=torch.int32))
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        part, _ = ck.hash_partition([key], 4, 0, with_counts=False)
        out["vector_wrapper_ms"][label] = cs.time_ms(
            lambda: ck.hash_aggregate(valid, [key], [v], ["add"], part, 4,
                                      R), reps=args.reps)
    print(json.dumps(out))
    return 0


def _bare(cs, ck, valid, keys, vals, part, nparts, R):
    """The bare kernel's launch over scalar columns, its buffers
    allocated once (the scalar columns' plan and arguments, the same in
    every tree since K2's first port)."""
    n = valid.shape[0]
    plan = ck.aggregate_plan(len(keys), len(vals), nparts, R, n)
    buf = ck.aggregate_buffers(plan, keys, vals, nparts * R, valid.device)
    args = ck.aggregate_args(valid, keys, vals, ["add"] * len(vals), part,
                             nparts, R, 0, plan, buf)
    return cs._launcher(ck.build().bs_hash_aggregate, args,
                        "hash_aggregate")


if __name__ == "__main__":
    sys.exit(main())
