"""Program runner: bootstrap a configured session, run the user program.

Every rank runs the SAME Python program, so ``run`` is "configure a
session, execute the program", and a multi-process run starts this same
command once a rank.

Usage::

    python -m bigslice_tpu_torch.tools.run [flags] program.py [args...]

Flags (``sliceconfig.parse``): -local, -parallelism N, -status, -trace
T, -device cpu, -backend nccl|gloo, and for ranks: -spmd
[-coordinator host:port -nprocs N -procid I], -launch N [-deadline S].

On a node, torchrun starts one process a GPU with ``env://``::

    torchrun --nproc-per-node 8 -m bigslice_tpu_torch.tools.run -spmd \\
        program.py

``-launch N`` starts N local processes of the same command itself,
with ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` set, under a deadline
(``-deadline``, default 3600 s); when a rank fails or the deadline
passes, the rest are killed, each rank's stderr tail printed, and the
exit code is non-zero::

    python -m bigslice_tpu_torch.tools.run -launch 2 -device cpu program.py

The program gets the configured session from
``bigslice_tpu_torch.sliceconfig.current_session()`` (also here), and
keeps driver-only work (printing, writing files) under
``spmd.is_coordinator()``.
"""

from __future__ import annotations

import runpy
import sys

from bigslice_tpu_torch import sliceconfig

DEFAULT_DEADLINE_S = 3600.0


def current_session():
    return sliceconfig.current_session()


# Runner flags that take a value: the -launch scan hops them to find the
# first positional (the program), so a -launch of the program's own is
# never taken.
_VALUE_FLAGS = ("-parallelism", "-trace", "-coordinator", "-nprocs",
                "-procid", "-launch", "-device", "-backend", "-deadline")


def _extract(argv, flag: str, conv):
    """(value, argv without ``flag VALUE``) for a pre-program flag;
    (None, argv) when absent. A malformed value exits with usage."""
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == flag:
            try:
                value = conv(argv[i + 1])
            except (IndexError, ValueError):
                print(f"usage: {flag} VALUE", file=sys.stderr)
                raise SystemExit(2)
            return value, argv[:i] + argv[i + 2:]
        if a in _VALUE_FLAGS:
            i += 2
        elif a.startswith("-"):
            i += 1
        else:
            break  # the program path
    return None, argv


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    n, argv = _extract(argv, "-launch", int)
    deadline, argv = _extract(argv, "-deadline", float)
    if n is not None:
        from bigslice_tpu_torch.tools import multihost_smoke

        res = multihost_smoke.launch(
            n, [sys.executable, "-m", "bigslice_tpu_torch.tools.run",
                "-spmd", *argv],
            deadline_s=deadline or DEFAULT_DEADLINE_S, relay=True)
        return res.rc
    sess, rest = sliceconfig.parse(argv)
    if not rest:
        print("usage: python -m bigslice_tpu_torch.tools.run [flags] "
              "program.py [args...]", file=sys.stderr)
        return 2
    sliceconfig.set_current_session(sess)
    prog, prog_args = rest[0], rest[1:]
    sys.argv = [prog] + prog_args
    try:
        runpy.run_path(prog, run_name="__main__")
    finally:
        sess.shutdown()
        from bigslice_tpu_torch.utils import distributed

        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
