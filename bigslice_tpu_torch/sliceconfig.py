"""Session bootstrap from a config profile and flags.

The reference's ``sliceconfig`` (reference sliceconfig.py:1-154): a
user profile at ``~/.bigslice_tpu_torch/config`` (JSON) supplies
defaults (executor, parallelism, status, trace path, the distributed
settings); command-line flags override; ``parse()`` returns a ready
Session. With ``distributed`` the process joins the group of ranks
(``utils/distributed.py``) and the session is an SPMD one over every
rank (``exec/spmd.py``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

CONFIG_PATH = os.path.join(os.path.expanduser("~"), ".bigslice_tpu_torch",
                           "config")

DEFAULTS = {
    "executor": "auto",       # auto | local | mesh
    "parallelism": 0,         # 0: the executor's default
    "status": False,
    "trace_path": "",
    "device": "",             # "" is cuda; "cpu" runs on the CPU
    "backend": "",            # "" is nccl on cuda, gloo on the CPU
    "distributed": False,     # join the torch.distributed group
    "coordinator": "",        # host:port; "" reads torchrun's env://
    "num_processes": 0,
    "process_id": -1,
}


def load_profile(path: Optional[str] = None) -> dict:
    if path is None:
        path = CONFIG_PATH  # late-bound so tests can repoint it
    cfg = dict(DEFAULTS)
    if os.path.exists(path):
        with open(path) as fp:
            cfg.update(json.load(fp))
    return cfg


def write_profile(values: dict, path: Optional[str] = None) -> None:
    if path is None:
        path = CONFIG_PATH
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fp:
        json.dump(values, fp, indent=2)


def make_session(cfg: dict):
    """A Session per the config (the reference's ``make_session``)."""
    from bigslice_tpu_torch.exec.session import Session

    device = cfg.get("device") or None
    parallelism = cfg.get("parallelism") or None
    if cfg.get("distributed"):
        from bigslice_tpu_torch.exec.spmd import spmd_session
        from bigslice_tpu_torch.utils import distributed

        distributed.initialize(
            coordinator=cfg.get("coordinator") or None,
            num_processes=cfg.get("num_processes") or None,
            process_id=(cfg["process_id"]
                        if cfg.get("process_id", -1) >= 0 else None),
            backend=cfg.get("backend") or None, device=device)
        return spmd_session(parallelism=parallelism,
                            status=bool(cfg.get("status")),
                            trace_path=cfg.get("trace_path") or None)
    if cfg.get("executor") == "local":
        from bigslice_tpu_torch.exec.local import LocalExecutor

        executor = LocalExecutor(procs=parallelism, device=device)
    else:
        from bigslice_tpu_torch.exec.meshexec import MeshExecutor

        executor = MeshExecutor(device=device, fallback_procs=parallelism)
    return Session(executor=executor, status=bool(cfg.get("status")),
                   trace_path=cfg.get("trace_path") or None)


_current_session = None


def current_session():
    """The session configured by the run CLI (``tools/run.py``), if
    any."""
    return _current_session


def set_current_session(sess) -> None:
    global _current_session
    _current_session = sess


def parse(argv=None):
    """Merge profile and flags and build a Session. Returns (session,
    leftover_args)."""
    cfg = load_profile()
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("-local", action="store_true",
                    help="force the local executor")
    ap.add_argument("-parallelism", type=int, default=None)
    ap.add_argument("-status", action="store_true", default=None)
    ap.add_argument("-trace", dest="trace_path", default=None)
    ap.add_argument("-device", default=None,
                    help="cpu runs on the CPU (default: cuda)")
    ap.add_argument("-backend", default=None,
                    help="nccl or gloo (default: by the device)")
    ap.add_argument("-spmd", action="store_true", default=None,
                    help="an SPMD session over torch.distributed ranks "
                         "(run the SAME command on every rank)")
    ap.add_argument("-coordinator", default=None,
                    help="host:port of rank 0 (default: env://)")
    ap.add_argument("-nprocs", type=int, default=None)
    ap.add_argument("-procid", type=int, default=None)
    args, rest = ap.parse_known_args(argv)
    if args.local:
        cfg["executor"] = "local"
    for key in ("parallelism", "status", "trace_path", "device", "backend"):
        if getattr(args, key) is not None:
            cfg[key] = getattr(args, key)
    if (args.spmd or args.coordinator is not None
            or args.nprocs is not None or args.procid is not None):
        # Any multi-process flag means the SPMD session: a coordinator
        # on a plain session would run one process its user believes is
        # a gang.
        cfg["distributed"] = True
        cfg["executor"] = "mesh"
    if args.coordinator is not None:
        cfg["coordinator"] = args.coordinator
    if args.nprocs is not None:
        cfg["num_processes"] = args.nprocs
    if args.procid is not None:
        cfg["process_id"] = args.procid
    return make_session(cfg), rest
