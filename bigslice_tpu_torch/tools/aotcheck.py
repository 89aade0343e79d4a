"""The sm_90a build check of every hand-written kernel, no card needed.

The JAX package's ``tools/aotcheck.py`` compiles its device programs
ahead of time for a TPU topology, so that a lowering the compiler
refuses surfaces before the first run on the chip. Its Hopper analog:
every ``.cu`` under ``bigslice_tpu_torch/csrc/`` is compiled, from the
repo's sources alone, with ``nvcc -gencode arch=compute_90a,code=sm_90a
--cubin`` (the kernel library's own flags,
``cuda_kernels.NVCC_FLAGS``, less the host-side ones), each source in
its own ``nvcc`` process, all started together. For each kernel of
each cubin it records the registers, the shared memory, the local
(stack) memory and ptxas's spill bytes (``cuobjdump
--dump-resource-usage`` and ``-Xptxas -v``) to a JSON file, by default
``bigslice_tpu_torch/_build/aotcheck.json`` (git-ignored). A source
that does not compile fails the check, with nvcc's output.

Without ``nvcc`` (``$CUDA_HOME/bin`` or the ``PATH``) the check raises
``NvccNotFound``: it never passes without compiling.

Usage:
    python -m bigslice_tpu_torch.tools.aotcheck [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["ARCH_FLAGS", "NvccNotFound", "check", "default_out",
           "parse_ptxas", "parse_resource_usage", "sources"]

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

#: The device half of the kernel library's flags: one cubin for sm_90a.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3")


class NvccNotFound(RuntimeError):
    """No ``nvcc``: the build check cannot compile, so it fails."""


def sources() -> List[Path]:
    """Every CUDA source the check compiles, by name."""
    return sorted(SRC_DIR.glob("*.cu"))


def default_out() -> Path:
    return BUILD_DIR / "aotcheck.json"


def _nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                   "nvcc")
    return str(default) if default.exists() else None


def _cuobjdump(nvcc: str) -> Optional[str]:
    beside = Path(nvcc).with_name("cuobjdump")
    return str(beside) if beside.exists() else shutil.which("cuobjdump")


_RESOURCE = re.compile(r"Function\s+([^\s:]+):\s*(.*)")
_FIELD = re.compile(r"([A-Z]+)(?:\[\d+\])?:(\d+)")


def parse_resource_usage(text: str) -> Dict[str, dict]:
    """``cuobjdump --dump-resource-usage``'s entries, ``Function NAME:``
    followed on the same line or the next by ``REG:n STACK:n SHARED:n
    LOCAL:n ...``, as ``{NAME: {"registers", "stack_bytes",
    "shared_bytes", "local_bytes"}}``."""
    fields_of: Dict[str, dict] = {}
    current = None
    for line in text.splitlines():
        m = _RESOURCE.search(line)
        if m:
            current = m.group(1)
            fields_of[current] = {}
            line = m.group(2)
        if current is not None:
            fields_of[current].update(
                (k, int(v)) for k, v in _FIELD.findall(line))
    return {name: {"registers": f.get("REG", 0),
                   "stack_bytes": f.get("STACK", 0),
                   "shared_bytes": f.get("SHARED", 0),
                   "local_bytes": f.get("LOCAL", 0)}
            for name, f in fields_of.items()}


_PTXAS_FN = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")


def parse_ptxas(text: str) -> Dict[str, dict]:
    """``-Xptxas -v``'s report as ``{NAME: {"spill_store_bytes",
    "spill_load_bytes", "ptxas_registers"}}``, each function's numbers
    from the lines after its ``Compiling entry function``."""
    out: Dict[str, dict] = {}
    current = None
    for line in text.splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            current = m.group(1)
            out[current] = {"spill_store_bytes": 0, "spill_load_bytes": 0}
            continue
        if current is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            out[current].update(spill_store_bytes=int(m.group(1)),
                                spill_load_bytes=int(m.group(2)))
        m = _PTXAS_USED.search(line)
        if m:
            out[current]["ptxas_registers"] = int(m.group(1))
    return out


def check(out_path: Optional[str] = None, nvcc: Optional[str] = None
          ) -> dict:
    """Compile every source for sm_90a and write the report to
    ``out_path`` (default ``default_out()``). Returns the report:
    ``{"arch", "nvcc", "seconds", "sources": {name: {"cubin_bytes",
    "kernels": {kernel: {registers, shared_bytes, local_bytes,
    stack_bytes, spill_store_bytes, spill_load_bytes}}}}}``. Raises
    ``NvccNotFound`` without ``nvcc`` and ``RuntimeError`` (with nvcc's
    output) when a source does not compile."""
    nvcc = nvcc or _nvcc()
    if nvcc is None:
        raise NvccNotFound(
            "aotcheck: nvcc not found (CUDA_HOME/bin or PATH): the sm_90a "
            "build check cannot run")
    out = Path(out_path) if out_path else default_out()
    work = BUILD_DIR / f"aot-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    srcs = sources()
    procs = []
    for s in srcs:
        procs.append(subprocess.Popen(
            [nvcc, *ARCH_FLAGS, "--cubin", "-Xptxas", "-v", "-I",
             str(SRC_DIR), str(s), "-o", str(work / (s.stem + ".cubin"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs, errors = {}, []
    for s, p in zip(srcs, procs):
        logs[s.name] = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            errors.append(f"{s.name}:\n{logs[s.name]}")
    if errors:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError("aotcheck: nvcc failed for sm_90a:\n"
                           + "\n".join(errors))
    dump = _cuobjdump(nvcc)
    report = {"arch": "sm_90a", "nvcc": nvcc, "sources": {}}
    for s in srcs:
        cubin = work / (s.stem + ".cubin")
        usage = {}
        if dump is not None:
            r = subprocess.run([dump, "--dump-resource-usage", str(cubin)],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT)
            usage = parse_resource_usage(r.stdout.decode(errors="replace"))
        spills = parse_ptxas(logs[s.name])
        report.setdefault("ptxas", {})[s.name] = logs[s.name]
        kernels = {}
        for name in sorted(set(usage) | set(spills)):
            kernels[name] = {**usage.get(name, {}),
                             **spills.get(name, {})}
            # Without cuobjdump, ptxas's count stands.
            kernels[name].setdefault(
                "registers", kernels[name].get("ptxas_registers", 0))
        report["sources"][s.name] = {"cubin_bytes": cubin.stat().st_size,
                                     "kernels": kernels}
    report["seconds"] = round(time.perf_counter() - t0, 3)
    shutil.rmtree(work, ignore_errors=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1, sort_keys=True) + "\n")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="aotcheck",
        description="compile every csrc/*.cu for sm_90a and record each "
                    "kernel's registers, shared memory and spills")
    ap.add_argument("--out", default=None,
                    help=f"report path (default {default_out()})")
    args = ap.parse_args(argv)
    report = check(args.out)
    for src, entry in report["sources"].items():
        for name, k in entry["kernels"].items():
            print(f"{src} {name}: regs {k.get('registers', '?')} shared "
                  f"{k.get('shared_bytes', '?')} B local "
                  f"{k.get('local_bytes', '?')} B spill "
                  f"{k.get('spill_store_bytes', 0)}/"
                  f"{k.get('spill_load_bytes', 0)} B")
    print(f"aotcheck: {len(report['sources'])} sources in "
          f"{report['seconds']} s -> {args.out or default_out()}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
