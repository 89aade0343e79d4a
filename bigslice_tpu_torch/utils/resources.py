"""Resource telemetry: device-memory and host-memory gauges.

- ``device_memory()``: the CUDA caching allocator's stats for each card
  (allocated, reserved and peak bytes, against the card's total
  memory); ``[]`` on a device without allocator stats (the CPU).
- ``host_rss_bytes()``: the current resident set from
  ``/proc/self/statm`` where that file exists, else the peak from
  ``getrusage``.

Executors expose ``resource_stats()``, which joins these with their
own gauges (resident outputs, adapted shuffle slack, split runs, sites
on the sort path); the status display renders them.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional


def host_rss_bytes() -> Optional[int]:
    """Current resident set size in bytes (None if unknowable)."""
    if os.path.exists("/proc/self/statm"):
        try:
            with open("/proc/self/statm") as fp:
                pages = int(fp.read().split()[1])
            return pages * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError, IndexError):
            pass
    try:
        import resource

        # ru_maxrss is KiB on Linux, bytes on macOS; either way a peak,
        # not the current size.
        v = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return v if sys.platform == "darwin" else v * 1024
    except (ImportError, OSError):
        return None


def allocator_stats(device) -> Optional[Dict[str, int]]:
    """``{"bytes_in_use", "reserved_bytes", "peak_bytes_in_use",
    "bytes_limit"}`` for a CUDA device from its caching allocator
    (``torch.cuda.memory_stats_as_nested_dict``, one call), the limit
    being the card's total memory; None for any other device."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    if not stats:
        return None
    alloc = stats.get("allocated_bytes", {}).get("all", {})
    reserved = stats.get("reserved_bytes", {}).get("all", {})
    return {
        "bytes_in_use": int(alloc.get("current", 0)),
        "reserved_bytes": int(reserved.get("current", 0)),
        "peak_bytes_in_use": int(alloc.get("peak", 0)),
        "bytes_limit": _total_memory(device),
    }


_TOTALS: Dict[int, int] = {}


def _total_memory(device) -> int:
    import torch

    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _TOTALS:
        _TOTALS[index] = int(
            torch.cuda.get_device_properties(index).total_memory)
    return _TOTALS[index]


def device_memory(devices=None) -> List[Dict]:
    """Per-card allocator stats where the device reports them; ``[]``
    without CUDA devices."""
    import torch

    if devices is None:
        if not torch.cuda.is_available():
            return []
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        stats = allocator_stats(d)
        if not stats:
            continue
        d = torch.device(d)
        out.append({
            "id": int(d.index or 0),
            "kind": torch.cuda.get_device_name(d),
            **stats,
        })
    return out


def _fmt_bytes(n: Optional[int]) -> str:
    if n is None:
        return "?"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}PB"


def render_stats(stats: Dict) -> List[str]:
    """Status lines for an executor's resource_stats() dict."""
    lines = []
    rss = stats.get("host_rss_bytes")
    if rss is not None:
        lines.append(f"  host rss: {_fmt_bytes(rss)}")
    resident = stats.get("resident_output_bytes")
    if resident is not None:
        lines.append(
            f"  device-resident outputs: {_fmt_bytes(resident)}"
        )
    for d in stats.get("devices", ()):
        use, lim = d.get("bytes_in_use"), d.get("bytes_limit")
        pct = (f" ({100.0 * use / lim:.0f}%)"
               if use is not None and lim else "")
        lines.append(
            f"  device {d['id']}: {_fmt_bytes(use)}/{_fmt_bytes(lim)}"
            f" HBM in use{pct}"
        )
    g = stats.get("gauges") or {}
    slack = g.get("shuffle_slack")
    if slack:
        worst = ", ".join(f"{op}={v:g}" for op, v in
                          sorted(slack.items())[:4])
        lines.append(f"  shuffle slack adaptations: {worst}")
    splits = g.get("split_runs")
    if splits:
        s = ", ".join(f"{op}x{k}" for op, k in
                      sorted(splits.items())[:4])
        lines.append(f"  budget split runs: {s}")
    off = g.get("hash_off")
    if off:
        lines.append(
            "  hash-aggregate off: " + ", ".join(sorted(off)[:4])
        )
    return lines
