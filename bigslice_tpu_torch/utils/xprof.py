"""Windowed, on-demand device profiling on ``torch.profiler``.

``Profiler`` carries two modes behind one gate:

- ``window(seconds, until=)``: start a trace now, hold it for the
  window (or until an event is set), stop,
  and write the trace (Chrome/Perfetto JSON, ``trace.json``) under a
  directory; returns the directory and its files. This profiles a live
  session on demand, with no session-long overhead.
- ``trace_run()``: a trace around one evaluation, for a profiler made
  with an every-run directory (``Profiler(every_run_dir=...)``): the
  caller opens it before a run and closes it after, and each closed
  trace writes ``run-<pid>-<n>.json`` there.

The activities are the CPU's and, when the profiler's device is
``cuda``, the card's (CUPTI kernel and copy events, process-wide); a
device trace opens with a burst of small kernels (``xprof_warmup``)
before it counts as recording. One
gate per process: torch runs one profiler at a time, so a window asked
for while another trace is live raises ``ProfilerBusy``, and an
evaluation trace is skipped instead.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import List, Optional

# One profiler per process, whichever Profiler object asks.
_GATE = threading.Lock()
_RUN_SEQ = itertools.count()
# Set while a trace records (torch's own flag is per thread).
_RECORDING = threading.Event()


def recording() -> bool:
    """Whether a window or an evaluation trace is recording now, as seen
    from any thread."""
    return _RECORDING.is_set()


class ProfilerBusy(RuntimeError):
    """A profiling window was requested while another trace (window or
    per-evaluation) is live: torch runs one profiler per process."""


def _all_threads_config():
    """Kineto's option to record the CPU ops of every thread (a window
    profiles the process, and a session's work runs on its executor's
    threads); None where this torch lacks it, and then the card's
    activity (process-wide) and the calling thread's ops are traced."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def _profile(device):
    import torch.profiler

    kw = {"activities": _activities(device)}
    cfg = _all_threads_config()
    if cfg is not None:
        kw["experimental_config"] = cfg
    return torch.profiler.profile(**kw)


# Small kernels launched at the start of every device trace. On an H100
# under torch 2.11 a process that has run long enough can reach a state
# in which each profiler session drops the first device records it
# collects (10 and 12 kernels in phase 26 of chip_smoke.py, whatever
# they are, the first of a session); the burst
# takes that loss, so the work a window or a run trace was opened for is
# traced whole.
WARMUP_KERNELS = 256


def _device_warmup(device) -> None:
    """Launch WARMUP_KERNELS one-element fills on the traced card and
    wait for them, under a ``xprof_warmup`` range in the trace."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    with torch.profiler.record_function("xprof_warmup"):
        x = torch.empty(1, device=dev)
        for i in range(WARMUP_KERNELS):
            x.fill_(i)
        torch.cuda.synchronize(dev)


def _traces_device(device) -> bool:
    from torch.profiler import ProfilerActivity

    return ProfilerActivity.CUDA in _activities(device)


def _activities(device):
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


class Profiler:
    """Session-scoped profiler. ``every_run_dir`` enables
    ``trace_run()``; ``device`` is the executor's (``cuda`` adds the
    card's activity)."""

    # Long windows pin the process-wide profiler and grow the trace.
    MAX_WINDOW_SECS = 120.0

    def __init__(self, every_run_dir: Optional[str] = None, device=None):
        self.every_run_dir = every_run_dir
        self.device = device

    # -- on-demand window -------------------------------------------------

    def window(self, seconds: float,
               out_dir: Optional[str] = None,
               until: Optional[threading.Event] = None) -> dict:
        """Profile the process for ``seconds`` (clamped to [0.05,
        MAX_WINDOW_SECS]), blocking for the window, or until ``until``
        is set if that comes first (a window that must hold a piece of
        work whole ends when the work does, not at a guessed length);
        returns ``{"dir", "seconds", "files"}``, ``files`` relative to
        ``dir``. Raises ProfilerBusy when another trace is live."""
        seconds = min(max(0.05, float(seconds)), self.MAX_WINDOW_SECS)
        if out_dir is None:
            import tempfile

            out_dir = tempfile.mkdtemp(prefix="bigslice-xprof-")
        if not _GATE.acquire(blocking=False):
            raise ProfilerBusy(
                "another profiling window or evaluation trace is "
                "already running (one torch profiler per process)"
            )
        try:
            os.makedirs(out_dir, exist_ok=True)
            prof = _profile(self.device)
            prof.__enter__()
            try:
                if _traces_device(self.device):
                    _device_warmup(self.device)
            except BaseException:
                prof.__exit__(None, None, None)
                raise
            _RECORDING.set()
            try:
                if until is None:
                    time.sleep(seconds)
                else:
                    until.wait(seconds)
            finally:
                _RECORDING.clear()
                prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        finally:
            _GATE.release()
        return {
            "dir": out_dir,
            "seconds": seconds,
            "files": self._trace_files(out_dir),
        }

    @staticmethod
    def _trace_files(out_dir: str) -> List[str]:
        files = []
        for root, _, names in os.walk(out_dir):
            for n in names:
                files.append(os.path.relpath(
                    os.path.join(root, n), out_dir
                ))
        return sorted(files)

    # -- per-evaluation mode ----------------------------------------------

    def trace_run(self):
        """A handle on a profiler trace of one evaluation, written into
        ``every_run_dir`` at ``close()``; None when the mode is off or
        another trace is live (concurrent runs skip; a failure to start
        never fails the evaluation)."""
        if not self.every_run_dir:
            return None
        if not _GATE.acquire(blocking=False):
            return None
        try:
            os.makedirs(self.every_run_dir, exist_ok=True)
            prof = _profile(self.device)
            prof.__enter__()
        except Exception:  # noqa: BLE001 — profiling never fails a run
            _GATE.release()
            return None
        try:
            if _traces_device(self.device):
                _device_warmup(self.device)
        except Exception:  # noqa: BLE001
            try:
                prof.__exit__(None, None, None)
            finally:
                _GATE.release()
            return None
        _RECORDING.set()
        path = os.path.join(self.every_run_dir,
                            f"run-{os.getpid()}-{next(_RUN_SEQ)}.json")
        return _RunTrace(prof, path)


class _RunTrace:
    """The live per-evaluation trace: ``close()`` stops it, writes the
    trace, is idempotent and never raises (the profiler's teardown must
    not mask the run's own error)."""

    def __init__(self, prof, path: str):
        self._prof = prof
        self.path = path
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        _RECORDING.clear()
        try:
            self._prof.__exit__(None, None, None)
            self._prof.export_chrome_trace(self.path)
        except Exception:  # noqa: BLE001
            pass
        finally:
            _GATE.release()
