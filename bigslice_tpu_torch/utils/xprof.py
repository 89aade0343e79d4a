"""Windowed, on-demand device profiling on ``torch.profiler``.

``Profiler`` carries two modes behind one gate:

- ``window(seconds)``: start a trace now, hold it for the window, stop,
  and write the trace (Chrome/Perfetto JSON, ``trace.json``) under a
  directory; returns the directory and its files. This profiles a live
  session on demand, with no session-long overhead.
- ``trace_run()``: a trace around one evaluation, for a profiler made
  with an every-run directory (``Profiler(every_run_dir=...)``): the
  caller opens it before a run and closes it after, and each closed
  trace writes ``run-<pid>-<n>.json`` there.

The activities are the CPU's and, when the profiler's device is
``cuda``, the card's (CUPTI kernel and copy events, process-wide). One
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
               out_dir: Optional[str] = None) -> dict:
        """Profile the process for ``seconds`` (clamped to [0.05,
        MAX_WINDOW_SECS]), blocking for the window; returns ``{"dir",
        "seconds", "files"}``, ``files`` relative to ``dir``. Raises
        ProfilerBusy when another trace is live."""
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
            _RECORDING.set()
            try:
                time.sleep(seconds)
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
            _RECORDING.set()
        except Exception:  # noqa: BLE001 — profiling never fails a run
            _GATE.release()
            return None
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
