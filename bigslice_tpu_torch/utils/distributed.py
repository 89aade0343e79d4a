"""Processes of one program over ``torch.distributed``.

The JAX package coordinates hosts through ``jax.distributed``
(reference utils/distributed.py). Here every rank runs the SAME driver
program, one process per GPU: ``initialize`` forms the process group,
``global_mesh`` is the mesh whose slots are the ranks
(``parallel/meshutil.py``), and the device executor's collectives ride
that group (NCCL across GPUs, gloo on the CPU or for ranks that share
one GPU).

- ``initialize(coordinator=, num_processes=, process_id=, backend=,
  device=, timeout=)``: with no arguments, torchrun's ``env://``
  variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``); ``coordinator="host:port"`` for ``tcp://``. The
  device is ``cuda:{LOCAL_RANK % device_count}`` unless the caller
  asks for ``cpu``; the backend ``nccl`` for ``cuda``, ``gloo`` for
  ``cpu``, unless given. ``timeout`` (``BIGSLICE_DIST_TIMEOUT``, default
  300 s) bounds every collective, so a lost peer cannot hang the group
  forever. A group that fails to form raises; nothing switches backend
  or device. It ends with the Func-registry check.
- ``Keepalive``: each rank publishes a beat over the group's store
  (c10d ``TCPStore``); a peer whose beat has not advanced for
  ``timeout`` seconds of local time is lost, and ``check()`` raises
  ``PeerLostError`` (the executor calls it before every group).
- ``store_try_get``: a read of the group's store that never waits (the
  store's own ``get`` waits for an absent key, and the process's other
  store calls with it).
- ``default_mesh_provider``: the elastic session's mesh discovery, in
  one process.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Optional

import torch

__all__ = ["Keepalive", "PeerLostError", "check_injected_peer_loss",
           "default_mesh_provider", "get_keepalive", "global_mesh",
           "initialize", "is_coordinator", "local_device", "process_count",
           "process_index", "shutdown", "store_try_get"]

_lock = threading.Lock()
_device: Optional[torch.device] = None
_mesh = None
_KEEPALIVE: Optional["Keepalive"] = None


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def local_device(device=None) -> torch.device:
    """This rank's device: ``cpu`` when asked for, else
    ``cuda:{LOCAL_RANK % device_count}`` (raises without a GPU)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("distributed: no CUDA device is available; pass "
                           "device='cpu' to run the ranks on the CPU")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None,
               timeout: Optional[float] = None) -> None:
    """Form the process group (idempotent in a process that formed
    one), then check that every rank registered the same Funcs."""
    global _device
    dist = _dist()
    with _lock:
        if is_initialized():
            return
        dev = local_device(device)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if timeout is None:
            timeout = float(os.environ.get("BIGSLICE_DIST_TIMEOUT", "300"))
        kwargs = {"backend": backend,
                  "timeout": datetime.timedelta(seconds=timeout)}
        if coordinator is not None:
            if num_processes is None or process_id is None:
                raise ValueError("initialize: a coordinator needs "
                                 "num_processes and process_id")
            kwargs.update(init_method=f"tcp://{coordinator}",
                          world_size=int(num_processes),
                          rank=int(process_id))
        elif num_processes is not None or process_id is not None:
            raise ValueError("initialize: num_processes and process_id "
                             "need a coordinator")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
        dist.init_process_group(**kwargs)
        _device = dev
    from bigslice_tpu_torch.ops.func import verify_registry_across_hosts

    try:
        verify_registry_across_hosts()
    except BaseException:
        # The group is no use to this program: tear it down here, not at
        # interpreter exit, where gloo's threads may abort the process.
        shutdown()
        raise


def shutdown() -> None:
    """Stop the keepalive and destroy the process group."""
    global _mesh, _KEEPALIVE, _device
    with _lock:
        if _KEEPALIVE is not None:
            _KEEPALIVE.stop()
            _KEEPALIVE = None
        _mesh = None
        _device = None
        if is_initialized():
            _dist().destroy_process_group()


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def is_coordinator() -> bool:
    """True on rank 0, where driver-only work (printing, writing result
    files) belongs."""
    return process_index() == 0


def global_mesh():
    """The mesh over every rank of the group (one slot a rank), built
    once a process; the one-slot mesh on this process's device when no
    group is formed. ``BIGSLICE_MESH_SHAPE=DxI`` makes it the 2-D DCN ×
    ICI grid of the same ranks (rank ``g * I + i`` at ``(g, i)``); a
    shape that does not cover the ranks raises ``ValueError``."""
    global _mesh
    from bigslice_tpu_torch.parallel import meshutil

    shape = meshutil.mesh_shape_from_env()  # a malformed value raises
    if shape is not None and shape[0] * shape[1] != process_count():
        raise ValueError(
            f"BIGSLICE_MESH_SHAPE={shape[0]}x{shape[1]}: the mesh shape "
            f"does not cover {process_count()} rank(s)")
    with _lock:
        if _mesh is None:
            if is_initialized():
                _mesh = meshutil.Mesh(_dist().group.WORLD,
                                      device=_device or local_device(),
                                      shape=shape)
            else:
                _mesh = meshutil.Mesh(None, device=local_device(),
                                      shape=shape)
        return _mesh


class PeerLostError(RuntimeError):
    """A peer process stopped beating: wedged or dead."""


#: ``store_try_get``'s expected value, which no key of the port holds.
_ABSENT = "\x00bigslice-absent\x00"


def store_try_get(store, key: str) -> Optional[bytes]:
    """``key``'s value in a c10d store, or None when it is absent,
    without waiting (a store that fails raises). The store's ``get``
    waits until the key exists and holds the process's client while it
    waits, so every other thread's store call waits too, the keepalive's
    beat among them: a ``check`` then ``get`` that loses the race with a
    peer's delete of the key stalls this process's beat until the
    store's timeout, and its peers judge it lost. ``compare_set``
    against a value no key holds answers at once and creates nothing."""
    v = bytes(store.compare_set(key, _ABSENT, _ABSENT))
    return None if v == _ABSENT.encode() else v


class Keepalive:
    """Liveness of the peers over the process group's store (reference
    utils/distributed.py:63-219, there over the jax coordination KV). A
    wedged peer keeps its sockets open but never enters the next
    collective; its beat stops advancing. ``check()`` judges a peer lost
    when its beat has not ADVANCED for ``timeout`` seconds of local time
    (no clock is compared across hosts). Inactive without a group of
    more than one rank. ``BIGSLICE_KEEPALIVE_INTERVAL`` and
    ``BIGSLICE_KEEPALIVE_TIMEOUT`` override the defaults."""

    def __init__(self, interval: float = 2.0, timeout: float = 30.0):
        self.interval = float(os.environ.get("BIGSLICE_KEEPALIVE_INTERVAL",
                                             interval))
        self.timeout = float(os.environ.get("BIGSLICE_KEEPALIVE_TIMEOUT",
                                            timeout))
        self._store = None
        if is_initialized():
            from torch.distributed import distributed_c10d

            self._store = distributed_c10d._get_default_store()
        self._pid = process_index()
        self._npeers = process_count()
        self._beat = 0
        self._seen: dict = {}   # peer -> (beat, monotonic time it advanced)
        self._lost: list = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def active(self) -> bool:
        return self._store is not None and self._npeers > 1

    def start(self) -> "Keepalive":
        if self.active and self._thread is None:
            self._publish()
            self._thread = threading.Thread(
                target=self._loop, name="bigslice-keepalive", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop beating (peers will judge this process lost), and wait
        for the beating thread to leave the store."""
        self._stop.set()
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=self.interval + 5.0)

    def _key(self, pid: int) -> str:
        return f"bigslice/keepalive/{pid}"

    def _publish(self) -> None:
        self._beat += 1
        try:
            self._store.set(self._key(self._pid), str(self._beat))
        except Exception:  # noqa: BLE001 — the store is going away
            pass

    def _loop(self) -> None:
        # Publish AND poll every tick: staleness is judged against a
        # clock that runs continuously, not reseeded at check() time.
        while not self._stop.wait(self.interval):
            self._publish()
            self._poll()

    def _poll(self) -> list:
        now = time.monotonic()
        lost = []
        for pid in range(self._npeers):
            if pid == self._pid:
                continue
            try:
                raw = store_try_get(self._store, self._key(pid))
                if raw is None:
                    self._seen.pop(pid, None)
                    continue
                beat = int(raw)
            except Exception:  # noqa: BLE001 — indeterminate: not aged
                continue
            prev = self._seen.get(pid)
            if prev is None or prev[0] != beat:
                self._seen[pid] = (beat, now)
                continue
            age = now - prev[1]
            if age > self.timeout:
                lost.append((pid, age))
        if lost:
            self._lost = lost
        return lost

    def lost_peers(self) -> list:
        """[(rank, seconds since its beat last advanced)], sticky."""
        return list(self._lost)

    def age(self, pid: int) -> Optional[float]:
        """Seconds since ``pid``'s beat last advanced, or None before its
        first observed beat (the host-task exchange's liveness signal)."""
        seen = self._seen.get(pid)
        return None if seen is None else time.monotonic() - seen[1]

    def check(self) -> None:
        """Raise ``PeerLostError`` if a peer's beat has gone stale, or if
        the chaos plane's ``peer.lost`` site fires (the stale-beat
        verdict without the wedge, reference utils/distributed.py:
        203-210)."""
        check_injected_peer_loss()
        if not self._lost:
            return
        desc = ", ".join(f"rank {p} silent {a:.1f}s" for p, a in self._lost)
        raise PeerLostError(
            f"keepalive: {desc} (timeout {self.timeout:.1f}s)")


def check_injected_peer_loss() -> None:
    """Fire the chaos plane's ``peer.lost`` site: raise its
    ``PeerLostError`` when it fires. The executor calls it before every
    group in one process too, where no keepalive beats."""
    from bigslice_tpu_torch.utils import faultinject

    if faultinject.ENABLED:
        f = faultinject.fire("peer.lost")
        if f is not None:
            raise faultinject.injected_error(f)


def default_mesh_provider(probe_timeout: float = 5.0, device=None):
    """The elastic session's built-in mesh discovery (reference
    utils/distributed.py:252): each call probes ``device`` (the
    session's executor's; by default this process's card) with a tiny
    copy and add, bounded by ``probe_timeout`` in a worker thread (a
    wedged card must not hang recovery), and returns the one-slot mesh
    of that device when it answers, else None (the session then
    re-raises the gang loss). It never offers another device than the
    executor's: a CPU mesh only to an executor on the CPU, and None to
    one on ``cuda`` when no card is left.

    One process only: over ranks the device health can differ by rank,
    and a mesh chosen by one rank alone would wedge the group, so the
    provider returns None there and the session re-raises (the
    reference's own scope: "multi-process needs a coordinated platform
    provider")."""

    def provide():
        from bigslice_tpu_torch.parallel import meshutil

        if process_count() > 1:
            return None
        dev = torch.device(device) if device is not None else (
            _device or torch.device("cuda"))
        if dev.type == "cuda" and not torch.cuda.is_available():
            return None
        ok = []

        def probe():
            try:
                x = torch.ones((), device=dev)
                (x + 1).item()
                ok.append(True)
            except Exception:  # noqa: BLE001 — a sick device
                pass

        t = threading.Thread(target=probe, daemon=True,
                             name="bigslice-mesh-probe")
        t.start()
        t.join(probe_timeout)
        if not ok:
            return None
        return meshutil.Mesh(None, device=dev)

    return provide


def get_keepalive() -> Keepalive:
    """The process-wide Keepalive, started on first use: liveness is a
    property of the process, not of an executor."""
    global _KEEPALIVE
    with _lock:
        if _KEEPALIVE is None:
            _KEEPALIVE = Keepalive().start()
        return _KEEPALIVE
