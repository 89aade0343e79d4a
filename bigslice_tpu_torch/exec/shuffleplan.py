"""The shuffle-plan seam: the in-program exchange or the store-mediated
spill exchange, per shuffle boundary.

With the in-program exchange (the default), a shuffle's map waves merge
into one device-resident output that the consumer reads, so the whole
partitioned output must fit the card. The spill exchange bounds device
residency to one wave's working set:

- ``ShufflePlan`` — one boundary's decision (``in_program`` or
  ``spill``) with the estimate and budget behind it.
- ``choose`` — the planner. ``BIGSLICE_SHUFFLE`` unset leaves it
  disengaged (``plan_mode()`` is None; the executor runs the in-program
  path untouched); ``spill`` spills every eligible boundary; ``auto``
  spills when the boundary's staged-input estimate exceeds the spill
  budget (``spill_budget_bytes``).
- ``SpillExchange`` — each map wave still runs the fused combine +
  route program, but its per-destination partitions are pulled to the
  host and written through a ``FileStore`` in the BSF4 codec, one store
  entry per (wave, partition), and the wave's device tensors are
  released before the next wave. Consumers stream the partitions back
  through the staging arena in their own wave loop, re-combining the
  partials per key: the same multiple-producer contract the cross-wave
  merge relies on, so the rows equal the in-program path's, in the same
  wave-major order.

Loss and corruption need no new machinery: a ``FileStore`` quarantines
a corrupt file and raises ``Missing``, which re-runs the producer group
(and rewrites every spill entry).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from bigslice_tpu_torch.exec import store as store_mod
from bigslice_tpu_torch.exec.task import TaskName
from bigslice_tpu_torch.frame.frame import Frame
from bigslice_tpu_torch.utils import faultinject, fileio

#: The values ``BIGSLICE_SHUFFLE`` takes. Unset: the planner is
#: disengaged and every boundary runs the in-program exchange.
MODES = ("in_program", "spill", "auto")


def plan_mode(env: Optional[str] = None) -> Optional[str]:
    """The static knob: None (unset — planner disengaged) or one of
    MODES. An unknown value raises: a typo must not run the wrong
    exchange silently."""
    if env is None:
        env = os.environ.get("BIGSLICE_SHUFFLE", "")
    env = env.strip()
    if not env:
        return None
    if env not in MODES:
        raise ValueError(
            f"BIGSLICE_SHUFFLE must be one of {MODES}, got {env!r}")
    return env


def spill_budget_bytes(device_budget_bytes: Optional[int] = None,
                       nmesh: int = 1, *,
                       device_telemetry=None) -> Optional[int]:
    """The device-memory budget ``auto`` holds a boundary's staged bytes
    against: ``BIGSLICE_SPILL_BUDGET_BYTES`` first, else the measured
    budget of the session's device telemetry (``hbm_budget()``: the
    card's memory from ``torch.cuda.mem_get_info``), else the executor's
    per-device working-set budget times the device count. None: no
    budget known, and ``auto`` stays in-program."""
    env = os.environ.get("BIGSLICE_SPILL_BUDGET_BYTES")
    if env:
        return int(env)
    if device_telemetry is not None:
        measured = device_telemetry.hbm_budget()
        if measured:
            return int(measured)
    if device_budget_bytes:
        return int(device_budget_bytes) * max(1, int(nmesh))
    return None


class ShufflePlan(NamedTuple):
    """One shuffle boundary's exchange decision and its evidence."""

    kind: str                    # "in_program" | "spill"
    reason: str                  # "forced" | "estimate" | "no-budget" | ...
    est_bytes: Optional[int]     # staged-input-bytes estimate (auto)
    budget_bytes: Optional[int]  # the budget the estimate was held to


def choose(mode: Optional[str], est_bytes: Optional[int],
           budget_bytes: Optional[int],
           ineligible: Optional[str] = None) -> Optional[ShufflePlan]:
    """The planner. ``mode`` None (the knob unset) returns None and the
    caller runs the in-program path untouched; ``ineligible`` names why
    the boundary cannot spill, and a forced or auto spill then records
    an in-program plan carrying the reason."""
    if mode is None:
        return None
    if mode == "in_program":
        return ShufflePlan("in_program", "forced", est_bytes, budget_bytes)
    if ineligible:
        return ShufflePlan("in_program", f"ineligible: {ineligible}",
                           est_bytes, budget_bytes)
    if mode == "spill":
        return ShufflePlan("spill", "forced", est_bytes, budget_bytes)
    # auto: spill only when the staged bytes exceed the budget; without
    # either number stay in-program (spilling costs host round trips).
    if (est_bytes is not None and budget_bytes is not None
            and est_bytes > budget_bytes):
        return ShufflePlan("spill", "estimate", est_bytes, budget_bytes)
    return ShufflePlan(
        "in_program",
        "estimate" if est_bytes is not None and budget_bytes is not None
        else "no-budget", est_bytes, budget_bytes)


def spill_ineligible(task) -> Optional[str]:
    """Why a shuffle-boundary task can never spill, or None: the
    compiler's stamp, or a machine-combined boundary (its merge
    re-combines to one row per key, which spilled per-wave partials
    cannot honour). Over ranks a boundary spills too: each map wave's
    output is gathered to every rank, which writes every partition to
    its own spill store (``MeshExecutor._execute_group_spill``), so no
    rank ever needs another's files."""
    stamped = getattr(task, "spill_ineligible", None)
    if stamped:
        return stamped
    if task.partitioner.combine_key:
        return "machine-combiner buffer"
    return None


class SpillExchange:
    """Per-(map wave, partition) spill entries of ONE shuffle-boundary
    group, written through a ``FileStore`` and read back a partition at
    a time. Entry names are deterministic (``{op}~spill``, shard = wave),
    so a recomputed group overwrites its own entries. The manifest
    records which entries hold rows: empty partitions are never written,
    and a read that misses a manifested entry is a loss (``Missing``)."""

    def __init__(self, store: store_mod.Store, name: TaskName,
                 nwaves: int, nparts: int):
        self.store = store
        self.nparts = int(nparts)
        self.nwaves = int(nwaves)
        self.names = [TaskName(name.inv_index, f"{name.op}~spill", w, nwaves)
                      for w in range(nwaves)]
        self._lock = threading.Lock()
        # (wave, partition) -> (rows, bytes), written while the group
        # runs and read-only afterwards.
        self._manifest: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.spill_bytes = 0
        self.spill_rows = 0

    def put_partition(self, wave: int, partition: int,
                      cols: List[torch.Tensor], schema) -> int:
        """Write one partition's rows of one map wave (empty partitions
        are skipped); returns the bytes written."""
        rows = int(cols[0].shape[0]) if cols else 0
        if rows == 0:
            return 0
        if faultinject.ENABLED:
            # Chaos seam (reference exec/shuffleplan.py:203-205), before
            # any frame is built: a transient retries with backoff.
            fileio.retry_transient(
                lambda: faultinject.maybe_raise("spill.write"),
                "spill.write")
        self.store.put(self.names[wave], partition, [Frame(list(cols),
                                                            schema)])
        nbytes = sum(c.numel() * c.element_size() for c in cols)
        with self._lock:
            self._manifest[(wave, partition)] = (rows, nbytes)
            self.spill_bytes += nbytes
            self.spill_rows += rows
        return nbytes

    def _waves_of(self, partition: int) -> List[int]:
        with self._lock:
            return [w for w in range(self.nwaves)
                    if (w, partition) in self._manifest]

    def partition_rows(self) -> List[int]:
        """Per-partition row totals across waves."""
        out = [0] * self.nparts
        with self._lock:
            for (_, p), (rows, _) in self._manifest.items():
                out[p] += rows
        return out

    def partitions_written(self) -> int:
        with self._lock:
            return len({p for (_, p) in self._manifest})

    def read_partition(self, partition: int) -> List[Frame]:
        """A partition's spilled frames in map-wave order — the order of
        the in-program cross-wave merge. A lost entry raises
        ``Missing``."""
        frames: List[Frame] = []
        for w in self._waves_of(partition):
            name = self.names[w]
            if faultinject.ENABLED:
                # Chaos seam (reference exec/shuffleplan.py:244-256): the
                # spilled partition vanishes.
                f = faultinject.fire("spill.read")
                if f is not None:
                    self.store.drop(name, partition)
                    e = store_mod.Missing(
                        f"{name} p{partition} (injected spill loss)")
                    e.fault = f
                    e.fault_site = f.site
                    raise e
            frames.extend(self.store.read(name, partition))
        return frames

    def prefetch(self, partition: int) -> None:
        """Advisory read-ahead of every wave's entry of ``partition``."""
        for w in self._waves_of(partition):
            self.store.prefetch(self.names[w], partition)

    def discard(self) -> None:
        """Drop every spill entry (the group's output is discarded)."""
        for name in self.names:
            self.store.discard(name)
        with self._lock:
            self._manifest.clear()


class SpilledGroupOutput:
    """A shuffle-boundary group's output that lives in the spill store,
    not on the device. Consumers read it through the store bridge as
    they read any store-resident dep (partition p attributed to producer
    shard 0, as for a merged output)."""

    partitioned = True
    subid = False
    cols = None        # nothing on the device: _dep_input reads through
    counts = None      # the store bridge, never chains zero-copy
    gathered = True    # every rank's store holds every partition

    def __init__(self, exchange: SpillExchange, schema, nparts: int,
                 nmesh: int, plan: ShufflePlan, map_waves: int):
        self.exchange = exchange
        self.schema = schema
        self.nparts = int(nparts)
        self.nmesh = int(nmesh)
        self.plan = plan
        self.map_waves = int(map_waves)

    @property
    def sub_waves(self) -> int:
        """Consumer rounds: the nparts partitions stream through the
        device in ceil(nparts / nmesh) waves."""
        return (self.nparts + self.nmesh - 1) // self.nmesh

    def gather(self, mesh) -> None:
        """Nothing to gather: every rank wrote every partition."""

    def frames_for(self, partition: int) -> List[Frame]:
        return self.exchange.read_partition(partition)

    def discard(self) -> None:
        self.exchange.discard()
