"""Session: compile and evaluate slices, and read their results.

``Session()`` runs on the device executor over ``cuda`` (its host tier,
an inner local executor, runs what the device path cannot lower);
``Session(parallelism=N)`` on the local executor with N task threads,
also over ``cuda``. ``Session(executor=MeshExecutor(device="cpu"))`` or
``Session(executor=LocalExecutor(device="cpu"))`` runs the same paths
on the CPU through the kernels' plain versions, as the tests do.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence, Tuple

from bigslice_tpu_torch import sliceio, typecheck
from bigslice_tpu_torch.exec import compile as compile_mod
from bigslice_tpu_torch.exec import shuffleplan
from bigslice_tpu_torch.exec.evaluate import MAX_CONSECUTIVE_LOST, evaluate
from bigslice_tpu_torch.exec.store import Missing
from bigslice_tpu_torch.exec.task import Task, TaskState
from bigslice_tpu_torch.ops.base import Slice, make_name
from bigslice_tpu_torch.ops.func import Func, invocation_counter


class _InvocationGate:
    """Reader-writer isolation of runs: plain runs share the session
    (readers); an exclusive Func's run takes it alone (the writer),
    its own shards still running in parallel."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False

    def acquire(self, exclusive: bool) -> None:
        with self._cond:
            if exclusive:
                self._cond.wait_for(
                    lambda: not self._writer and self._readers == 0)
                self._writer = True
            else:
                self._cond.wait_for(lambda: not self._writer)
                self._readers += 1

    def release(self, exclusive: bool) -> None:
        with self._cond:
            if exclusive:
                self._writer = False
            else:
                self._readers -= 1
            self._cond.notify_all()


class Result(Slice):
    """A computed slice: the output of a session run, one task per
    shard. Reading re-evaluates lost tasks first."""

    def __init__(self, session: "Session", slice_: Slice,
                 tasks: Sequence[Task]):
        super().__init__(slice_.schema, len(tasks), make_name("result"))
        self.session = session
        self.tasks = list(tasks)

    def reader(self, shard: int, deps) -> sliceio.Reader:
        task = self.tasks[shard]

        def read():
            # Re-evaluate-before-read with retry: an output that vanished
            # between evaluation and the scan re-runs its producers.
            last = None
            for _ in range(MAX_CONSECUTIVE_LOST):
                if task.state != TaskState.OK:
                    evaluate(self.session.executor, [task])
                try:
                    frames = list(self.session.executor.reader(task, 0))
                except Missing as e:
                    last = e
                    task.mark_lost(e)
                    continue
                yield from frames
                return
            raise last

        return read()

    def frames(self) -> sliceio.Reader:
        for shard in range(self.num_shards):
            yield from self.reader(shard, ())

    def rows(self) -> List[Tuple]:
        out: List[Tuple] = []
        for f in self.frames():
            out.extend(f.rows())
        return out

    def discard(self) -> None:
        """Drop stored task outputs."""
        for t in self.tasks:
            self.session.executor.discard(t)


class Session:
    """Compiles and evaluates slices on one executor.

    - ``executor``: with none, ``MeshExecutor()``, or with
      ``parallelism`` set, ``LocalExecutor(procs=parallelism)``; both
      run on ``cuda`` and raise at construction when there is no GPU.
      (The JAX package's default is the local executor.)
    - ``parallelism``: the local executor's task threads.
    - ``monitor``: ``monitor(task, state)`` on every task transition.
    - ``machine_combiners``: the producer tasks of a combining shuffle
      share one combiner buffer a partition, combined once when the
      last lands: fewer, larger combines, at the cost of retrying the
      whole producer group when one of its outputs is lost.
    """

    def __init__(self, executor=None, parallelism: Optional[int] = None,
                 monitor=None, machine_combiners: bool = False):
        if executor is None:
            if parallelism is not None:
                from bigslice_tpu_torch.exec.local import LocalExecutor

                executor = LocalExecutor(procs=parallelism)
            else:
                from bigslice_tpu_torch.exec.meshexec import MeshExecutor

                executor = MeshExecutor()
        self.executor = executor
        self.monitor = monitor
        self.machine_combiners = machine_combiners
        self._gate = _InvocationGate()

    def shutdown(self) -> None:
        """Release the executor's resources (its private spill
        directory)."""
        close = getattr(self.executor, "close", None)
        if close is not None:
            close()

    def run(self, func: Any, *args) -> Result:
        """Compile and evaluate ``func(*args)``: ``func`` is a registered
        ``Func`` (invoked; an exclusive one's run takes the session
        alone), a Slice, or a callable returning one."""
        exclusive = False
        if isinstance(func, Func):
            inv = func.invocation(*args)
            slice_ = inv.invoke()
            inv_index = inv.index
            exclusive = func.exclusive
        elif isinstance(func, Slice):
            typecheck.check(not args, "run: args given with a literal slice")
            slice_ = func
            inv_index = next(invocation_counter)
        elif callable(func):
            slice_ = func(*args)
            typecheck.check(
                isinstance(slice_, Slice),
                "run: callable returned %s, expected a Slice",
                type(slice_).__name__,
            )
            inv_index = next(invocation_counter)
        else:
            raise typecheck.errorf(
                "run: expected Func, Slice or callable, got %s",
                type(func).__name__,
            )
        tasks = compile_mod.Compiler(
            inv_index, shuffle_mode=shuffleplan.plan_mode() or "",
            machine_combiners=self.machine_combiners,
        ).compile(slice_)
        self._gate.acquire(exclusive)
        try:
            evaluate(self.executor, tasks, monitor=self.monitor)
        finally:
            self._gate.release(exclusive)
        return Result(self, slice_, tasks)
