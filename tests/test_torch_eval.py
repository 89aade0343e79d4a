"""tests/test_eval.py's ten cases through the port's evaluator.

A stub executor that only flips task states drives the port's DAG state
machine (``bigslice_tpu_torch/exec/evaluate.py``) directly: the chain
order, the error, lost-task resubmission, the consecutive-loss cap, a
lost dependency, concurrent evaluations, a random-loss stress run, the
deep and wide scales and the local pool's thread bound. Beside them,
the evaluator's observability hooks (the drain-timeout census, a
raising monitor) and ``Result.reader``'s streaming, each held to the
JAX package's behavior where it has one.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bigslice_tpu_torch.exec import evaluate as evaluate_mod  # noqa: E402
from bigslice_tpu_torch.exec.evaluate import (  # noqa: E402
    MAX_CONSECUTIVE_LOST,
    evaluate,
)
from bigslice_tpu_torch.exec.task import (  # noqa: E402
    Partitioner,
    Task,
    TaskDep,
    TaskError,
    TaskName,
    TaskState,
)


def make_task(op, shard=0, num_shard=1, deps=()):
    return Task(
        name=TaskName(1, op, shard, num_shard),
        do=lambda factories: iter(()),
        deps=deps,
        partitioner=Partitioner(),
        schema=None,
    )


def chain(n):
    """t0 <- t1 <- ... <- t(n-1); returns tasks root-last."""
    tasks = [make_task("t0")]
    for i in range(1, n):
        tasks.append(
            make_task(f"t{i}", deps=[TaskDep((tasks[-1],), 0)])
        )
    return tasks


class StubExecutor:
    """Flips submitted tasks to a scripted state (exec/eval_test.go:25-54)."""

    def __init__(self, policy=None):
        self.policy = policy or (lambda task, attempt: TaskState.OK)
        self.attempts = {}
        self.lock = threading.Lock()

    def submit(self, task):
        def run():
            with self.lock:
                n = self.attempts.get(str(task.name), 0)
                self.attempts[str(task.name)] = n + 1
            if not task.transition_if(TaskState.WAITING, TaskState.RUNNING):
                return
            state = self.policy(task, n)
            if state == TaskState.OK:
                task.mark_ok()
            elif state == TaskState.LOST:
                task.mark_lost(RuntimeError("stub lost"))
            else:
                task.set_state(state, RuntimeError("stub error"))

        threading.Thread(target=run, daemon=True).start()


def test_chain_evaluates_in_order():
    tasks = chain(4)
    done = []
    ex = StubExecutor()
    orig = ex.policy

    def policy(task, attempt):
        done.append(task.name.op)
        return orig(task, attempt)

    ex.policy = policy
    evaluate(ex, [tasks[-1]])
    assert all(t.state == TaskState.OK for t in tasks)
    assert done.index("t0") < done.index("t1") < done.index("t3")


def test_error_propagates():
    tasks = chain(3)

    def policy(task, attempt):
        if task.name.op == "t1":
            return TaskState.ERR
        return TaskState.OK

    with pytest.raises(TaskError):
        evaluate(StubExecutor(policy), [tasks[-1]])
    assert tasks[1].state == TaskState.ERR


def test_lost_task_resubmitted():
    tasks = chain(2)

    def policy(task, attempt):
        if task.name.op == "t1" and attempt < 2:
            return TaskState.LOST
        return TaskState.OK

    ex = StubExecutor(policy)
    evaluate(ex, [tasks[-1]])
    assert ex.attempts["inv1/t1@1:0"] == 3
    assert tasks[-1].state == TaskState.OK


def test_consecutive_lost_cap():
    tasks = chain(1)
    ex = StubExecutor(lambda task, attempt: TaskState.LOST)
    with pytest.raises(TaskError) as ei:
        evaluate(ex, [tasks[-1]])
    assert "consecutive" in str(ei.value)
    assert ex.attempts["inv1/t0@1:0"] == MAX_CONSECUTIVE_LOST


def test_lost_dep_reruns_producer():
    """A task whose dep output vanished marks the dep LOST; the evaluator
    re-runs the producer then the consumer (exec/eval.go:112-115)."""
    t0 = make_task("t0")
    t1 = make_task("t1", deps=[TaskDep((t0,), 0)])
    state = {"sabotaged": False}

    def policy(task, attempt):
        if task.name.op == "t1" and not state["sabotaged"]:
            state["sabotaged"] = True
            t0.mark_lost(RuntimeError("output vanished"))
            return TaskState.LOST
        return TaskState.OK

    ex = StubExecutor(policy)
    evaluate(ex, [t1])
    assert ex.attempts["inv1/t0@1:0"] == 2
    assert ex.attempts["inv1/t1@1:0"] == 2
    assert t1.state == TaskState.OK


def test_concurrent_evaluations_share_tasks():
    """Two evals over overlapping graphs coordinate via task state
    (exec/eval.go:126-135)."""
    shared = chain(3)
    ex = StubExecutor()
    errs = []

    def run_eval():
        try:
            evaluate(ex, [shared[-1]])
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=run_eval) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errs
    assert all(t.state == TaskState.OK for t in shared)
    # Each task ran exactly once despite 4 concurrent evaluations.
    assert all(n == 1 for n in ex.attempts.values())


def test_stress_random_loss():
    """Randomized task loss must still converge (evalstress_test.go)."""
    rng = np.random.RandomState(0)

    # Diamond-heavy DAG: layers of tasks each depending on all previous
    # layer's tasks.
    layers = [[make_task("l0s%d" % i) for i in range(3)]]
    for li in range(1, 4):
        prev = layers[-1]
        layers.append([
            make_task(
                "l%ds%d" % (li, i),
                deps=[TaskDep(tuple(prev), i % 1)],
            )
            for i in range(3)
        ])
    roots = layers[-1]

    def policy(task, attempt):
        # 30% loss, but never more than 3 consecutive (cap is 5).
        if attempt < 3 and rng.rand() < 0.3:
            return TaskState.LOST
        return TaskState.OK

    evaluate(StubExecutor(policy), roots)
    assert all(t.state == TaskState.OK for l in layers for t in l)


class _InstantExecutor:
    def submit(self, task):
        if task.transition_if(TaskState.WAITING, TaskState.RUNNING):
            task.mark_ok()


def _chain(n):
    prev, tasks = None, []
    for i in range(n):
        deps = [TaskDep((prev,), 0)] if prev is not None else []
        t = Task(TaskName(1, f"c{i}", 0, 1), lambda f: iter(()), deps,
                 Partitioner(), None)
        tasks.append(t)
        prev = t
    return tasks


def test_eval_deep_chain_scales():
    """10k chained tasks evaluate in O(n) events — no recursion-depth
    blowup (iter_tasks is iterative) and no quadratic rescans (the old
    evaluator needed >60s here; the waitlist loop takes <5s)."""
    import time

    tasks = _chain(10000)
    t0 = time.perf_counter()
    evaluate(_InstantExecutor(), [tasks[-1]])
    dt = time.perf_counter() - t0
    assert all(t.state == TaskState.OK for t in tasks)
    assert dt < 15.0, f"evaluator too slow on deep chain: {dt:.1f}s"


def test_eval_wide_fanin_scales():
    width, layers = 60, 60
    below = [Task(TaskName(1, f"w0s{i}", i, width), lambda f: iter(()),
                  [], Partitioner(), None) for i in range(width)]
    all_tasks = list(below)
    for L in range(1, layers):
        row = [Task(TaskName(1, f"w{L}s{i}", i, width),
                    lambda f: iter(()), [TaskDep(tuple(below), i)],
                    Partitioner(), None) for i in range(width)]
        all_tasks += row
        below = row
    evaluate(_InstantExecutor(), below)
    assert all(t.state == TaskState.OK for t in all_tasks)


def test_local_pool_bounds_threads():
    """Many more shards than procs run through a bounded worker pool,
    not one OS thread per task."""
    import threading
    import time

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.session import Session

    sess = Session(executor=bs.LocalExecutor(procs=3, device="cpu"))
    base = threading.active_count()
    peak = [0]
    stop = []

    def watch():
        while not stop:
            peak[0] = max(peak[0], threading.active_count())
            time.sleep(0.002)

    w = threading.Thread(target=watch, daemon=True)
    w.start()
    res = sess.run(bs.Map(bs.Const(48, np.arange(96, dtype=np.int32)),
                          lambda x: x * 2))
    stop.append(1)
    w.join(timeout=5)
    assert sorted(res.rows()) == [(2 * i,) for i in range(96)]
    # watcher itself +3 workers + small slack for unrelated threads
    assert peak[0] <= base + 3 + 2, (peak[0], base)


# ---------------------------------------------- observability hooks


def test_drain_timeout_reports_wedged_tasks(monkeypatch):
    """A failed evaluation whose in-flight task never settles drains
    for DRAIN_SECS, then names the wedged task to a monitor that opts in
    with on_drain_timeout (the telemetry hub's channel)."""
    monkeypatch.setattr(evaluate_mod, "DRAIN_SECS", 0.3)
    bad = make_task("bad")
    hung = make_task("hung")

    class Wedging:
        def submit(self, task):
            if not task.transition_if(TaskState.WAITING, TaskState.RUNNING):
                return
            if task is bad:
                threading.Timer(0.05, lambda: task.set_state(
                    TaskState.ERR, RuntimeError("boom"))).start()
            # ``hung`` stays RUNNING for good.

    census = []

    class Monitor:
        def __call__(self, task, state):
            pass

        def on_drain_timeout(self, wedged):
            census.append(wedged)

    with pytest.raises(TaskError):
        evaluate(Wedging(), [bad, hung], monitor=Monitor())
    assert census == [[{"task": str(hung.name), "state": "RUNNING"}]]


def test_raising_monitor_never_fails_a_task(capsys):
    """A monitor that raises on every transition is logged once and the
    evaluation completes, as in the JAX package's evaluator."""
    from bigslice_tpu.exec.evaluate import evaluate as ref_evaluate
    from bigslice_tpu.exec.task import Partitioner as RefPartitioner
    from bigslice_tpu.exec.task import Task as RefTask
    from bigslice_tpu.exec.task import TaskDep as RefDep
    from bigslice_tpu.exec.task import TaskName as RefName
    from bigslice_tpu.exec.task import TaskState as RefState

    class Raises:
        def __call__(self, task, state):
            raise RuntimeError("broken monitor")

    class Instant:
        def __init__(self, states):
            self.states = states

        def submit(self, task):
            if task.transition_if(self.states.WAITING,
                                  self.states.RUNNING):
                task.mark_ok()

    tasks = chain(3)
    evaluate(Instant(TaskState), [tasks[-1]], monitor=Raises())
    assert all(t.state == TaskState.OK for t in tasks)
    ours = capsys.readouterr().err

    prev = None
    ref_tasks = []
    for i in range(3):
        t = RefTask(RefName(1, f"t{i}", 0, 1), lambda f: iter(()),
                    [RefDep((prev,), 0)] if prev is not None else [],
                    RefPartitioner(), None)
        ref_tasks.append(t)
        prev = t
    ref_evaluate(Instant(RefState), [ref_tasks[-1]], monitor=Raises())
    assert all(t.state == RefState.OK for t in ref_tasks)
    theirs = capsys.readouterr().err
    for err in (ours, theirs):
        assert err.count("raised (suppressed") == 1
        assert "broken monitor" in err


# ------------------------------------------- Result.reader streams


def test_result_reader_streams_frames():
    """Result.reader yields each stored frame as the store yields it:
    a store that counts the frames it has handed out but the reader has
    not yet passed on holds one open at a time, never the shard."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec import store as store_mod

    class CountingStore(store_mod.MemoryStore):
        def __init__(self):
            super().__init__()
            self.out = 0
            self.peak = 0

        def read(self, name, partition):
            inner = super().read(name, partition)

            def gen():
                for f in inner:
                    self.out += 1
                    self.peak = max(self.peak, self.out)
                    yield f

            return gen()

    def batches(shard):
        for b in range(6):
            yield (np.arange(b * 10, b * 10 + 10, dtype=np.int32),)

    store = CountingStore()
    sess = bs.Session(executor=bs.LocalExecutor(device="cpu", store=store))
    res = sess.run(bs.ReaderFunc(1, batches, out=[np.int32]))
    rows = []
    for f in res.reader(0, ()):
        rows.extend(f.rows())
        store.out -= 1  # this frame is passed on
    assert [r[0] for r in rows] == list(range(60))
    assert store.peak == 1
