"""tests/test_executor_parity.py's combinator sweep through the port.

Every pipeline of the JAX package's sweep but ``attend`` (``SelfAttend``
is not ported) runs through the port's ``LocalExecutor``, its
``MeshExecutor`` at the default (auto-dense discovery on), at
``auto_dense=False`` and with ``machine_combiners=True``, all on the
CPU, and must equal the JAX package's ``LocalExecutor`` under the sweep's
own ``_normalize``. The device executor runs what it cannot lower on its
host tier, so the sweep also holds host-tier chains (word count, and a
host Map feeding a device Reduce feeding a host Map) against the JAX
package.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import bigslice_tpu as ref_bs  # noqa: E402
from test_executor_parity import _KEYS, _VALS, _FLOATS, _normalize  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402


def _pipelines(bs, mod):
    def src():
        return bs.Const(8, _KEYS, _VALS)

    return {
        "map": lambda: bs.Map(src(), lambda k, v: (k, v * 2)),
        "filter": lambda: bs.Filter(src(), lambda k, v: k % 3 == 0),
        "reduce": lambda: bs.Reduce(src(), lambda a, b: a + b),
        "reduce-max": lambda: bs.Reduce(
            src(), lambda a, b: mod.maximum(a, b)),
        "reduce-dense": lambda: bs.Reduce(
            src(), lambda a, b: a + b, dense_keys=23),
        "fold": lambda: bs.Fold(
            src(), lambda acc, v: acc + v, init=0, out_value=np.int32),
        "head": lambda: bs.Head(src(), 3),
        "reshuffle": lambda: bs.Reshuffle(src()),
        "cogroup-1": lambda: bs.Cogroup(src()),
        "cogroup-2": lambda: bs.Cogroup(
            src(), bs.Const(8, _KEYS[:200], _FLOATS[:200])),
        "cogroup-waved": lambda: bs.Cogroup(
            bs.Const(12, _KEYS, _VALS),
            bs.Const(12, _KEYS[:200], _FLOATS[:200])),
        "groupby": lambda: bs.GroupByKey(src(), capacity=64),
        "join": lambda: bs.JoinAggregate(
            src(), bs.Const(8, _KEYS[::-1], _VALS[::-1]),
            lambda a, b: a + b, lambda a, b: a + b),
        "chain": lambda: bs.Reduce(
            bs.Map(bs.Filter(src(), lambda k, v: v >= 0),
                   lambda k, v: (k % 5, v)),
            lambda a, b: a + b),
    }


PIPELINES = sorted(_pipelines(bst, torch))

#: The port's executors, each a Session factory.
EXECUTORS = {
    "local": lambda: bst.Session(executor=bst.LocalExecutor(device="cpu")),
    "mesh": lambda: bst.Session(executor=bst.MeshExecutor(device="cpu")),
    "mesh-sort": lambda: bst.Session(
        executor=bst.MeshExecutor(device="cpu", auto_dense=False)),
    "mesh-mc": lambda: bst.Session(
        executor=bst.MeshExecutor(device="cpu"), machine_combiners=True),
}

_WANT = {}


def _want(name):
    """The JAX package's LocalExecutor result, computed once a pipeline."""
    if name not in _WANT:
        from bigslice_tpu.exec.session import Session

        sess = Session()
        try:
            rows = list(sess.run(_pipelines(ref_bs, jnp)[name]()).rows())
        finally:
            sess.shutdown()
        _WANT[name] = _normalize(name, rows)
    return _WANT[name]


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
@pytest.mark.parametrize("name", PIPELINES)
def test_combinator_matches_across_executors(name, executor):
    sess = EXECUTORS[executor]()
    try:
        rows = list(sess.run(_pipelines(bst, torch)[name]()).rows())
    finally:
        sess.shutdown()
    assert _normalize(name, rows) == _want(name), (
        f"{name}: {executor} result diverges from the JAX package's local")


def _corpus(tmp_path):
    rng = np.random.RandomState(23)
    words = [f"w{int(i)}" for i in rng.zipf(1.5, 3000) % 97]
    path = os.path.join(str(tmp_path), "corpus.txt")
    with open(path, "w") as fh:
        for i in range(0, len(words), 7):
            fh.write(" ".join(words[i:i + 7]) + "\n")
    return path, words


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
@pytest.mark.parametrize("chain", ["wordcount", "mixed", "fused"])
def test_host_tier_chains_match_jax(tmp_path, chain, executor):
    """Word count (ScanReader, host Flatmap and Map, a Reduce over str
    keys); a host Map over ScanReader lines to int32 ids (host to
    device), a device Reduce, then a host Map over its result (device to
    host); and a host Map fused after a Reduce, whose device producers
    feed a host consumer (with machine combiners, through the store
    bridge): equal to the JAX package's LocalExecutor and to Python."""
    from collections import Counter

    from bigslice_tpu.exec.session import Session
    from bigslice_tpu.models import wordcount as ref_wc
    from bigslice_tpu_torch.models import wordcount as port_wc

    path, words = _corpus(tmp_path)

    def run(sess, bs, wc):
        if chain == "wordcount":
            rows = sess.run(wc.wordcount(3, path)).rows()
        elif chain == "fused":
            red = bs.Reduce(bs.Const(4, _KEYS, np.ones(len(_KEYS), np.int32)),
                            lambda a, b: a + b)
            rows = sess.run(bs.Map(red, lambda k, n: (f"id{int(k)}",
                                                      int(n) * 2),
                                   out=[str, np.int32])).rows()
        else:
            ids = bs.Map(bs.ScanReader(3, path),
                         lambda line: (sum(map(ord, line)) % 64, 1),
                         out=[np.int32, np.int32])
            res = sess.run(bs.Reduce(ids, lambda a, b: a + b))
            rows = sess.run(bs.Map(res, lambda k, n: (f"id{int(k)}",
                                                      int(n) * 2),
                                   out=[str, np.int32])).rows()
        return sorted((str(k), int(v)) for k, v in rows)

    ref = Session()
    try:
        want = run(ref, ref_bs, ref_wc)
    finally:
        ref.shutdown()
    sess = EXECUTORS[executor]()
    try:
        got = run(sess, bst, port_wc)
        if chain != "wordcount" and executor.startswith("mesh"):
            # One group ran on the device path: the Reduce between two
            # host tiers, or the fused chain's producers.
            assert len(sess.executor._outputs) == 1
    finally:
        sess.shutdown()
    assert got == want
    if chain == "wordcount":
        assert dict(got) == dict(Counter(words))
    elif chain == "fused":
        assert dict(got) == {f"id{k}": 2 * n
                             for k, n in Counter(_KEYS.tolist()).items()}
    else:
        nlines = len(open(path).read().splitlines())
        assert sum(n for _, n in got) == 2 * nlines
