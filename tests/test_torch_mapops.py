"""Map, Filter, Flatmap, Head, Reshuffle and Repartition in the port:
their tier verdicts (meta-tensor traces) against the JAX package's
(``jax.eval_shape``), their schemas, and the task graphs the two
planners build for them (``graph_string(locations=False)``). Also the
device executor's host tier running host-tier stages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.exec import compile as ref_compile  # noqa: E402
import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch import typecheck  # noqa: E402
from bigslice_tpu_torch.exec import compile as port_compile  # noqa: E402
from bigslice_tpu_torch.exec.task import TaskError  # noqa: E402
from bigslice_tpu_torch.ops.reshuffle import RowPartitioner  # noqa: E402

KEYS = np.arange(40, dtype=np.int32) % 9
VALS = np.arange(40, dtype=np.float32)

#: Mode names: the JAX package's "jax" tier is the port's "device".
MODE = {"jax": "device", "host": "host"}


def _expand(mod):
    def f(k, v):
        if mod is jnp:
            mask = jnp.array([True, False]) | (k % 2 == 0)
        else:
            mask = torch.tensor([True, False], device=k.device) | (k % 2 == 0)
        return mask, mod.stack([k, k + 100]), mod.stack([v, v * 2])
    return f


def _pipelines(bs, mod):
    """name -> slice, the same pipeline in either package's API."""
    def src(n=4):
        return bs.Const(n, KEYS, VALS)

    return {
        "map": bs.Map(src(), lambda k, v: (k * 2, v + 1)),
        "map_args": bs.Map(src(), lambda k, v, a: (k + a, v), args=(3,)),
        "filter": bs.Filter(src(), lambda k, v: v > 10),
        "flatmap": bs.Flatmap(src(), _expand(mod), out=[np.int32,
                                                        np.float32],
                              fanout=2),
        "head": bs.Head(src(), 3),
        "reshuffle": bs.Reshuffle(src()),
        "repartition": bs.Repartition(src(), lambda k, n: k % n),
        "map_filter_reduce": bs.Reduce(
            bs.Filter(bs.Map(src(), lambda k, v: (k & 3, v)),
                      lambda k, v: v >= 0),
            lambda a, b: a + b),
        "head_reduce": bs.Reduce(bs.Head(src(), 5), lambda a, b: a + b),
        "reshuffle_map": bs.Map(bs.Reshuffle(src(5)), lambda k, v: (k, v)),
    }


NAMES = sorted(_pipelines(bst, torch))


@pytest.mark.parametrize("name", NAMES)
def test_task_graphs_match_reference(name):
    ref = _pipelines(ref_bs, jnp)[name]
    port = _pipelines(bst, torch)[name]
    want = ref_compile.graph_string(ref_compile.compile_slice(ref, 1),
                                    locations=False)
    got = port_compile.graph_string(port_compile.compile_slice(port, 1),
                                    locations=False)
    assert got == want
    assert [str(c) for c in port.schema] == [str(c) for c in ref.schema]
    assert port.schema.prefix == ref.schema.prefix
    if hasattr(ref, "mode"):
        assert port.mode == MODE[ref.mode]


@pytest.mark.parametrize("case", ["device", "host", "item", "branch"])
def test_map_tier_verdicts_match_reference(case):
    fns = {
        "device": (lambda k, v: k + 1, lambda k, v: k + 1),
        "host": (lambda k, v: str(k), lambda k, v: str(k)),
        "item": (lambda k, v: k + int(k), lambda k, v: k + k.item()),
        "branch": (lambda k, v: k if k > 0 else -k,
                   lambda k, v: k if k > 0 else -k),
    }
    rfn, pfn = fns[case]
    ref = ref_bs.Map(ref_bs.Const(2, KEYS, VALS), rfn, out=[np.int32])
    port = bst.Map(bst.Const(2, KEYS, VALS), pfn, out=[np.int32])
    assert port.mode == MODE[ref.mode]


@pytest.mark.parametrize("case", ["device", "host"])
def test_filter_tier_verdicts_match_reference(case):
    fns = {"device": (lambda k, v: k > 3, lambda k, v: k > 3),
           "host": (lambda k, v: bool(k > 3), lambda k, v: bool(k > 3))}
    rfn, pfn = fns[case]
    ref = ref_bs.Filter(ref_bs.Const(2, KEYS, VALS), rfn)
    port = bst.Filter(bst.Const(2, KEYS, VALS), pfn)
    assert port.mode == MODE[ref.mode]


def test_flatmap_without_fanout_is_host_tier():
    fm = bst.Flatmap(bst.Const(2, KEYS), lambda k: [(k,)], out=[np.int32])
    ref = ref_bs.Flatmap(ref_bs.Const(2, KEYS), lambda k: [(k,)],
                         out=[np.int32])
    assert fm.mode == MODE[ref.mode] == "host"


def test_repartition_tiers():
    """A per-row device partitioner lowers into the shuffle; a frame-level
    host partitioner does not."""
    dev = bst.Repartition(bst.Const(2, KEYS), lambda k, n: k % n)
    host = bst.Repartition(bst.Const(2, KEYS),
                           lambda frame, n: np.zeros(len(frame), np.int32))
    assert isinstance(dev.partitioner, RowPartitioner)
    assert not isinstance(host.partitioner, RowPartitioner)
    ids = dev.partitioner.device_fn(4)(torch.from_numpy(KEYS))
    np.testing.assert_array_equal(ids.numpy(), KEYS % 4)


def test_construction_errors():
    src = bst.Const(2, KEYS, VALS)
    with pytest.raises(typecheck.TypecheckError):
        bst.Map(src, lambda k, v: str(k))  # host fn without out=
    with pytest.raises(typecheck.TypecheckError):
        bst.Filter(src, lambda k, v: k + 1)  # not a bool
    with pytest.raises(typecheck.TypecheckError):
        bst.Flatmap(src, lambda k, v: (k, v), out=[np.int32], fanout=2)
    with pytest.raises(typecheck.TypecheckError):
        bst.Map(src, lambda k, v: (k, v), out=[np.int32])  # 2 vs 1 cols


def test_map_casts_64_bit_outputs_down():
    """A device fn returning int64/float64 yields 32-bit columns, as
    frames cast 64-bit inputs on entry."""
    m = bst.Map(bst.Const(2, KEYS, VALS),
                lambda k, v: (k.to(torch.int64), v.to(torch.float64)))
    assert [str(c) for c in m.schema] == ["int32", "float32"]
    sess = bst.Session(executor=bst.MeshExecutor(device="cpu"))
    rows = sorted(sess.run(m).rows())
    assert rows == sorted(zip(KEYS.tolist(), VALS.tolist()))


@pytest.mark.parametrize("what", ["map", "filter", "flatmap", "partition"])
def test_executor_refuses_host_tier_stages(what):
    """A host-tier stage (a host fn, a frame-level partitioner) runs on
    the device executor's host tier, its inner LocalExecutor, as on the
    JAX package's MeshExecutor: each shard's rows equal the JAX
    package's, and the host fns saw plain Python scalars."""
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor as RefMesh

    def build(bs):
        src = bs.Const(2, KEYS, VALS)
        return {
            "map": lambda: bs.Map(src, lambda k, v: (int(k), float(v) * 2),
                                  out=[np.int32, np.float32]),
            "filter": lambda: bs.Filter(src, lambda k, v: bool(k > 3)),
            "flatmap": lambda: bs.Flatmap(
                src, lambda k, v: [(k, v), (k + 1, v)],
                out=[np.int32, np.float32]),
            "partition": lambda: bs.Repartition(
                src, lambda frame, n: np.asarray(frame.cols[0]) % n),
        }[what]()

    ref = ref_bs.exec.session.Session(executor=RefMesh(
        Mesh(np.array(jax.devices()[:1]), ("shards",))))
    want = bst.result_shard_rows(ref.run(build(ref_bs)))
    sess = bst.Session(executor=bst.MeshExecutor(device="cpu"))
    got = bst.result_shard_rows(sess.run(build(bst)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            np.testing.assert_array_equal(gc, wc)
    assert sum(len(g[0]) for g in got) > 0


def test_out_of_range_partition_ids_raise():
    """Partitioner ids outside [0, nparts) are a user error, raised,
    never retried with slack or dropped silently."""
    sl = bst.Repartition(bst.Const(3, KEYS, VALS), lambda k, n: k - 2)
    sess = bst.Session(executor=bst.MeshExecutor(device="cpu"))
    with pytest.raises(TaskError) as ei:
        sess.run(sl)
    assert isinstance(ei.value.cause, ValueError)
    assert "outside [0, 3)" in str(ei.value.cause)


@pytest.mark.parametrize("out", [None, [np.int32, np.float32],
                                 [np.int32, np.int32]],
                         ids=["auto", "float-out", "int-out"])
def test_literal_output_broadcasts_on_the_device_tier(out):
    """A device Map returning a Python literal broadcasts it to every row
    in the declared out= dtype (int32 without one), as JAX's vmap does:
    the tier verdict and the schema are jax.eval_shape's, and the
    literal's column runs on the device executor."""
    import jax

    from bigslice_tpu.ops import mapops as ref_mapops

    ref = ref_bs.Map(ref_bs.Const(2, KEYS, VALS), lambda k, v: (k, 1),
                     out=out)
    port = bst.Map(bst.Const(2, KEYS, VALS), lambda k, v: (k, 1), out=out)
    assert port.mode == MODE[ref.mode] == "device"
    assert [str(c) for c in port.schema] == [str(c) for c in ref.schema]
    shapes = jax.eval_shape(lambda k: (k, 1),
                            jax.ShapeDtypeStruct((), np.int32))
    assert ref_mapops._try_trace(lambda k, v: (k, 1),
                                 ref_bs.Const(2, KEYS, VALS).schema) \
        .cols[1].dtype == np.dtype(shapes[1].dtype)
    sess = bst.Session(executor=bst.MeshExecutor(device="cpu"))
    rows = sorted(sess.run(port).rows())
    assert rows == sorted((int(k), 1) for k in KEYS)
    assert all(type(r[1]) is (float if out and out[1] is np.float32
                              else int) for r in rows)
