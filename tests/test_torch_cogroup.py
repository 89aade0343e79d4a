"""The general Cogroup in the port against the JAX package.

The aligner ``parallel/cogroup.make_cogroup_align`` against the JAX
function on the same masked inputs (run under ``jax.vmap`` with a named
axis, since it takes a ``lax.pmax``): the JAX function returns its rows
in the sorted row space with a head mask; the port returns the head
rows already compacted, in union-key space. So the port's rows equal
the reference's head rows, in order: keys, every [·, G] matrix, every
count, and the deficit, for G below and above the biggest group.

Whole Cogroups through the port's device executor (on the CPU) against
the JAX package's MeshExecutor, per output shard: keys exact, and each
list cell equal element for element, as numpy scalars of the same
dtype (float payloads bit for bit: they only move in the sort, so no
tolerance is needed). The order within each list is the order of
arrival after the shuffle, which both packages keep with a stable sort:
the 8-device mesh delivers rows by source device (the source shard,
with S <= 8) and the port's single lane by source wave (also the
source shard), so lists are compared exactly against both meshes.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.exec import compile as ref_compile  # noqa: E402
from bigslice_tpu.frame import ops as ref_ops  # noqa: E402
from bigslice_tpu.parallel import cogroup as ref_cogroup  # noqa: E402
import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.exec import compile as port_compile  # noqa: E402
from bigslice_tpu_torch.exec import shuffleplan  # noqa: E402
from bigslice_tpu_torch.exec.meshexec import COGROUP_DEFAULT_CAP  # noqa: E402
from bigslice_tpu_torch.frame import codec  # noqa: E402
from bigslice_tpu_torch.frame import ops as port_ops  # noqa: E402
from bigslice_tpu_torch.frame.frame import Frame  # noqa: E402
from bigslice_tpu_torch.parallel import cogroup as port_cogroup  # noqa: E402
from bigslice_tpu_torch.parallel.jitutil import bucket_size  # noqa: E402
from bigslice_tpu_torch.slicetype import ColType  # noqa: E402


def _ref_session(ndev):
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    mesh = Mesh(np.array(jax.devices()[:ndev]), ("shards",))
    return Session(executor=MeshExecutor(mesh, auto_dense=False,
                                         hash_aggregate=True))


@pytest.fixture(scope="module", params=[8, 1], ids=["mesh8", "mesh1"])
def ref_session(request):
    return _ref_session(request.param)


@pytest.fixture(autouse=True)
def _no_shuffle_env(monkeypatch):
    monkeypatch.delenv("BIGSLICE_SHUFFLE", raising=False)
    monkeypatch.delenv("BIGSLICE_SPILL_BUDGET_BYTES", raising=False)
    monkeypatch.delenv("BIGSLICE_SPILL_DIR", raising=False)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same_cells(g, w):
    """Two object columns of lists: equal lengths, element types and
    values (floats bit for bit)."""
    assert len(g) == len(w)
    for gl, wl in zip(g, w):
        assert isinstance(gl, list) and isinstance(wl, list)
        assert [type(x) for x in gl] == [type(x) for x in wl]
        if gl:
            np.testing.assert_array_equal(_bits(np.array(gl)),
                                          _bits(np.array(wl)))


def _same_shards(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [c.dtype for c in g] == [c.dtype for c in w]
        for gc, wc in zip(g, w):
            if gc.dtype == np.dtype(object):
                _same_cells(gc, wc)
            else:
                np.testing.assert_array_equal(_bits(gc), _bits(wc))


def _port(build, **ex):
    sess = bst.Session(executor=bst.MeshExecutor(device="cpu", **ex))
    res = sess.run(build(bst))
    return sess, res


def _run_both(ref_session, build, **ex):
    sess, res = _port(build, **ex)
    ref = ref_session.run(build(ref_bs))
    got = bst.result_shard_rows(res)
    _same_shards(got, bst.result_shard_rows(ref))
    return sess, got, ref_session.executor


def _groups(keys, vals):
    out = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        out.setdefault(k, []).append(v)
    return out


def _rows(shards):
    return [row for sh in shards for row in zip(*sh)]


def _check_oracle(shards, inputs):
    """Every key of the union once; each list the key's values of that
    input, in input order (one lane, stable sorts, shards in order)."""
    rows = _rows(shards)
    oracles = [[_groups(k, v) for v in vals] for k, vals in inputs]
    keys = set()
    for (k, _vals), _ in zip(inputs, oracles):
        keys |= set(k.tolist())
    got_keys = [int(r[0]) for r in rows]
    assert sorted(got_keys) == sorted(keys)
    for r in rows:
        k = int(r[0])
        cells = list(r[1:])
        for og in oracles:
            for o in og:
                cell = cells.pop(0)
                assert [x.item() for x in cell] == o.get(k, [])


# -- the aligner against the JAX function ---------------------------------


def _align_inputs(case, ndeps, seed):
    rng = np.random.RandomState(seed)
    masks, col_sets, nvals = [], [], []
    for j in range(ndeps):
        n = [120, 90, 64][j]
        if case == "float":
            pool = np.array([0.0, -0.0, np.nan, 1.5, -2.25, np.inf, 3.0],
                            np.float32)
            keys = [pool[rng.randint(0, len(pool), n)]]
        elif case == "uint":
            keys = [(rng.randint(0, 30, n).astype(np.int64) * 7919
                     + 2**31).astype(np.uint32)]
        elif case == "multikey":
            keys = [rng.randint(0, 6, n).astype(np.int32),
                    rng.randint(0, 3, n).astype(np.int32)]
        else:
            keys = [rng.randint(0, 25, n).astype(np.int32)]
        vals = [rng.randint(-50, 50, n).astype(np.int32),
                rng.randn(n).astype(np.float32)][: 2 - j % 2]
        if j == 2:
            vals = [rng.rand(n) < 0.5]  # bool payload
        masks.append(rng.rand(n) < 0.85)
        col_sets.append(keys + vals)
        nvals.append(len(vals))
    return masks, col_sets, tuple(nvals)


def _ref_align(nk, nvals, G, masks, col_sets):
    import jax
    import jax.numpy as jnp

    align = ref_cogroup.make_cogroup_align(nk, nvals, G, "x")
    head, cols, deficit = jax.vmap(align, axis_name="x")(
        [jnp.asarray(m)[None] for m in masks],
        [[jnp.asarray(c)[None] for c in cs] for cs in col_sets])
    head = np.asarray(head[0])
    return head, [np.asarray(c[0]) for c in cols], int(deficit[0])


@pytest.mark.parametrize("case", ["int", "uint", "multikey", "float"])
@pytest.mark.parametrize("ndeps", [1, 2, 3])
@pytest.mark.parametrize("G", [4, 64])
def test_make_cogroup_align_matches_reference(case, ndeps, G):
    masks, col_sets, nvals = _align_inputs(case, ndeps, len(case) + ndeps)
    nk = 2 if case == "multikey" else 1
    head, rcols, rdef = _ref_align(nk, nvals, G, masks, col_sets)
    t = torch.from_numpy
    n, cols, deficit, width = port_cogroup.make_cogroup_align(nk, nvals, G)(
        [t(m) for m in masks], [[t(c) for c in cs] for cs in col_sets])
    assert int(n) == int(head.sum()) > 0 and width == G
    assert int(deficit) == rdef
    assert (rdef > 0) == (G == 4)
    assert len(cols) == len(rcols) == nk + sum(nvals) + len(nvals)
    for c, rc in zip(cols, rcols):
        c = c.numpy()
        assert c.dtype == rc.dtype
        np.testing.assert_array_equal(_bits(c), _bits(rc[head]))


def test_make_cogroup_align_empty_input():
    """An input with no rows: its matrices and counts are all zero, and
    the other input's groups are the reference's."""
    masks, col_sets, nvals = _align_inputs("int", 2, 3)
    masks[1] = masks[1][:0]
    col_sets[1] = [c[:0] for c in col_sets[1]]
    head, rcols, rdef = _ref_align(1, nvals, 16, masks, col_sets)
    t = torch.from_numpy
    n, cols, deficit, _ = port_cogroup.make_cogroup_align(1, nvals, 16)(
        [t(m) for m in masks], [[t(c) for c in cs] for cs in col_sets])
    assert int(n) == int(head.sum()) and int(deficit) == rdef == 0
    for c, rc in zip(cols, rcols):
        np.testing.assert_array_equal(_bits(c.numpy()), _bits(rc[head]))
    assert int(cols[-1].sum()) == 0


def test_ragged_from_padded_matches_reference():
    rng = np.random.RandomState(0)
    keys = np.arange(20, dtype=np.int32)
    cnt_a = rng.randint(0, 5, 20).astype(np.int32)
    cnt_b = rng.randint(0, 5, 20).astype(np.int32)
    ma = rng.randint(0, 9, (20, 4)).astype(np.int32)
    mb1 = rng.randn(20, 4).astype(np.float32)
    mb2 = (rng.randint(0, 2**32, (20, 4), dtype=np.int64)
           .astype(np.uint32))
    cols = [keys, ma, cnt_a, mb1, mb2, cnt_b]
    want = ref_cogroup.ragged_from_padded(1, (1, 2), cols)
    got = port_cogroup.ragged_from_padded(1, (1, 2), cols)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == np.dtype(object)
        _same_cells(g, w)


# -- whole Cogroups through both executors -------------------------------


@pytest.mark.parametrize("S", [1, 4, 8])
def test_two_input_cogroup(ref_session, S):
    rng = np.random.RandomState(S)
    ak = rng.randint(0, 40, 600).astype(np.int32)
    av = rng.randint(0, 100, 600).astype(np.int32)
    bk = rng.randint(20, 60, 500).astype(np.int32)
    bv = rng.randn(500).astype(np.float32)

    def build(bs):
        return bs.Cogroup(bs.Const(S, ak, av), bs.Const(S, bk, bv))

    sess, got, _ = _run_both(ref_session, build)
    assert len(got) == S
    _check_oracle(got, [(ak, [av]), (bk, [bv])])


def test_one_input_cogroup_several_value_columns(ref_session):
    rng = np.random.RandomState(11)
    k = rng.randint(0, 30, 800).astype(np.int32)
    v1 = rng.randint(-9, 9, 800).astype(np.int32)
    v2 = rng.randn(800).astype(np.float32)
    v3 = (rng.randint(0, 2**32, 800, dtype=np.int64).astype(np.uint32))
    v4 = rng.rand(800) < 0.3

    def build(bs):
        return bs.Cogroup(bs.Const(4, k, v1, v2, v3, v4))

    _, got, _ = _run_both(ref_session, build)
    _check_oracle(got, [(k, [v1, v2, v3, v4])])


def test_three_inputs_uneven_shards_and_one_sided_keys(ref_session):
    """Inputs with 4, 2 and 3 shards (num_shards is the largest); side A
    holds keys no other side has, side C keys only it has."""
    rng = np.random.RandomState(12)
    ak = rng.randint(0, 50, 400).astype(np.int32)
    bk = rng.randint(25, 75, 300).astype(np.int32)
    ck = rng.randint(100, 110, 90).astype(np.int32)
    av = rng.randint(0, 9, 400).astype(np.int32)
    bv = rng.randint(0, 9, 300).astype(np.int32)
    cv = rng.randn(90).astype(np.float32)

    def build(bs):
        return bs.Cogroup(bs.Const(4, ak, av), bs.Const(2, bk, bv),
                          bs.Const(3, ck, cv))

    _, got, _ = _run_both(ref_session, build)
    assert len(got) == 4
    _check_oracle(got, [(ak, [av]), (bk, [bv]), (ck, [cv])])
    empty = sum(1 for r in _rows(got) if not r[2])
    assert empty > 0  # keys of A or C only: B's list is empty


def test_cogroup_with_an_empty_input(ref_session):
    k = np.arange(60, dtype=np.int32) % 13
    v = np.arange(60, dtype=np.int32)
    e = np.zeros(0, np.int32)

    def build(bs):
        return bs.Cogroup(bs.Const(4, e, e), bs.Const(4, k, v))

    _, got, _ = _run_both(ref_session, build)
    rows = _rows(got)
    assert len(rows) == 13 and all(r[1] == [] for r in rows)


def test_cogroup_over_float_keys(ref_session):
    """+0.0 and -0.0 group together; every NaN key is a group of its
    own, as lax.sort's order and != make them."""
    rng = np.random.RandomState(13)
    pool = np.array([0.0, -0.0, np.nan, 1.5, -2.5, 8.0], np.float32)
    ak = pool[rng.randint(0, len(pool), 200)]
    bk = pool[rng.randint(0, len(pool), 150)]
    av = np.arange(200, dtype=np.int32)
    bv = np.arange(150, dtype=np.int32)

    def build(bs):
        return bs.Cogroup(bs.Const(4, ak, av), bs.Const(4, bk, bv))

    _, got, _ = _run_both(ref_session, build)
    keys = np.concatenate([sh[0] for sh in got])
    nnan = int(np.isnan(ak).sum() + np.isnan(bk).sum())
    assert int(np.isnan(keys).sum()) == nnan
    assert int((keys == 0).sum()) == 1
    total = sum(len(c) for sh in got for c in sh[1])
    assert total == 200


def test_hot_key_grows_the_capacity(ref_session):
    """A 700-row group: its wave scatters at bucket_size(700) = 1024, the
    capacity the JAX package's ladder reaches from 8 on either mesh; no
    group is truncated."""
    rng = np.random.RandomState(2)
    keys = np.concatenate([np.zeros(700, np.int32),
                           rng.randint(1, 10, 300).astype(np.int32)])
    vals = np.arange(1000, dtype=np.int32)

    def build(bs):
        return bs.Cogroup(bs.Const(4, keys, vals))

    sess, got, ref_ex = _run_both(ref_session, build)
    ex = sess.executor
    (site,) = ex.cogroup_caps
    assert site.startswith("cogroup@test_torch_cogroup.py:")
    assert ex.cogroup_caps[site] == ref_ex._cogroup_caps[site] == 1024
    _check_oracle(got, [(keys, [vals])])
    assert COGROUP_DEFAULT_CAP == 8


def test_cool_waves_store_narrow_matrices():
    """The op's capacity serves its hottest wave; every wave stores its
    matrices at the width its own largest group needs."""
    from bigslice_tpu_torch.exec.meshexec import WavedGroupOutput

    rng = np.random.RandomState(3)
    keys = np.concatenate([np.zeros(700, np.int32),
                           rng.randint(1, 400, 1300).astype(np.int32)])
    sess, res = _port(lambda bs: bs.Cogroup(bs.Const(4, keys, keys)))
    (out,) = [o for o in sess.executor._outputs.values()
              if isinstance(o, WavedGroupOutput)]
    widths = sorted(w.cols[1].shape[1] for w in out.waves)
    assert list(sess.executor.cogroup_caps.values()) == [1024]
    assert widths[-1] == 1024 and widths[0] <= 16
    _check_oracle(bst.result_shard_rows(res), [(keys, [keys])])


@pytest.mark.parametrize("case", ["int", "uint", "multikey", "float"])
@pytest.mark.parametrize("ndeps", [1, 3])
def test_make_cogroup_align_discovers_its_width(case, ndeps):
    """Without a capacity the aligner counts first and scatters at
    ``bucket_size`` of the largest group: no deficit, and every output
    equals the reference's at that capacity."""
    masks, col_sets, nvals = _align_inputs(case, ndeps, 7 + ndeps)
    nk = 2 if case == "multikey" else 1
    t = torch.from_numpy
    n, cols, deficit, G = port_cogroup.make_cogroup_align(nk, nvals)(
        [t(m) for m in masks], [[t(c) for c in cs] for cs in col_sets])
    counts, off = [], nk
    for nv in nvals:
        counts.append(cols[off + nv].numpy())
        off += nv + 1
    assert G == bucket_size(int(max(c.max() for c in counts)))
    assert int(deficit) == 0
    head, rcols, rdef = _ref_align(nk, nvals, G, masks, col_sets)
    assert rdef == 0 and int(n) == int(head.sum())
    for c, rc in zip(cols, rcols):
        np.testing.assert_array_equal(_bits(c.numpy()), _bits(rc[head]))


def test_cogroup_under_spill(monkeypatch):
    """Both producers spill through the FileStore; the Cogroup's waves
    read them back through the arena and equal the in-program run."""
    rng = np.random.RandomState(14)
    ak = rng.randint(0, 80, 900).astype(np.int32)
    bk = rng.randint(40, 120, 700).astype(np.int32)
    av = rng.randint(0, 99, 900).astype(np.int32)
    bv = rng.randn(700).astype(np.float32)

    def build(bs):
        return bs.Cogroup(bs.Const(4, ak, av), bs.Const(4, bk, bv))

    _, res = _port(build)
    want = bst.result_shard_rows(res)
    monkeypatch.setenv("BIGSLICE_SHUFFLE", "spill")
    sess, res = _port(build)
    got = bst.result_shard_rows(res)
    spilled = [o for o in sess.executor._outputs.values()
               if isinstance(o, shuffleplan.SpilledGroupOutput)]
    assert len(spilled) == 2
    _same_shards(got, want)
    sess.shutdown()


def test_cogroup_within_a_pipelined_run_with_budget():
    """Prefetch depth 2 and a tiny wave budget (the subid split
    declines; each consumer wave builds its own view): the same rows as
    the serial run."""
    rng = np.random.RandomState(15)
    k = rng.randint(0, 200, 3000).astype(np.int32)
    v = rng.randint(0, 9, 3000).astype(np.int32)

    def build(bs):
        return bs.Cogroup(bs.Const(8, k, v))

    _, serial = _port(build, prefetch_depth=0)
    sess, piped = _port(build, prefetch_depth=2, device_budget_bytes=2048)
    _same_shards(bst.result_shard_rows(piped),
                 bst.result_shard_rows(serial))


def test_result_rows_and_bsf4_roundtrip():
    """``Result.rows()`` gives (key, list, list) tuples, and a Cogroup
    result's frame survives the BSF4 codec unchanged."""
    ak = np.array([1, 2, 2, 3], np.int32)
    bk = np.array([2, 4], np.int32)

    def build(bs):
        return bs.Cogroup(bs.Const(2, ak, ak * 10),
                          bs.Const(1, bk, bk.astype(np.float32)))

    _, res = _port(build)
    rows = sorted(res.rows(), key=lambda r: int(r[0]))
    assert [int(r[0]) for r in rows] == [1, 2, 3, 4]
    assert [[int(x) for x in r[1]] for r in rows] == [[10], [20, 20], [30],
                                                      []]
    assert [[float(x) for x in r[2]] for r in rows] == [[], [2.0], [], [4.0]]
    frames = [f for s in range(res.num_shards) for f in res.reader(s, ())]
    f = Frame.concat(frames)
    back, _ = codec.decode_frame(codec.encode_frame(f))
    assert back.schema.cols == f.schema.cols
    assert back.schema.prefix == f.schema.prefix
    np.testing.assert_array_equal(back.cols[0].numpy(), f.cols[0].numpy())
    for j in (1, 2):
        _same_cells(back.cols[j], f.cols[j])


# -- schema, typechecks and the compiler ---------------------------------


def test_cogroup_schema_and_shards():
    a = bst.Const(3, np.arange(6, dtype=np.int32), np.ones(6, np.float32))
    b = bst.Const(5, np.arange(6, dtype=np.int32), np.ones(6, np.int32),
                  np.ones(6, np.uint32))
    cg = bst.Cogroup(a, b)
    ref = ref_bs.Cogroup(
        ref_bs.Const(3, np.arange(6, dtype=np.int32),
                     np.ones(6, np.float32)),
        ref_bs.Const(5, np.arange(6, dtype=np.int32), np.ones(6, np.int32),
                     np.ones(6, np.uint32)))
    assert cg.num_shards == ref.num_shards == 5 and cg.prefix == 1
    assert [(str(c.dtype), c.tag) for c in cg.schema] == \
        [(str(c.dtype), c.tag) for c in ref.schema] == \
        [("int32", ""), ("object", "list"), ("object", "list"),
         ("object", "list")]
    assert all(d.shuffle and not d.expand for d in cg.deps())
    assert cg.nvals == (1, 2)


def test_cogroup_typechecks():
    from bigslice_tpu_torch.typecheck import TypecheckError

    a = bst.Const(2, np.arange(4, dtype=np.int32), np.ones(4, np.int32))
    fk = bst.Const(2, np.arange(4, dtype=np.float32), np.ones(4, np.int32))
    with pytest.raises(TypecheckError,
                       match="test_torch_cogroup.py:[0-9]+: cogroup: key "
                             "column types mismatch"):
        bst.Cogroup(a, fk)
    with pytest.raises(TypecheckError, match="expected at least one slice"):
        bst.Cogroup()
    nokey = bst.Const(2, np.arange(4, dtype=np.int32))
    nokey.schema = bst.Schema(list(nokey.schema), prefix=0)
    with pytest.raises(TypecheckError, match="must have a key prefix"):
        bst.Cogroup(nokey)
    vec = bst.Const(2, np.zeros((4, 3), np.int32), np.ones(4, np.int32))
    with pytest.raises(TypecheckError, match="is not groupable"):
        bst.Cogroup(vec)


def test_golden_cogroup_graph():
    """The port's task graph of tests/test_compile.py's Cogroup equals
    the golden file, and the JAX package's."""

    def build(bs):
        a = bs.Const(3, np.arange(8, dtype=np.int32),
                     np.arange(8, dtype=np.int32))
        b = bs.Const(3, np.arange(6, dtype=np.int32),
                     np.arange(6, dtype=np.float32))
        return bs.Cogroup(a, b)

    got = port_compile.graph_string(
        port_compile.Compiler(1).compile(build(bst)), locations=False)
    want = ref_compile.graph_string(
        ref_compile.Compiler(1).compile(build(ref_bs)), locations=False)
    path = os.path.join(os.path.dirname(__file__), "testdata",
                        "cogroup.graph")
    with open(path) as fh:
        golden = fh.read()
    assert got == golden == want


# -- the host half of frame/ops ------------------------------------------


_HOST_VALUES = [
    "", "word", "naïve", "\ud800x", "\U0001f600", b"", b"\x00\xffbytes",
    True, False, 0, 1, -1, 2**31, -(2**40), np.int32(-7), np.uint32(9),
    0.0, -0.0, 1.5, float("nan"), float("inf"), 1e-300,
    (), (1,), ("a", 2), (1, ("b", b"c"), 2.5), ((), True),
]


def test_stable_obj_hash_matches_reference():
    for v in _HOST_VALUES:
        assert port_ops._stable_obj_hash(v) == ref_ops._stable_obj_hash(v), v
    with pytest.raises(TypeError):
        port_ops._stable_obj_hash([1, 2])


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_hash_host_column_matches_reference(seed):
    from bigslice_tpu_torch.frame.frame import obj_col

    words = ["w%d" % i for i in range(300)] + ["\udcff", "a\ud83d"]
    for col in (obj_col(_HOST_VALUES), obj_col(words),
                obj_col([(i, str(i)) for i in range(50)])):
        got = port_ops.hash_host_column(col, seed)
        want = ref_ops.hash_host_column(col, seed)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, np.asarray(want, np.uint32))


def test_ops_registry_and_capabilities():
    host = ColType(np.dtype(object), tag="str")
    assert port_ops.can_hash(host) and port_ops.can_compare(host)
    assert port_ops.ops_for(host).hash_fn is port_ops.hash_host_column
    vec = ColType(np.dtype(np.int32), shape=(4,))
    assert not port_ops.can_hash(vec) and not port_ops.can_compare(vec)
    assert port_ops.can_hash(ColType(np.dtype(np.float32)))
    port_ops.register_ops("opaque-test", port_ops.Ops(can_hash=False,
                                                      can_compare=False))
    opaque = ColType(np.dtype(object), tag="opaque-test")
    assert not port_ops.can_hash(opaque)
    # The device tier's keys are scalar device columns only.
    assert not port_ops.device_key(host) and not port_ops.device_key(vec)
    assert port_ops.device_key(ColType(np.dtype(np.uint32)))
