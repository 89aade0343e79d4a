"""The sort lowering's device functions (parallel/segment.py) against the
JAX package's: the same seeded numpy inputs through ``lax.sort`` /
``lax.associative_scan`` and through the port's torch ops.

Everything here must be bit-equal — the sort permutation (ties in input
order, -0.0 equal to +0.0, NaN last), the segment boundaries, and every
combined value, float adds and the -0.0 → +0.0 of JAX's interleave
included — because the port runs JAX's own scan recursion.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from bigslice_tpu.frame.frame import Frame as RefFrame  # noqa: E402
from bigslice_tpu.parallel import segment as ref_seg  # noqa: E402
from bigslice_tpu.parallel import sortkernel as ref_sortkernel  # noqa: E402
import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.parallel import segment as seg  # noqa: E402

SIZES = [0, 1, 2, 7, 4096]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _floats(rng, n):
    f = (rng.randn(n) * 3).astype(np.float32)
    for i, v in enumerate([np.nan, 0.0, -0.0, 1.0, -np.nan, -1.0, 0.0,
                           -0.0]):
        f[i::37] = v
    return f


def _col(kind, rng, n):
    if kind == "i32":
        return rng.randint(-5, 5, n).astype(np.int32)
    if kind == "u32":
        return rng.randint(0, 2**32, n, dtype=np.int64).astype(np.uint32)
    if kind == "u32small":
        return (rng.randint(0, 4, n) + 2**31 - 2).astype(np.uint32)
    return _floats(rng, n)


KEYSETS = [("i32",), ("u32",), ("f32",), ("i32", "f32"),
           ("u32small", "i32", "f32"), ("f32", "f32", "i32")]


@pytest.mark.parametrize("n", SIZES + [4099])
@pytest.mark.parametrize("kinds", KEYSETS, ids="-".join)
def test_sort_with_payload_permutation_matches_lax_sort(kinds, n):
    rng = np.random.RandomState(n + len(kinds))
    keys = [_col(k, rng, n) for k in kinds]
    iota = np.arange(n, dtype=np.int32)
    want_k, (want_p,) = ref_seg.sort_with_payload(
        [jnp.asarray(k) for k in keys], len(keys), (jnp.asarray(iota),))
    got_k, (got_p,) = seg.sort_with_payload(
        [torch.from_numpy(k) for k in keys], len(keys),
        (torch.from_numpy(iota),))
    _eq(got_p, want_p)
    for g, w in zip(got_k, want_k):
        _eq(g, w)


def test_sort_orders_floats_as_lax_sort():
    """The case the two float orders differ on: +-0.0 stay in input
    order, every NaN goes last in input order."""
    f = np.array([np.nan, 0.0, -0.0, 1.0, -np.nan, -1.0, 0.0, -0.0],
                 np.float32)
    (_,), (perm,) = seg.sort_with_payload(
        [torch.from_numpy(f)], 1, (torch.arange(8),))
    assert perm.tolist() == [5, 1, 2, 6, 7, 3, 0, 4]


@pytest.mark.parametrize("n", [1, 33, 4096])
def test_sort_with_vector_payload(n):
    rng = np.random.RandomState(n)
    k = _col("f32", rng, n)
    v = rng.randint(0, 100, (n, 3)).astype(np.int32)
    _, (want,) = ref_seg.sort_with_payload(
        (jnp.asarray(k),), 1, (jnp.asarray(v),))
    _, (got,) = seg.sort_with_payload((torch.from_numpy(k),), 1,
                                      (torch.from_numpy(v),))
    _eq(got, want)


@pytest.mark.parametrize("n", [1, 2, 7, 4096])
@pytest.mark.parametrize("kinds", KEYSETS, ids="-".join)
def test_sort_and_segment_matches(kinds, n):
    rng = np.random.RandomState(7 * n + len(kinds))
    keys = [_col(k, rng, n) for k in kinds]
    valid = rng.rand(n) < 0.8
    val = rng.randn(n).astype(np.float32)
    want = ref_seg.sort_and_segment(
        len(keys), jnp.asarray(valid), [jnp.asarray(k) for k in keys],
        (jnp.asarray(val),))
    got = seg.sort_and_segment(
        len(keys), torch.from_numpy(valid),
        [torch.from_numpy(k) for k in keys], (torch.from_numpy(val),))
    _eq(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        _eq(g, w)
    _eq(got[2][0], want[2][0])
    _eq(got[3], want[3])


def _fns(mod):
    """(nkeys, value kinds, combine fn) per case, in ``mod``'s ops."""
    where = mod.where
    mx = mod.maximum
    return {
        "add_int": (1, ("i32",), lambda a, b: a + b),
        "add_float": (1, ("f32",), lambda a, b: a + b),
        "max_float": (1, ("f32",), mx),
        "lww": (1, ("i32", "i32"),
                lambda a, b: (mx(a[0], b[0]),
                              where(a[0] >= b[0], a[1], b[1]))),
        "k2v3": (2, ("i32", "f32", "f32"),
                 lambda a, b: (a[0] + b[0], mx(a[1], b[1]),
                               where(a[0] > b[0], a[2], b[2] * 2))),
    }


def _case(name, n):
    rng = np.random.RandomState(len(name) * 101 + n)
    nkeys, vkinds, _ = _fns(jnp)[name]
    keys = [rng.randint(0, 9, n).astype(np.int32) for _ in range(nkeys)]
    vals = []
    for k in vkinds:
        if k == "i32":
            vals.append(rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32))
        else:
            v = (rng.randn(n) * 1e3).astype(np.float32)
            v[::3] = -0.0
            v[1::11] = 0.0
            vals.append(v)
    valid = rng.rand(n) < 0.85
    return keys, vals, valid


CASES = ["add_int", "add_float", "max_float", "lww", "k2v3"]


@pytest.mark.parametrize("n", [1, 2, 7, 4096])
@pytest.mark.parametrize("name", CASES)
def test_segmented_reduce_masked_bit_equal(name, n):
    keys, vals, valid = _case(name, n)
    nkeys, _, rfn = _fns(jnp)[name]
    pfn = _fns(torch)[name][2]
    nv = len(vals)
    want = ref_seg.make_segmented_reduce_masked(
        nkeys, nv, ref_seg.canonical_combine(rfn, nv))(
        jnp.asarray(valid), tuple(jnp.asarray(k) for k in keys),
        tuple(jnp.asarray(v) for v in vals))
    got = seg.make_segmented_reduce_masked(
        nkeys, nv, seg.canonical_combine(pfn, nv))(
        torch.from_numpy(valid), tuple(torch.from_numpy(k) for k in keys),
        tuple(torch.from_numpy(v) for v in vals))
    _eq(got[0], want[0])
    for g, w in zip([*got[1], *got[2]], [*want[1], *want[2]]):
        _eq(g, w)


@pytest.mark.parametrize("n", [1, 2, 7, 4096])
@pytest.mark.parametrize("name", CASES)
def test_segmented_combine_bit_equal(name, n):
    """The scan alone over one column of segment starts: every row's
    running value, not only the segments' last rows."""
    _, vals, valid = _case(name, n)
    nv = len(vals)
    rfn, pfn = _fns(jnp)[name][2], _fns(torch)[name][2]
    want_last, want = ref_seg.segmented_combine(
        jnp.asarray(valid), tuple(jnp.asarray(v) for v in vals),
        ref_seg.canonical_combine(rfn, nv))
    got_last, got = seg.segmented_combine(
        torch.from_numpy(valid), tuple(torch.from_numpy(v) for v in vals),
        seg.canonical_combine(pfn, nv))
    _eq(got_last, want_last)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("name", CASES)
def test_segmented_reduce_empty(name):
    """Size 0, which the JAX package's kernels never see (its buckets
    hold at least 8 rows): empty outputs of the input's dtypes."""
    keys, vals, valid = _case(name, 0)
    nkeys, _, pfn = _fns(torch)[name]
    nv = len(vals)
    count, k, v = seg.make_segmented_reduce(
        nkeys, nv, seg.canonical_combine(pfn, nv))(
        0, tuple(torch.from_numpy(x) for x in keys),
        tuple(torch.from_numpy(x) for x in vals))
    assert int(count) == 0
    assert [c.shape[0] for c in list(k) + list(v)] == [0] * (nkeys + nv)


def test_interleave_clears_negative_zero():
    """JAX's interleave adds its zero-padded halves, so a max over
    all -0.0 rows leaves as +0.0 (no sign bits)."""
    vals = np.array([-0.0, 1.0, -0.0, -0.0], np.float32)
    starts = np.array([True, False, True, False])
    _, (want,) = ref_seg.segmented_combine(
        jnp.asarray(starts), (jnp.asarray(vals),),
        lambda a, b: (jnp.maximum(a[0], b[0]),))
    _, (got,) = seg.segmented_combine(
        torch.from_numpy(starts), (torch.from_numpy(vals),),
        lambda a, b: (torch.maximum(a[0], b[0]),))
    _eq(got, want)
    assert not torch.signbit(got).any()


@pytest.mark.parametrize("n", [5, 4096])
def test_make_segmented_reduce_count_based(n):
    keys, vals, _ = _case("k2v3", n)
    rfn, pfn = _fns(jnp)["k2v3"][2], _fns(torch)["k2v3"][2]
    live = n - 2
    want = ref_seg.make_segmented_reduce(
        2, 3, ref_seg.canonical_combine(rfn, 3))(
        jnp.int32(live), tuple(jnp.asarray(k) for k in keys),
        tuple(jnp.asarray(v) for v in vals))
    got = seg.make_segmented_reduce(2, 3, seg.canonical_combine(pfn, 3))(
        live, tuple(torch.from_numpy(k) for k in keys),
        tuple(torch.from_numpy(v) for v in vals))
    assert int(got[0]) == int(want[0])
    for g, w in zip([*got[1], *got[2]], [*want[1], *want[2]]):
        _eq(g, w)


@pytest.mark.parametrize("kinds", [("f32",), ("u32", "i32")], ids="-".join)
def test_sorted_by_key_matches_device_run_sort(kinds):
    """Frame.sorted_by_key on the port's device against the JAX
    package's device run sort (one lax.sort over the whole frame)."""
    rng = np.random.RandomState(5)
    n = 5000
    keys = [_col(k, rng, n) for k in kinds]
    vals = [rng.randint(0, 1000, n).astype(np.int32)]
    ref = RefFrame([*keys, *vals], prefix=len(keys))
    want = ref_sortkernel.device_sorted_by_key(ref)
    got = bst.Frame.from_numpy([*keys, *vals], prefix=len(keys),
                               device="cpu").sorted_by_key()
    for g, w in zip(got.cols, want.cols):
        _eq(g, w)
