"""The CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU and nvcc, and imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q

Every test skips here when there is no card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bigslice_tpu_torch.parallel import cuda_kernels  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if not cuda_kernels.kernels_available():
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _mixed(n, seed):
    rng = np.random.RandomState(seed)
    f = (rng.randn(n) * 100).astype(np.float32)
    f[:5] = [0.0, -0.0, np.nan, np.inf, -np.inf]
    return [
        rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32),
        rng.randint(0, 2**32, n, dtype=np.int64).astype(np.uint32),
        f,
        rng.randint(-(2**15), 2**15, n).astype(np.int16),
        rng.rand(n) < 0.5,
    ]


@pytest.mark.parametrize("nparts", [1, 7, 1000, 20000])
@pytest.mark.parametrize("nkeys", [1, 3, 5])
def test_hash_partition_bit_equal(dev, nparts, nkeys):
    n = (1 << 16) + 37
    keys = [torch.from_numpy(k).to(dev) for k in _mixed(n, nparts)[:nkeys]]
    valid = torch.from_numpy(
        np.random.RandomState(nkeys).rand(n) < 0.9).to(dev)
    before = cuda_kernels.LAUNCHES["hash_partition"]
    ids, counts = cuda_kernels.hash_partition(keys, nparts, 3, valid=valid)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["hash_partition"] == before + 1
    want_ids, want_counts = cuda_kernels.hash_partition_plain(
        keys, nparts, 3, valid=valid)
    assert torch.equal(ids, want_ids)
    assert torch.equal(counts, want_counts)


def _rows(present, keys, vals):
    # uint32 has no CUDA gather kernels: move its int32 bits instead.
    cols = [(c.view(torch.int32) if c.dtype == torch.uint32 else c)[present]
            .cpu().numpy() for c in list(keys) + list(vals)]
    cols = [c.view(np.int32) if c.dtype.itemsize == 4 else c for c in cols]
    return sorted(zip(*[c.tolist() for c in cols]))


@pytest.mark.parametrize("case", ["int", "uint", "f32max", "multikey",
                                  "maxmin"])
def test_hash_aggregate_rows_equal(dev, case):
    rng = np.random.RandomState(len(case))
    nparts, R, n = 4, 4096, 40000
    k1 = rng.randint(0, nparts * R // 4, n).astype(np.int32)
    keys = [k1]
    vals = [rng.randint(-100, 100, n).astype(np.int32)]
    ops = ["add"]
    if case == "uint":
        keys, vals = [k1.view(np.uint32)], [vals[0].view(np.uint32)]
        ops = ["max"]
    elif case == "f32max":
        v = rng.randn(n).astype(np.float32)
        v[::41] = -0.0
        vals, ops = [v], ["max"]
    elif case == "multikey":
        keys = [k1, (k1 % 7).astype(np.int32)]
        vals.append((rng.randn(n)).astype(np.float32))
        ops = ["min", "min"]
    elif case == "maxmin":
        vals.append(rng.randint(-50, 50, n).astype(np.int32))
        ops = ["max", "min"]
    valid = torch.from_numpy(rng.rand(n) < 0.9).to(dev)
    tk = [torch.from_numpy(k).to(dev) for k in keys]
    tv = [torch.from_numpy(v).to(dev) for v in vals]
    part, _ = cuda_kernels.hash_partition(tk, nparts, 0, with_counts=False)
    got = cuda_kernels.hash_aggregate(valid, tk, tv, ops, part, nparts, R)
    want = cuda_kernels.hash_aggregate_plain(valid, tk, tv, ops, part,
                                             nparts, R)
    torch.cuda.synchronize()
    assert int(got[3]) == int(want[3]) == 0
    assert _rows(*got[:3]) == _rows(*want[:3])
    # Region invariant: every occupied slot's region is its key's
    # partition.
    slots = torch.nonzero(got[0]).squeeze(1)
    occupied = [(k.view(torch.int32)[got[0]].view(torch.uint32)
                 if k.dtype == torch.uint32 else k[got[0]]) for k in got[1]]
    rp, _ = cuda_kernels.hash_partition(occupied, nparts, 0,
                                        with_counts=False)
    assert torch.equal((slots // R).to(torch.int32), rp)


def test_hash_aggregate_float_add_tolerance(dev):
    rng = np.random.RandomState(5)
    n, R = 100000, 1 << 15
    k = torch.from_numpy(rng.randint(0, 5000, n).astype(np.int32)).to(dev)
    v = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    part = torch.zeros(n, dtype=torch.int32, device=dev)
    got = cuda_kernels.hash_aggregate(valid, [k], [v], ["add"], part, 1, R)
    gk = got[1][0][got[0]].cpu().numpy()
    gv = got[2][0][got[0]].cpu().numpy().astype(np.float64)
    kn, vn = k.cpu().numpy(), v.cpu().numpy().astype(np.float64)
    exact = np.bincount(kn, weights=vn, minlength=5000)
    mag = np.bincount(kn, weights=np.abs(vn), minlength=5000)
    assert (np.abs(gv - exact[gk]) <= 1e-5 * mag[gk]).all()


def test_hash_aggregate_float_bits(dev):
    keys = torch.arange(8, dtype=torch.int32, device=dev)
    v = torch.tensor([0.0, -0.0, float("nan"), 1.5, -2.5, float("inf"),
                      -float("inf"), 3.0], device=dev)
    part = (keys % 2).to(torch.int32)
    valid = torch.ones(8, dtype=torch.bool, device=dev)
    for op in ("max", "min"):
        p, ok, ov, _ = cuda_kernels.hash_aggregate(valid, [keys], [v], [op],
                                                   part, 2, 128)
        got = dict(zip(ok[0][p].tolist(),
                       ov[0][p].view(torch.int32).tolist()))
        assert got == dict(zip(keys.tolist(), v.view(torch.int32).tolist()))


def test_slice_on_the_card_matches_the_cpu(dev):
    import bigslice_tpu_torch as bs

    rng = np.random.RandomState(3)
    keys = rng.randint(0, 1 << 14, 1 << 18).astype(np.int32)
    vals = rng.randint(-1000, 1000, 1 << 18).astype(np.int32)

    def run(device):
        # Discovery off: these dense keys would otherwise take the dense
        # table on the reduce side and the sort on the map side.
        sess = bs.Session(executor=bs.MeshExecutor(device=device,
                                                   auto_dense=False))
        return bs.result_shard_rows(sess.run(
            bs.Reduce(bs.Const(4, keys, vals), lambda a, b: a + b)))

    cuda_kernels.reset_launches()
    got = run("cuda")
    assert cuda_kernels.LAUNCHES["hash_partition"] > 0
    assert cuda_kernels.LAUNCHES["hash_aggregate"] > 0
    want = run("cpu")
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("nparts", [1, 4, 31, 32, 33, 1000, 20000])
@pytest.mark.parametrize("layout", ["aligned", "ragged", "view"])
def test_hash_partition_one_key_layouts(dev, nparts, layout):
    """One 4-byte key column: 16-byte aligned columns take the 4-rows-
    a-thread path (its ragged edge when n % 4 != 0), views that start
    one row in take the scalar path; ids and counts stay bit-equal."""
    rng = np.random.RandomState(nparts)
    n = {"aligned": 1 << 16, "ragged": (1 << 16) + 3,
         "view": (1 << 16) + 1}[layout]
    key = torch.from_numpy(
        rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.rand(n) < 0.9).to(dev)
    if layout == "view":
        key, valid = key[1:], valid[1:]
    for k in (key, key.view(torch.float32)):
        ids, counts = cuda_kernels.hash_partition([k], nparts, 5,
                                                  valid=valid)
        want_ids, want_counts = cuda_kernels.hash_partition_plain(
            [k], nparts, 5, valid=valid)
        assert torch.equal(ids, want_ids)
        assert torch.equal(counts, want_counts)
        ids, none = cuda_kernels.hash_partition([k], nparts, 5,
                                                with_counts=False)
        assert none is None
        assert torch.equal(ids, cuda_kernels.hash_partition_plain(
            [k], nparts, 5, with_counts=False)[0])


def _check_aggregate(dev, keys, vals, ops, valid, nparts, R):
    """The kernel's table against the plain version's: overflow 0 in
    both, the same occupied rows, each key in one slot only, and every
    occupied slot in its key's region."""
    tk = [torch.from_numpy(k).to(dev) for k in keys]
    tv = [torch.from_numpy(v).to(dev) for v in vals]
    valid = torch.from_numpy(valid).to(dev)
    part, _ = cuda_kernels.hash_partition(tk, nparts, 0, with_counts=False)
    got = cuda_kernels.hash_aggregate(valid, tk, tv, ops, part, nparts, R)
    want = cuda_kernels.hash_aggregate_plain(valid, tk, tv, ops, part,
                                             nparts, R)
    torch.cuda.synchronize()
    assert int(got[3]) == int(want[3]) == 0
    rows = _rows(*got[:3])
    assert rows == _rows(*want[:3])
    assert len({r[:len(keys)] for r in rows}) == len(rows)
    slots = torch.nonzero(got[0]).squeeze(1)
    occupied = [(k.view(torch.int32)[got[0]].view(torch.uint32)
                 if k.dtype == torch.uint32 else k[got[0]]) for k in got[1]]
    rp, _ = cuda_kernels.hash_partition(occupied, nparts, 0,
                                        with_counts=False)
    assert torch.equal((slots // R).to(torch.int32), rp)
    return got


def test_hash_aggregate_spill(dev):
    """More distinct keys than one bucket holds, all homed in one bucket
    of region 1, the region under a fifth full: the bucket overflows
    into the spill pass, which places every row."""
    from bigslice_tpu_torch.parallel import hashagg

    nparts, R = 4, 1 << 16
    plan = cuda_kernels.aggregate_plan(1, 1, nparts, R, 0)
    B = 1 << plan.bucket_log2
    cand = torch.arange(1 << 22, dtype=torch.int32)
    part, _ = cuda_kernels.hash_partition_plain([cand], nparts, 0,
                                                with_counts=False)
    home = (hashagg._slot_hash([cand], 0) & (R - 1)) >> plan.bucket_log2
    chosen = cand[(part == 1) & (home == 3)][:B + B // 2].numpy()
    assert len(chosen) == B + B // 2 and len(chosen) < R // 4
    rng = np.random.RandomState(11)
    keys = rng.permutation(np.repeat(chosen, 3))
    vals = rng.randint(-100, 100, len(keys)).astype(np.int32)
    got = _check_aggregate(dev, [keys], [vals], ["add"],
                           np.ones(len(keys), bool), nparts, R)
    assert int(got[0].sum()) == len(chosen)


def test_hash_aggregate_load_quarter(dev):
    """2**19 distinct keys in one 2**21-slot region."""
    rng = np.random.RandomState(12)
    keys = rng.permutation(np.repeat(
        rng.choice(1 << 30, 1 << 19, replace=False).astype(np.int32), 2))
    vals = rng.randint(0, 50, len(keys)).astype(np.int32)
    valid = rng.rand(len(keys)) < 0.95
    _check_aggregate(dev, [keys], [vals], ["max"], valid, 1, 1 << 21)


@pytest.mark.parametrize("lanes", ["keys8", "vals8", "both8"])
def test_hash_aggregate_eight_lanes(dev, lanes):
    """Eight key columns of every key type, eight value columns of every
    dtype and op, or both: the smallest buckets."""
    rng = np.random.RandomState(13)
    n, nparts, R = 1 << 18, 4, 1 << 16
    k = rng.randint(0, 1 << 15, n).astype(np.int32)
    keys = [k]
    if lanes != "vals8":
        keys = [k, (k % 3).astype(np.uint32), (k % 5).astype(np.int16) - 2,
                (k % 7).astype(np.int16), (k % 11).astype(np.int8) - 5,
                (k % 13).astype(np.uint8), (k % 2).astype(bool),
                (k // 2).astype(np.int32)]
    vals = [rng.randint(-100, 100, n).astype(np.int32)]
    ops = ["add"]
    if lanes != "keys8":
        f = rng.randn(n).astype(np.float32)
        f[::37] = -0.0
        u = rng.randint(0, 2**32, n, dtype=np.int64).astype(np.uint32)
        i = rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32)
        vals = [vals[0], i, i, u, u, u, f, f]
        ops = ["add", "max", "min", "add", "max", "min", "max", "min"]
    valid = rng.rand(n) < 0.9
    plan = cuda_kernels.aggregate_plan(len(keys), len(vals), nparts, R, n)
    assert plan.smem_bytes <= cuda_kernels.AGG_SMEM_BUDGET
    _check_aggregate(dev, keys, vals, ops, valid, nparts, R)


@pytest.mark.parametrize("nparts,R", [(5000, 64), (20000, 8)])
def test_hash_aggregate_many_buckets(dev, nparts, R):
    """More buckets than a scatter block can sort a tile by (rows
    scattered one cursor atomic each), and past the count pass's shared
    bins (global counts) in the second case."""
    plan = cuda_kernels.aggregate_plan(1, 1, nparts, R, 0)
    assert plan.nbuckets == nparts
    rng = np.random.RandomState(nparts)
    n = 1 << 17
    keys = rng.randint(0, nparts * R // 8, n).astype(np.int32)
    vals = rng.randint(-100, 100, n).astype(np.int32)
    _check_aggregate(dev, [keys], [vals], ["add"], rng.rand(n) < 0.9,
                     nparts, R)


def _lww_slice(bs, n):
    rng = np.random.RandomState(42)
    keys = rng.randint(0, 1 << 24, n).astype(np.int32)
    ts = rng.permutation(n).astype(np.int32)
    vals = rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32)
    s = bs.Map(bs.Const(4, keys, ts, vals),
               lambda k, t, v: (k & 0xFFFFF, t, v))
    s = bs.Filter(s, lambda k, t, v: t >= n // 8)
    return bs.Reduce(s, lambda a, b: (torch.maximum(a[0], b[0]),
                                      torch.where(a[0] >= b[0], a[1], b[1])))


def test_sort_lowering_on_the_card_matches_the_cpu(dev):
    """The lww chain (Map, Filter, a combine fn that does not classify):
    the sort lowering on the card, routed by K1, equals the CPU run."""
    import bigslice_tpu_torch as bs

    def run(device):
        sess = bs.Session(executor=bs.MeshExecutor(device=device))
        return bs.result_shard_rows(sess.run(_lww_slice(bs, 1 << 18)))

    cuda_kernels.reset_launches()
    got = run("cuda")
    assert cuda_kernels.LAUNCHES["hash_partition"] > 0
    assert cuda_kernels.LAUNCHES["hash_aggregate"] == 0
    want = run("cpu")
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("nparts", [1, 4, 33, 1000])
def test_hash_partition_float_keys(dev, nparts):
    """One float32 key column with +-0.0, NaNs of both signs and
    infinities, bit-equal to the plain version."""
    rng = np.random.RandomState(nparts)
    n = (1 << 20) + 3
    f = (rng.randn(n) * 1e3).astype(np.float32)
    for i, v in enumerate([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf]):
        f[i::101] = v
    key = torch.from_numpy(f).to(dev)
    valid = torch.from_numpy(rng.rand(n) < 0.9).to(dev)
    ids, counts = cuda_kernels.hash_partition([key], nparts, 0, valid=valid)
    want_ids, want_counts = cuda_kernels.hash_partition_plain(
        [key], nparts, 0, valid=valid)
    assert torch.equal(ids, want_ids)
    assert torch.equal(counts, want_counts)
    zero = torch.nonzero(key == 0).squeeze(1)
    assert bool((ids[zero][valid[zero]] == ids[zero][valid[zero]][0]).all())


def test_overflow_fallback_on_the_card(dev):
    """Near-distinct keys all routed to one partition overflow the map
    side's table: the wave reruns on the sort path, the op stays there,
    and every key comes back once with its exact count."""
    import bigslice_tpu_torch as bs

    cand = torch.arange(1 << 20, dtype=torch.int32)
    part, _ = cuda_kernels.hash_partition_plain([cand], 4, 0)
    keys = cand[part == 0][: 1 << 17].numpy()
    keys = np.concatenate([keys, keys[:1000]])
    ex = bs.MeshExecutor(auto_dense=False)
    cuda_kernels.reset_launches()
    res = bs.Session(executor=ex).run(bs.Reduce(
        bs.Const(4, keys, np.ones(len(keys), np.int32)),
        lambda a, b: a + b))
    assert cuda_kernels.LAUNCHES["hash_aggregate"] > 0
    assert any(op.startswith("const") for op in ex.hash_off)
    got = dict(res.rows())
    uniq, cnt = np.unique(keys, return_counts=True)
    assert got == dict(zip(uniq.tolist(), cnt.tolist()))


def test_join_and_groupby_on_the_card_match_numpy(dev):
    """A small hash join (K1 and K2 on both sides' map waves), the xor
    join on the sort path, and a GroupByKey with a Map over its [G]
    vectors, on the card, against numpy."""
    import bigslice_tpu_torch as bs

    rng = np.random.RandomState(1)
    n = 1 << 16
    ak = rng.randint(0, n // 16, n).astype(np.int32)
    bk = rng.randint(0, n // 16, n).astype(np.int32)
    av = rng.randint(-1000, 1000, n).astype(np.int32)
    bv = rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32)
    span = n // 16
    a_sum = np.zeros(span, np.int64)
    np.add.at(a_sum, ak, av)
    b_xor = np.zeros(span, np.int32)
    np.bitwise_xor.at(b_xor, bk, bv)
    b_cnt = np.bincount(bk, minlength=span)
    both = np.intersect1d(ak, bk)

    sess = bs.Session()
    cuda_kernels.reset_launches()
    rows = sess.run(bs.JoinAggregate(
        bs.Const(4, ak, av), bs.Const(4, bk, np.ones(n, np.int32)),
        lambda x, y: x + y, lambda x, y: x + y)).rows()
    assert cuda_kernels.LAUNCHES["hash_partition"] >= 8
    assert cuda_kernels.LAUNCHES["hash_aggregate"] >= 8
    got = {k: (a, b) for k, a, b in rows}
    assert got == {int(k): (int(a_sum[k]), int(b_cnt[k])) for k in both}

    rows = sess.run(bs.JoinAggregate(
        bs.Const(4, ak, av), bs.Const(4, bk, bv),
        lambda x, y: x + y, lambda x, y: x ^ y)).rows()
    got = {k: (a, b) for k, a, b in rows}
    assert got == {int(k): (int(a_sum[k]), int(b_xor[k])) for k in both}
    assert sess.executor.hash_off == frozenset()

    keys = rng.randint(0, n // 32, n).astype(np.int32)
    vals = rng.randint(1, 100, n).astype(np.int32)
    rows = sess.run(bs.Map(bs.GroupByKey(bs.Const(4, keys, vals), capacity=64),
                           lambda k, g, c: (k, g.sum(), c))).rows()
    cnt = np.bincount(keys, minlength=n // 32)
    tot = np.zeros(n // 32, np.int64)
    np.add.at(tot, keys, vals)
    assert len(rows) == len(np.unique(keys))
    for k, s, c in rows:
        assert c == cnt[k]
        if c <= 64:
            assert s == tot[k]
        else:
            assert s < tot[k]


def _delayed_programs(ex, cycles):
    """Queue a busy-wait on the compute stream before each wave program,
    so that the copy stream's staging runs far ahead of the programs."""
    orig = ex._program

    def program(task, stages, slack):
        stepped = orig(task, stages, slack)

        def delayed(wave, inputs, *carry):
            torch.cuda._sleep(cycles)
            return stepped(wave, inputs, *carry)

        return delayed

    ex._program = program


def test_pipeline_race_with_a_delayed_compute_stream(dev):
    """Pipelined S = 16 Reduce with each program queued behind a
    busy-wait: inputs copied on the copy stream, their blocks recycled
    through the caching allocator and their pinned buffers through the
    arena while earlier waves still compute. Every run's rows must equal
    the serial run's."""
    import bigslice_tpu_torch as bs

    rng = np.random.RandomState(17)
    n = 1 << 22
    keys = rng.randint(0, 1 << 16, n).astype(np.int32)
    vals = rng.randint(-1000, 1000, n).astype(np.int32)

    def run(depth, delay):
        ex = bs.MeshExecutor(device="cuda", prefetch_depth=depth)
        if delay:
            _delayed_programs(ex, 2_000_000)
        res = bs.Session(executor=ex).run(
            bs.Reduce(bs.Const(16, keys, vals), lambda a, b: a + b))
        return bs.result_shard_rows(res), ex

    want, _ = run(0, False)
    for depth in (1, 2, 2):
        got, ex = run(depth, True)
        for g, w in zip(got, want):
            for gc, wc in zip(g, w):
                np.testing.assert_array_equal(gc, wc)
        st = ex.staging_arena.stats()
        assert st["mode"] == "recycle" and st["hits"] > 0
        assert st["pinned"] is True
        assert ex.staging_seconds()["waves"] == 32


def test_kernels_launch_on_the_current_side_stream(dev):
    """K1 and K2 launched under a side stream's context run on that
    stream, behind its busy-wait, with no host sync: the side stream's
    event is still pending when the wrappers return, the default stream
    stays idle, and the results are right once the event completes."""
    n = 1 << 20
    rng = np.random.RandomState(5)
    key = torch.from_numpy(rng.randint(0, 1 << 18, n).astype(np.int32)).to(dev)
    one = torch.ones_like(key)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)  # about 0.1 s
        part, _ = cuda_kernels.hash_partition([key], 4, 0, with_counts=False,
                                              valid=valid)
        got = cuda_kernels.hash_aggregate(valid, [key], [one], ["add"], part,
                                          4, 1 << 17)
        done = torch.cuda.Event()
        done.record(side)
    assert not done.query()
    assert torch.cuda.default_stream(dev).query()
    done.synchronize()
    want_part, _ = cuda_kernels.hash_partition_plain([key], 4, 0,
                                                     with_counts=False,
                                                     valid=valid)
    assert torch.equal(part, want_part)
    want = cuda_kernels.hash_aggregate_plain(valid, [key], [one], ["add"],
                                             want_part, 4, 1 << 17)
    assert int(got[3]) == 0 and int(want[3]) == 0
    assert np.array_equal(_rows(*got[:3]), _rows(*want[:3]))


def test_split_and_spill_on_the_card_match_the_cpu(dev, monkeypatch):
    import bigslice_tpu_torch as bs

    rng = np.random.RandomState(8)
    keys = rng.randint(0, 1 << 12, 1 << 16).astype(np.int32)
    vals = rng.randint(0, 100, 1 << 16).astype(np.int32)

    def run(device, **kw):
        # The hash lowering's split: discovery off.
        ex = bs.MeshExecutor(device=device, auto_dense=False, **kw)
        sess = bs.Session(executor=ex)
        rows = bs.result_shard_rows(sess.run(
            bs.Reduce(bs.Const(8, keys, vals), lambda a, b: a + b)))
        sess.shutdown()
        return rows, ex

    want, _ = run("cpu")
    est = bs.MeshExecutor.wave_bytes_model(1 << 13, 8, hash_table=True)
    got, ex = run("cuda", device_budget_bytes=-(-est // 4))
    assert list(ex.split_runs.values()) == [4]
    monkeypatch.setenv("BIGSLICE_SHUFFLE", "spill")
    spilled, _ = run("cuda", prefetch_depth=2)
    for rows in (got, spilled):
        for g, w in zip(rows, want):
            for gc, wc in zip(g, w):
                np.testing.assert_array_equal(gc, wc)


def test_budget_split_bounds_peak_memory(dev):
    """A Reduce whose map waves split into K = 4 slices peaks no higher
    on the card than the same Reduce unsplit, with equal rows, and each
    slice (its program and its fold into the running merge) allocates
    no more than the budget beyond what was held before it. The keys
    repeat about 4 times a map wave, so a slice of about one row a key
    combines little on its own: the fold's re-combine keeps the running
    merge at one row a key."""
    import gc

    import bigslice_tpu_torch as bs

    rng = np.random.RandomState(9)
    n = 1 << 22
    keys = rng.randint(0, 1 << 18, n).astype(np.int32)
    vals = np.ones(n, np.int32)

    def run(per_slice=None, **kw):
        # Each run's peak is counted from what the card held before it:
        # the executor of an earlier run is gone, with its outputs.
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        # The hash lowering's split (discovery off), as the model prices.
        ex = bs.MeshExecutor(device="cuda", prefetch_depth=0,
                             auto_dense=False, **kw)
        if per_slice is not None:
            run_slice = ex._run_slice

            def measured(*a):
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out = run_slice(*a)
                torch.cuda.synchronize()
                per_slice.append(torch.cuda.max_memory_allocated() - before)
                return out

            ex._run_slice = measured
        rows = bs.result_shard_rows(bs.Session(executor=ex).run(
            bs.Reduce(bs.Const(4, keys, vals), lambda a, b: a + b)))
        torch.cuda.synchronize()
        return (rows, torch.cuda.max_memory_allocated() - held,
                list(ex.split_runs.values()))

    plain, plain_peak, _ = run()
    est = bs.MeshExecutor.wave_bytes_model(n // 4, 8, hash_table=True)
    budget = -(-est // 4)
    split, split_peak, splits = run(device_budget_bytes=budget)
    assert splits == [4]
    for g, w in zip(split, plain):
        for gc_, wc in zip(g, w):
            np.testing.assert_array_equal(gc_, wc)
    assert split_peak <= plain_peak, (split_peak, plain_peak)
    per_slice = []
    run(per_slice, device_budget_bytes=budget)
    assert len(per_slice) == 4 * 4
    assert max(per_slice) <= budget, (per_slice, budget)


def test_cogroup_on_the_card_matches_the_cpu(dev):
    """A two-input Cogroup with a hot key (its wave scatters 4096 wide
    on the card) equals the same Cogroup on the CPU, list for list, and
    routes its producers through K1."""
    import bigslice_tpu_torch as bs

    rng = np.random.RandomState(10)
    ak = np.concatenate([np.zeros(3000, np.int32),
                         rng.randint(0, 1 << 12, 1 << 16).astype(np.int32)])
    av = rng.randint(-999, 999, len(ak)).astype(np.int32)
    bk = rng.randint(1 << 11, 3 << 11, 1 << 15).astype(np.int32)
    bv = rng.randn(len(bk)).astype(np.float32)

    def run(device):
        ex = bs.MeshExecutor(device=device)
        res = bs.Session(executor=ex).run(
            bs.Cogroup(bs.Const(4, ak, av), bs.Const(4, bk, bv)))
        return bs.result_shard_rows(res), ex

    cuda_kernels.reset_launches()
    got, ex = run("cuda")
    assert cuda_kernels.LAUNCHES["hash_partition"] == 8
    assert list(ex.cogroup_caps.values()) == [4096]
    want, cpu = run("cpu")
    assert cpu.cogroup_caps == ex.cogroup_caps
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        for gc, wc in zip(g[1:], w[1:]):
            assert len(gc) == len(wc)
            for gl, wl in zip(gc, wc):
                np.testing.assert_array_equal(
                    np.asarray(gl).view(np.int32),
                    np.asarray(wl).view(np.int32))


def _count_input(n=1 << 20, span=1 << 16, seed=11):
    keys = np.random.RandomState(seed).randint(0, span, n).astype(np.int32)
    return keys, np.bincount(keys, minlength=span)


def test_local_reduce_on_the_card_matches_numpy(dev):
    """Phase 16's path at 2**20 rows: LocalExecutor on the card routes
    each producer frame through K1 (once a frame) and counts exactly."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.models.wordcount import wordcount_ids

    keys, bc = _count_input()
    cuda_kernels.reset_launches()
    ex = bs.LocalExecutor()
    res = bs.Session(executor=ex).run(wordcount_ids(4, keys, 1 << 16))
    shards = bs.result_shard_rows(res)
    assert cuda_kernels.LAUNCHES["hash_partition"] == 4
    assert cuda_kernels.LAUNCHES["hash_aggregate"] == 0
    got = {int(k): int(v) for s in shards for k, v in zip(*s)}
    assert got == {int(k): int(bc[k]) for k in np.nonzero(bc)[0]}
    for shard, (k, _) in enumerate(shards):
        ids, _ = cuda_kernels.hash_partition_plain([torch.from_numpy(k)], 4)
        assert bool((ids == shard).all())
    # The outputs stay on the card.
    frames = list(ex.reader(res.tasks[0], 0))
    assert all(c.is_cuda for f in frames for c in f.cols)


def test_local_reduce_procs_1_and_8_agree_and_equal_the_mesh(dev):
    """Task threads launch on the card concurrently: eight at once give
    the rows of one at a time, and the device executor's shards."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.models.wordcount import wordcount_ids

    keys, _ = _count_input(seed=12)
    runs = [bs.result_shard_rows(bs.Session(executor=ex).run(
        wordcount_ids(8, keys, 1 << 16)))
        for ex in (bs.LocalExecutor(procs=1), bs.LocalExecutor(procs=8),
                   bs.MeshExecutor())]
    for other in runs[1:]:
        for g, w in zip(other, runs[0]):
            for gc, wc in zip(g, w):
                np.testing.assert_array_equal(gc, wc)


def test_local_host_tier_on_the_card(dev, tmp_path):
    """Word count (host functions, str keys) and a host Map feeding a
    device Reduce on the card equal the CPU's local executor."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.models.wordcount import wordcount

    rng = np.random.RandomState(13)
    path = tmp_path / "corpus.txt"
    path.write_text("".join(
        " ".join(f"w{j % 500}" for j in rng.zipf(1.3, 8)) + "\n"
        for _ in range(4000)))
    keys = rng.randint(0, 5000, 50000).astype(np.int32)

    def slices():
        m = bs.Map(bs.Const(4, keys, keys), lambda a, b: (int(a) % 97, 1),
                   out=[np.int32, np.int32])
        return [wordcount(4, str(path)),
                bs.Reduce(m, lambda a, b: a + b)]

    for device in ("cuda", "cpu"):
        sess = bs.Session(executor=bs.LocalExecutor(device=device))
        got = [bs.result_shard_rows(sess.run(s)) for s in slices()]
        if device == "cuda":
            on_card = got
    for a, b in zip(on_card, got):
        for g, w in zip(a, b):
            for gc, wc in zip(g, w):
                assert list(gc) == list(wc)


def _same(got, want, float_tol=False):
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            if float_tol and gc.dtype.kind == "f":
                np.testing.assert_allclose(gc, wc, rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("executor", ["MeshExecutor", "LocalExecutor"])
def test_fold_on_the_card_matches_the_cpu(dev, executor):
    """A device Fold on the card, an order-sensitive int32 fn and a
    float32 one, over keys with a hot key: the rows equal the CPU run's
    (int bit for bit, float within rtol 1e-5), each shard takes as many
    steps as its longest group, K1 routes the shuffle and K2 never
    runs."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.parallel import segment

    keys, _ = _count_input(seed=14)
    keys = np.concatenate([keys, np.zeros(3000, np.int32)])
    rng = np.random.RandomState(15)
    ivals = rng.randint(-(2**31), 2**31 - 1, len(keys)).astype(np.int32)
    fvals = rng.randn(len(keys)).astype(np.float32)
    cases = ((ivals, lambda acc, v: acc * 31 + v, 7),
             (fvals, lambda acc, v: acc * 0.5 + v, 0.0))
    for vals, fn, init in cases:
        runs = {}
        for device in ("cuda", "cpu"):
            ex = getattr(bs, executor)(device=device)
            cuda_kernels.reset_launches()
            segment.reset_fold_steps()
            runs[device] = bs.result_shard_rows(bs.Session(executor=ex).run(
                bs.Fold(bs.Const(4, keys, vals), fn, init=init)))
            if device == "cuda":
                assert cuda_kernels.LAUNCHES["hash_partition"] > 0
                assert cuda_kernels.LAUNCHES["hash_aggregate"] == 0
                longest = [int(np.bincount(keys[np.isin(keys, s[0])]).max())
                           for s in runs[device]]
                assert segment.FOLD_STEPS["steps"] == sum(longest)
                assert segment.FOLD_STEPS["longest"] == int(
                    np.bincount(keys).max())
        _same(runs["cuda"], runs["cpu"], float_tol=True)


def test_reshard_on_the_card_matches_the_cpu(dev):
    """A Reduce over a Reshard from 4 to 16 shards on the card equals
    the CPU run, every row routed by K1."""
    import bigslice_tpu_torch as bs

    keys, bc = _count_input(seed=16)
    runs = {}
    for device in ("cuda", "cpu"):
        cuda_kernels.reset_launches()
        runs[device] = bs.result_shard_rows(bs.Session(
            executor=bs.MeshExecutor(device=device)).run(bs.Reduce(
                bs.Reshard(bs.Const(4, keys, np.ones(len(keys), np.int32)),
                           16), lambda a, b: a + b)))
        if device == "cuda":
            assert cuda_kernels.LAUNCHES["hash_partition"] > 0
    assert len(runs["cuda"]) == 16
    _same(runs["cuda"], runs["cpu"])
    got = {int(k): int(v) for s in runs["cuda"] for k, v in zip(*s)}
    assert got == {int(k): int(bc[k]) for k in np.nonzero(bc)[0]}


# -- the dense lowerings and the host tier (A5, A13) --------------------------


def test_routing_tables_on_the_card_equal_the_cpus(dev):
    """The dense routing tables hash ``arange(K)`` with K1 on the card:
    bit-equal to the tables the plain hash builds on the CPU."""
    from bigslice_tpu_torch.parallel import dense

    for K, nparts in ((1, 1), (200, 4), ((1 << 16) + 3, 16), (1 << 20, 4)):
        before = cuda_kernels.LAUNCHES["hash_partition"]
        table, maxc = dense.routing_tables(K, nparts, 5, device=dev)
        assert cuda_kernels.LAUNCHES["hash_partition"] == before + 1
        want, wmaxc = dense.routing_tables(K, nparts, 5, device="cpu")
        assert maxc == wmaxc
        np.testing.assert_array_equal(table, want)
        pid, rank, _ = dense.rank_tables(K, nparts, 5, device=dev)
        wpid, wrank, _ = dense.rank_tables(K, nparts, 5, device="cpu")
        np.testing.assert_array_equal(pid, wpid)
        np.testing.assert_array_equal(rank, wrank)


@pytest.mark.parametrize("op", ["max", "min"])
def test_dense_float_max_min_on_the_card(dev, op):
    """Float max and min in the dense combine and fold on the card (int
    order keys through atomics): NaN propagates with its bits and -0.0
    orders below +0.0, bit-equal to the CPU's table."""
    from bigslice_tpu_torch.parallel import dense

    rng = np.random.RandomState(21)
    n, K = 1 << 20, 1 << 12
    key = rng.randint(0, K, n).astype(np.int32)
    v = rng.randn(n).astype(np.float32)
    v[rng.randint(0, n, 300)] = 0.0
    v[rng.randint(0, n, 300)] = -0.0
    v[rng.randint(0, n, 40)] = np.nan
    v[rng.randint(0, n, 40)] = -np.nan
    hot = key < 8  # a few slots of zeros of both signs only
    v[hot] = np.where(rng.rand(int(hot.sum())) < 0.5, 0.0, -0.0)
    valid = rng.rand(n) < 0.95
    outs = {}
    for d in (dev, torch.device("cpu")):
        args = (torch.from_numpy(valid).to(d), (torch.from_numpy(key).to(d),))
        comb = dense.make_dense_combine(K, (op,))(
            *args, (torch.from_numpy(v).to(d),))
        fold = dense.make_dense_fold(K, op, np.float32, -0.0)(
            *args, (torch.from_numpy(v).to(d),))
        outs[d.type] = [comb[0].cpu(), comb[2][0].cpu(), fold[2][0].cpu()]
    assert torch.equal(outs["cuda"][0], outs["cpu"][0])
    for g, w in zip(outs["cuda"][1:], outs["cpu"][1:]):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_misprobe_retraction_with_prefetch_and_donation(dev):
    """A host-tier producer (a host Map) feeds a device Reduce whose
    inputs are staged from the store (owned, donated at settle) at
    prefetch depth 1: the consumer's first wave holds keys below 2**10
    only, a later wave keys past 2**14, so the probed bound is retracted
    and the whole group reruns from freshly staged inputs. Rows equal
    numpy and the CPU run."""
    import bigslice_tpu_torch as bs

    S = 8
    cand = torch.arange(1 << 14, 1 << 16, dtype=torch.int32)
    part, _ = cuda_kernels.hash_partition_plain([cand], S, 0)
    big = cand[part != 0][:500].numpy()
    rng = np.random.RandomState(22)
    keys = np.concatenate([rng.randint(0, 1 << 10, 1 << 16), big]
                          ).astype(np.int32)
    vals = np.ones(len(keys), np.int32)

    def run(device):
        ex = bs.MeshExecutor(device=device, prefetch_depth=1,
                             donate_buffers=True)
        ids = bs.Map(bs.Const(S, keys, vals),
                     lambda k, v: (int(k), int(v)), out=[np.int32, np.int32])
        red = bs.Reduce(ids, lambda a, b: a + b)
        rows = bs.result_shard_rows(bs.Session(executor=ex).run(red))
        return rows, ex, red

    got, ex, red = run("cuda")
    assert red.frame_combiner.dense_keys is None
    assert any(op.startswith("reduce") for op in ex.auto_dense_off)
    want, _, _ = run("cpu")
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            np.testing.assert_array_equal(gc, wc)
    bc = np.bincount(keys)
    assert {int(k): int(c) for s in got for k, c in zip(*s)} == {
        int(k): int(bc[k]) for k in np.nonzero(bc)[0]}


# -- dictionary-encoded string keys and the result cache --------------------


@pytest.mark.parametrize("executor", ["MeshExecutor", "LocalExecutor"])
def test_dict_encoded_reduce_on_the_card_matches_the_cpu(dev, executor):
    """The encoded Reduce (codes dense over the vocabulary) on the card
    gives the CPU's rows, and the urls model's encoded count too."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.frame import dictenc
    from bigslice_tpu_torch.models import urls

    rng = np.random.RandomState(21)
    words = np.array([f"w{int(i)}" for i in rng.zipf(1.3, 1 << 16) % 5000],
                     dtype=object)
    lines = [f"http://S{int(d)}.example.com/p/{i & 1023}"
             for i, d in enumerate(rng.zipf(1.5, 1 << 16) % 500)]
    got = {}
    for device in ("cuda", "cpu"):
        sess = bs.Session(executor=getattr(bs, executor)(device=device))
        vocab = dictenc.GlobalVocab(sorted(set(words)))
        rows = dictenc.dict_encoded_reduce(
            sess, bs.Const(4, words, np.ones(len(words), np.int32)),
            lambda a, b: a + b, vocab)
        got[device] = (sorted(rows),
                       sorted(urls.domain_count_encoded(sess, 4, lines)))
    assert got["cuda"] == got["cpu"]
    assert dict(got["cuda"][0]) == {
        w: int(c) for w, c in zip(*np.unique(words, return_counts=True))}


def test_cache_round_trip_on_the_card(dev, tmp_path):
    """A Cache over a device Reduce on the card writes host copies of
    its columns; a second session over the same prefix reads the same
    rows with no kernel launched and no group on the device path."""
    import bigslice_tpu_torch as bs

    keys = np.random.RandomState(22).randint(0, 1 << 16, 1 << 20).astype(
        np.int32)
    ones = np.ones(len(keys), np.int32)
    prefix = str(tmp_path / "c")

    def build():
        return bs.Cache(bs.Reduce(bs.Const(4, keys, ones),
                                  lambda a, b: a + b), prefix)

    cuda_kernels.reset_launches()
    ex = bs.MeshExecutor(auto_dense=False)
    rows = sorted(bs.Session(executor=ex).run(build()).rows())
    assert cuda_kernels.LAUNCHES["hash_partition"] > 0
    assert cuda_kernels.LAUNCHES["hash_aggregate"] > 0
    bc = np.bincount(keys)
    assert rows == [(int(k), int(bc[k])) for k in np.nonzero(bc)[0]]
    cuda_kernels.reset_launches()
    ex2 = bs.MeshExecutor(auto_dense=False)
    res = bs.Session(executor=ex2).run(build())
    assert sorted(res.rows()) == rows
    assert all(v == 0 for v in cuda_kernels.LAUNCHES.values())
    assert not ex2._outputs
    cpu = bs.Session(executor=bs.LocalExecutor(device="cpu")).run(
        bs.ReadCache([np.int32, np.int32], 4, prefix))
    assert sorted(cpu.rows()) == rows


def test_hash_host_column_native_on_the_card_machine(dev, monkeypatch):
    """The native CRC builds on the card's host and equals the per-row
    path, bit for bit."""
    from bigslice_tpu_torch import native
    from bigslice_tpu_torch.frame import ops as frame_ops
    from bigslice_tpu_torch.frame.frame import obj_col

    col = obj_col([f"key{i}" for i in range(4096)] + ["Ünï", ""])
    native.reset_calls()
    h1 = frame_ops.hash_host_column(col, seed=5)
    assert native.CALLS["crc32_strings"] == 1
    monkeypatch.setenv("BIGSLICE_NATIVE", "0")
    np.testing.assert_array_equal(h1, frame_ops.hash_host_column(col, seed=5))


@pytest.mark.parametrize("shape", ["map-wave", "counts", "mixed"])
def test_declared_hash_partition_cost_is_the_byte_model(dev, shape):
    """A K1 launch on the card declares the bytes of its tensors: the
    keys, the mask and the ids of every row, and the histogram."""
    n = 1 << 20
    keys = [torch.from_numpy(k).to(dev) for k in _mixed(n, 5)[:3]]
    if shape == "map-wave":
        keys, valid, counts = keys[:1], torch.ones(n, dtype=torch.bool,
                                                   device=dev), False
    elif shape == "counts":
        keys, valid, counts = keys[:1], None, True
    else:
        valid, counts = torch.ones(n, dtype=torch.bool, device=dev), True
    heard = []
    with cuda_kernels.launch_sink(lambda name, cost: heard.append(
            (name, cost))):
        ids, hist = cuda_kernels.hash_partition(keys, 4, 0,
                                                with_counts=counts,
                                                valid=valid)
    torch.cuda.synchronize()
    want = sum(k.nbytes for k in keys) + ids.nbytes
    want += valid.nbytes if valid is not None else 0
    want += hist.nbytes if hist is not None else 0
    assert heard == [("hash_partition", {
        "bytes": want, "flops": n * (8 * len(keys) + 2)})]


def test_declared_hash_aggregate_cost_is_the_byte_model(dev):
    n, nparts, R = 1 << 20, 4, 1 << 18
    g = torch.Generator(device="cpu").manual_seed(3)
    key = torch.randint(0, 1 << 16, (n,), generator=g,
                        dtype=torch.int32).to(dev)
    val = torch.ones(n, dtype=torch.int32, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    part, _ = cuda_kernels.hash_partition([key], nparts, 0,
                                          with_counts=False)
    heard = []
    with cuda_kernels.launch_sink(lambda name, cost: heard.append(
            (name, cost))):
        present, okeys, ovals, _ = cuda_kernels.hash_aggregate(
            valid, [key], [val], ["add"], part, nparts, R)
    torch.cuda.synchronize()
    want = (valid.nbytes + key.nbytes + val.nbytes + part.nbytes
            + present.nbytes + okeys[0].nbytes + ovals[0].nbytes)
    assert heard == [("hash_aggregate", {"bytes": want,
                                         "flops": n * 11})]


@pytest.mark.parametrize("executor", ["MeshExecutor", "LocalExecutor"])
def test_hub_launches_equal_the_launch_counts(dev, executor):
    """The hub's per-op kernel launches, summed, equal the LAUNCHES
    deltas of the run, and its peak HBM equals max_memory_allocated."""
    import bigslice_tpu_torch as bs

    n = 1 << 20
    keys = np.random.RandomState(9).randint(0, 1 << 16, n).astype(np.int32)
    if executor == "MeshExecutor":
        ex = bs.MeshExecutor(auto_dense=False)
    else:
        ex = bs.LocalExecutor(procs=4)
    sess = bs.Session(executor=ex)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(cuda_kernels.LAUNCHES)
    res = sess.run(bs.Reduce(bs.Const(4, keys, np.ones(n, np.int32)),
                             lambda a, b: a + b))
    rows = res.rows()
    torch.cuda.synchronize()
    delta = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    assert len(rows) == len(np.unique(keys))
    assert delta["hash_partition"] > 0
    dev_sum = sess.telemetry_summary()["device"]
    got = {k: 0 for k in before}
    for per_kernel in dev_sum["kernels"].values():
        for name, k in per_kernel.items():
            got[name] += k["launches"]
    assert got == delta
    if executor == "MeshExecutor":
        assert dev_sum["hbm"]["source"] == "memory_stats"
        assert dev_sum["hbm"]["peak_bytes"] == \
            torch.cuda.max_memory_allocated()


@pytest.mark.parametrize("nparts", [1, 4, 1000])
def test_hash_partition_bfloat16_keys(dev, nparts):
    """bfloat16 keys take the 16-bit float code: bit-equal to the plain
    version, -0.0 and +0.0 in one partition."""
    rng = np.random.RandomState(nparts)
    n = (1 << 20) + 5
    f = torch.from_numpy((rng.randn(n) * 1e3).astype(np.float32))
    for i, v in enumerate([0.0, -0.0, float("nan"), float("inf"),
                           float("-inf")]):
        f[i::97] = v
    key = f.to(torch.bfloat16).to(dev)
    before = cuda_kernels.LAUNCHES["hash_partition"]
    ids, counts = cuda_kernels.hash_partition([key], nparts, 5)
    assert cuda_kernels.LAUNCHES["hash_partition"] == before + 1
    want_ids, want_counts = cuda_kernels.hash_partition_plain(
        [key], nparts, 5)
    assert torch.equal(ids, want_ids)
    assert torch.equal(counts, want_counts)
    zero = torch.nonzero(key == 0).squeeze(1)
    assert bool((ids[zero] == ids[zero][0]).all())


@pytest.mark.parametrize("url", ["local", "memory"])
def test_parquet_reduce_on_the_card_matches_the_cpu(dev, tmp_path, url):
    """ParquetReader -> Reduce on the card (K1 routes each row group, K2
    on the reduce side) equals the same run on the CPU, shard by shard;
    write_parquet's files hold the same rows."""
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    fsspec = pytest.importorskip("fsspec")
    import bigslice_tpu_torch as bs

    rng = np.random.default_rng(12)
    n = 1 << 20
    keys = rng.integers(0, 1 << 16, n)
    vals = rng.integers(-(1 << 40), 1 << 40, n)
    base = (str(tmp_path / "in") if url == "local"
            else f"memory://gpu-parquet-{id(tmp_path)}")
    path = f"{base}/rows.parquet"
    if url == "local":
        (tmp_path / "in").mkdir()
    with fsspec.open(path, "wb") as fh:
        pq.write_table(pa.table({"k": keys, "v": vals}), fh,
                       row_group_size=1 << 16)

    def run(ex):
        return bs.Session(executor=ex).run(bs.Reduce(
            bs.ParquetReader(4, path, out=[np.int32, np.int32]),
            lambda a, b: a + b))

    cuda_kernels.reset_launches()
    res = run(bs.MeshExecutor(auto_dense=False))
    got = bs.result_shard_rows(res)
    assert cuda_kernels.LAUNCHES["hash_partition"] == 16
    assert cuda_kernels.LAUNCHES["hash_aggregate"] > 0
    want = bs.result_shard_rows(run(bs.MeshExecutor(device="cpu",
                                                    auto_dense=False)))
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            assert gc.tobytes() == wc.tobytes()
    sums = np.bincount(keys, weights=vals.astype(np.int32))
    k = np.concatenate([s[0] for s in got])
    v = np.concatenate([s[1] for s in got])
    assert np.array_equal(v, sums[k].astype(np.int64).astype(np.int32))
    res.write_parquet(f"{base}/out")
    for s in range(4):
        with fsspec.open(f"{base}/out-{s:04d}-of-0004.parquet", "rb") as fh:
            t = pq.read_table(fh)
        assert np.array_equal(np.sort(t.column(0).to_numpy()),
                              np.sort(got[s][0]))


def test_kmeans_on_the_card_matches_the_cpu(dev):
    """kmeans_step on the card against the CPU's, and kmeans through
    Session() on the card against the CPU run from the same start."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.models import kmeans as km

    rng = np.random.default_rng(3)
    pts = (rng.normal(0, 10, (32, 16))[rng.integers(0, 32, 1 << 14)]
           + rng.standard_normal((1 << 14, 16))).astype(np.float32)
    cents = pts[:32].copy()
    got = km.kmeans_step(torch.from_numpy(pts).to(dev),
                         torch.from_numpy(cents).to(dev)).cpu().numpy()
    want = km.kmeans_step(torch.from_numpy(pts),
                          torch.from_numpy(cents)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    cuda_kernels.reset_launches()
    on_card = km.kmeans(bs.Session(), pts, k=32, iters=3, num_shards=4)
    assert cuda_kernels.LAUNCHES["hash_partition"] > 0
    on_cpu = km.kmeans(bs.Session(executor=bs.MeshExecutor(device="cpu")),
                       pts, k=32, iters=3, num_shards=4)
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-4, atol=1e-4)


def test_profiler_window_holds_every_launch(dev, tmp_path):
    import json
    import threading

    from bigslice_tpu_torch.utils import xprof

    keys = [torch.arange(1 << 20, dtype=torch.int32, device=dev)]
    done = threading.Event()
    failed = []

    def launch():
        try:
            while not xprof.recording():
                pass
            for _ in range(8):
                cuda_kernels.hash_partition(keys, 4, 0)
            torch.cuda.synchronize()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            failed.append(e)
        finally:
            done.set()

    t = threading.Thread(target=launch)
    t.start()
    out = xprof.Profiler(device="cuda").window(
        60.0, out_dir=str(tmp_path / "w"), until=done)
    t.join()
    assert not failed, failed
    with open(str(tmp_path / "w" / out["files"][0])) as fp:
        events = json.load(fp)["traceEvents"]
    k1 = [e for e in events if e.get("cat") == "kernel"
          and "hash_partition_kernel" in str(e.get("name"))]
    assert len(k1) == 8
    assert any(e.get("name") == "xprof_warmup" for e in events)


# -- the robustness plane on the card ----------------------------------------

MESH_CHAOS_SPEC = ("5:mesh.dispatch=1.0x1~infra,staging.assemble=1.0x2,"
                   "shuffle.upload=1.0x2,store.read=0.25x4,"
                   "eval.resubmit=0.15x2")


def _sum_oracle(keys, vals):
    out = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        out[k] = out.get(k, 0) + v
    return out


@pytest.mark.parametrize("arena", [True, False], ids=["arena", "noarena"])
@pytest.mark.parametrize("prefetch", [0, 2], ids=["pf0", "pf2"])
def test_mesh_chaos_plan_on_the_card(dev, prefetch, arena):
    """The mesh chaos matrix at a small size on the card: equal to the
    fault-free run and to numpy, the op on probation with its
    resubmissions on the host tier, no fatal recovery, and the arena's
    buffers and the card's memory back where they were."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.task import iter_tasks
    from bigslice_tpu_torch.utils import faultinject

    rng = np.random.RandomState(11)
    keys = rng.randint(0, 4001, 1 << 16).astype(np.int32)
    vals = rng.randint(0, 100, 1 << 16).astype(np.int32)
    want = _sum_oracle(keys, vals)

    def run():
        ex = bs.MeshExecutor(prefetch_depth=prefetch, staging_arena=arena,
                             auto_dense=False)
        sess = bs.Session(executor=ex)
        res = sess.run(bs.Reduce(bs.Const(8, keys, vals),
                                 lambda a, b: a + b))
        rows = {int(k): int(v) for k, v in res.rows()}
        for t in iter_tasks(res.tasks):
            ex.discard(t)
        return rows, sess

    def chaos_run():
        plan = faultinject.install(faultinject.parse_plan(MESH_CHAOS_SPEC))
        try:
            rows, sess = run()
        finally:
            faultinject.clear()
        torch.cuda.synchronize()
        return rows, sess, sorted((e["site"], e["kind"], e["inv_id"])
                                  for e in plan.snapshot()["log"])

    base, _ = run()
    # The first run under the plan warms what the host tier's path
    # builds once a process; the second must end where the first did.
    _, _, log1 = chaos_run()
    mem0 = torch.cuda.memory_allocated()
    got, sess, log2 = chaos_run()
    assert got == base == want
    assert log1 == log2
    assert sum(1 for e in log2 if e[0] == "mesh.dispatch") == 1
    assert sess.telemetry_summary()["recovery"]["fatal_total"] == 0
    (prob,) = sess.executor.probation.values()
    assert prob["host_runs"] >= 8
    assert sess.executor.staging_arena.stats()["outstanding"] == 0
    assert torch.cuda.memory_allocated() == mem0


def test_wave_cancel_at_depth_2_returns_memory_and_arena(dev, monkeypatch):
    """A cancel at a wave boundary of a pipelined group (depth 2) on the
    card: the group lands CANCELLED, reruns, equals numpy; once every
    output is discarded the card's memory and the arena's outstanding
    count are at their baselines."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec import evaluate as evaluate_mod
    from bigslice_tpu_torch.exec.compile import compile_slice
    from bigslice_tpu_torch.exec.task import TaskState, iter_tasks

    rng = np.random.RandomState(5)
    keys = rng.randint(0, 1 << 14, 1 << 20).astype(np.int32)
    ones = np.ones(1 << 20, np.int32)
    ex = bs.MeshExecutor(prefetch_depth=2, auto_dense=False)
    make = lambda: bs.Reduce(bs.Const(8, keys, ones),  # noqa: E731
                             lambda a, b: a + b)
    warm = compile_slice(make())
    evaluate_mod.evaluate(ex, warm)
    for t in iter_tasks(warm):
        ex.discard(t)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    roots = compile_slice(make())
    fired = []
    orig = ex._telemetry_compute

    def settled(task0, wave, dur_s):
        if wave == 2 and not fired:
            fired.append(1)
            for t in iter_tasks(roots):
                if t.state == TaskState.RUNNING:
                    t.request_cancel()
        return orig(task0, wave, dur_s)

    monkeypatch.setattr(ex, "_telemetry_compute", settled)
    monkeypatch.setattr(evaluate_mod, "SWEEP_SECS", 0.05)
    states = []
    evaluate_mod.evaluate(ex, roots, monitor=lambda t, st: states.append(st))
    assert fired and TaskState.CANCELLED in states
    got = {}
    for t in roots:
        for f in ex.reader(t, 0):
            for k, v in f.rows():
                got[int(k)] = int(v)
    bc = np.bincount(keys)
    assert got == {int(k): int(bc[k]) for k in np.nonzero(bc)[0]}
    for t in iter_tasks(roots):
        ex.discard(t)
    torch.cuda.synchronize()
    assert ex.staging_arena.stats()["outstanding"] == 0
    assert torch.cuda.memory_allocated() == mem0


def test_deadline_abort_at_depth_2_returns_memory_and_arena(dev):
    """``run(deadline_s=0.5)`` with a stuck host-tier task at depth 2:
    DeadlineExceeded within the deadline and the drain bound, every task
    pending, the card's memory and the arena at their baselines, and a
    fresh run on the same session equal to numpy."""
    import time

    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.evaluate import (DEADLINE_DRAIN_SECS,
                                                  DeadlineExceeded)
    from bigslice_tpu_torch.utils import faultinject

    rng = np.random.RandomState(7)
    keys = rng.randint(0, 1 << 12, 1 << 18).astype(np.int32)
    ones = np.ones(1 << 18, np.int32)
    ex = bs.MeshExecutor(prefetch_depth=2, fallback_procs=1,
                         auto_dense=False)
    sess = bs.Session(executor=ex)

    def graph():
        s = bs.Map(bs.Const(4, keys, ones), lambda k, v: (k, v),
                   out=[np.int32, np.int32], mode="host")
        return bs.Reduce(s, lambda a, b: a + b)

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    faultinject.install(faultinject.parse_plan("5:task.run=1.0x1~stuck"))
    t0 = time.monotonic()
    try:
        with pytest.raises(DeadlineExceeded) as ei:
            sess.run(graph(), deadline_s=0.5)
    finally:
        faultinject.clear()
    assert time.monotonic() - t0 < 0.5 + DEADLINE_DRAIN_SECS
    assert ei.value.pending == 8
    torch.cuda.synchronize()
    assert ex.staging_arena.stats()["outstanding"] == 0
    assert torch.cuda.memory_allocated() == mem0
    res = sess.run(graph())
    bc = np.bincount(keys)
    assert {int(k): int(v) for k, v in res.rows()} == \
        {int(k): int(bc[k]) for k in np.nonzero(bc)[0]}


def test_infra_classifier_on_a_real_out_of_memory_error(dev, monkeypatch):
    """A real allocation past ``mem_get_info`` raises torch's
    OutOfMemoryError, which classifies as infra (and so takes probation
    to the host tier, equal to numpy); a sticky error's text does not."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.meshexec import _looks_like_infra_error

    free, _ = torch.cuda.mem_get_info(dev)
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(free + (8 << 30), dtype=torch.uint8, device=dev)
    assert _looks_like_infra_error(ei.value)
    wrapped = RuntimeError("a wave failed")
    wrapped.__cause__ = ei.value
    assert _looks_like_infra_error(wrapped)
    assert not _looks_like_infra_error(RuntimeError(
        "CUDA error: an illegal memory access was encountered\nCUDA "
        "kernel errors might be asynchronously reported at some other "
        "API call, so the stacktrace below might be incorrect."))
    assert not _looks_like_infra_error(RuntimeError(
        "CUDA error: device-side assert triggered"))

    ex = bs.MeshExecutor(auto_dense=False)
    orig = ex._execute_group
    once = []

    def oom_once(key, tasks):
        if not once:
            once.append(1)
            torch.empty(free + (8 << 30), dtype=torch.uint8, device=dev)
        return orig(key, tasks)

    monkeypatch.setattr(ex, "_execute_group", oom_once)
    rng = np.random.RandomState(3)
    keys = rng.randint(0, 999, 1 << 16).astype(np.int32)
    vals = rng.randint(0, 9, 1 << 16).astype(np.int32)
    res = bs.Session(executor=ex).run(bs.Reduce(bs.Const(4, keys, vals),
                                                lambda a, b: a + b))
    assert {int(k): int(v) for k, v in res.rows()} == _sum_oracle(keys, vals)
    assert len(ex.probation) == 1


# -- the operator plane on the card: kernel selection and the debug server --


def _count_reduce(bs, keys, shards=4):
    return bs.Reduce(bs.Const(shards, keys, np.ones(len(keys), np.int32)),
                     lambda a, b: a + b)


def _selected_run(monkeypatch, mode, keys, shards=4, auto_dense=False):
    """One counting Reduce on the card under ``BIGSLICE_KERNEL_SELECT``
    (``mode`` None: unset); (rows, decisions, launches)."""
    import bigslice_tpu_torch as bs

    if mode is None:
        monkeypatch.delenv("BIGSLICE_KERNEL_SELECT", raising=False)
    else:
        monkeypatch.setenv("BIGSLICE_KERNEL_SELECT", mode)
    sess = bs.Session(executor=bs.MeshExecutor(auto_dense=auto_dense))
    torch.cuda.synchronize()
    before = dict(cuda_kernels.LAUNCHES)
    res = sess.run(_count_reduce(bs, keys, shards))
    rows = sorted(map(tuple, res.rows()))
    torch.cuda.synchronize()
    launches = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    decisions = ([(d["kernel"], d["reason"]) for d in
                  sess.kernel_select.stats.summary()["decisions"]]
                 if sess.kernel_select is not None else None)
    monkeypatch.delenv("BIGSLICE_KERNEL_SELECT", raising=False)
    return rows, decisions, launches


def test_static_selection_launches_k2_for_sparse_keys_only(dev,
                                                           monkeypatch):
    """``static`` on the card: sparse int32 keys take the hash lowering
    (``static:cuda-kernel``, K2 launched, rows equal to the unset run's);
    float32 keys take the sort path, and no K2 launches."""
    rng = np.random.RandomState(14)
    base = rng.randint(0, 1 << 16, 1 << 20).astype(np.int64)
    sparse = ((base * 92821 + 17) % (1 << 30)).astype(np.int32)
    floats = (base.astype(np.float32) / 64.0)
    floats[:2] = [0.0, -0.0]
    unset, dec, unset_launches = _selected_run(monkeypatch, None, sparse)
    assert dec is None
    got, dec, launches = _selected_run(monkeypatch, "static", sparse)
    assert got == unset
    assert set(dec) == {("hash", "static:cuda-kernel")}
    assert launches["hash_aggregate"] > 0
    assert launches == unset_launches
    got, dec, launches = _selected_run(monkeypatch, "static", floats)
    assert set(dec) == {("sort", "hash-ineligible")}
    assert launches["hash_aggregate"] == 0
    assert launches["hash_partition"] > 0
    want = {}
    for k in np.where(floats == 0, np.float32(0), floats).tolist():
        want[k] = want.get(k, 0) + 1
    assert {float(k): int(v) for k, v in got} == want


def test_static_misprobe_launches_equal_the_unset_run(dev, monkeypatch):
    """A misprobe on the card under ``static``: the retracted reduce side
    decides again after its ``dense`` verdict, and K1's and K2's
    launches and the rows equal the unset run's."""
    rng = np.random.RandomState(11)
    keys = rng.randint(0, 8, 20 * 4096).astype(np.int32)
    keys[-4096:] = 500_000
    unset, dec, unset_launches = _selected_run(monkeypatch, None, keys,
                                               shards=20, auto_dense=True)
    assert dec is None and unset_launches["hash_aggregate"] > 0
    got, dec, launches = _selected_run(monkeypatch, "static", keys,
                                       shards=20, auto_dense=True)
    assert got == unset
    assert launches == unset_launches
    assert dec[-2:] == [("dense", "dense-bound"),
                        ("hash", "static:cuda-kernel")]


def test_measured_probe_on_the_card(dev):
    """A measured probe on the card: finite, positive medians for both
    cores, every sample timed, and the hash core's launches (a warm-up
    and PROBE_ITERS) the op's under kind kselect, equal to LAUNCHES."""
    from bigslice_tpu_torch.parallel import kernelselect as ks
    from bigslice_tpu_torch.utils.telemetry import TelemetryHub

    hub = TelemetryHub()
    sel = ks.KernelSelector("measured", hub, device="cuda")
    torch.cuda.synchronize()
    before = cuda_kernels.LAUNCHES["hash_aggregate"]
    kernel = sel.choose("gpu-probe-op", "s", nkeys=1, nvals=1,
                        ops=("add",), key_dtypes=("int32",),
                        val_dtypes=("int32",), hash_eligible=True,
                        dense_bound=False)
    assert kernel in ("hash", "sort")
    d = sel.stats.summary()["decisions"][0]
    assert d["reason"] in ("measured:probe", "measured:margin")
    assert set(d["walls_ms"]) == {"sort", "hash"}
    for name, samples in d["walls_all_ms"].items():
        assert len(samples) == ks.PROBE_ITERS
        assert all(np.isfinite(x) and x > 0 for x in samples), name
        assert np.isfinite(d["walls_ms"][name]) and d["walls_ms"][name] > 0
    launched = cuda_kernels.LAUNCHES["hash_aggregate"] - before
    assert launched == 1 + ks.PROBE_ITERS
    dev_sum = hub.device.summary()
    assert dev_sum["kselect"]["gpu-probe-op"]["hash_aggregate"][
        "launches"] == launched
    assert dev_sum["totals"]["launches"] == 0


def test_debug_device_launches_equal_launches(dev):
    """``/debug/device`` of a session on the card lists K1's and K2's
    launches, equal to the run's ``LAUNCHES`` delta and the hub's."""
    import json
    import urllib.request

    import bigslice_tpu_torch as bs

    sess = bs.Session(executor=bs.MeshExecutor(auto_dense=False),
                      debug_port=0)
    try:
        keys = np.random.RandomState(3).randint(0, 1 << 16, 1 << 20).astype(
            np.int32)
        torch.cuda.synchronize()
        before = dict(cuda_kernels.LAUNCHES)
        res = sess.run(_count_reduce(bs, keys))
        assert len(res.rows()) == len(np.unique(keys))
        torch.cuda.synchronize()
        delta = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
        with urllib.request.urlopen(
                f"http://127.0.0.1:{sess.debug.port}/debug/device",
                timeout=30) as r:
            doc = json.loads(r.read().decode())
        served = {k: 0 for k in delta}
        for per_kernel in doc["kernels"].values():
            for name, k in per_kernel.items():
                served[name] += k["launches"]
        assert served == delta
        assert delta["hash_partition"] > 0 and delta["hash_aggregate"] > 0
        assert doc["kernels"] == sess.telemetry_summary()["device"][
            "kernels"]
        assert doc["hbm"]["source"] == "memory_stats"
    finally:
        sess.shutdown()


@pytest.mark.parametrize("prefetch", [1, 2])
def test_measured_probe_under_the_pipeline_and_the_skew_split(dev, prefetch,
                                                              monkeypatch):
    """The probe's synchronisations at program build, on the group's
    thread, while the prefetcher stages later waves on the copy stream
    and the skew policy splits a hot wave: no deadlock, and the rows
    equal the unset run's."""
    import bigslice_tpu_torch as bs

    rng = np.random.RandomState(7)
    n = 1 << 20
    keys = np.where(rng.rand(n) < 0.7, 0,
                    rng.randint(0, 1 << 12, n)).astype(np.int32)
    ones = np.ones(n, np.int32)

    def run():
        sess = bs.Session(executor=bs.MeshExecutor(
            auto_dense=False, prefetch_depth=prefetch))
        res = sess.run(bs.Reduce(
            bs.Map(bs.Reshuffle(bs.Const(8, keys, ones)),
                   lambda k, v: (k, v + 0)),
            lambda a, b: a + b))
        return sorted(map(tuple, res.rows())), sess

    monkeypatch.delenv("BIGSLICE_KERNEL_SELECT", raising=False)
    monkeypatch.delenv("BIGSLICE_ADAPTIVE", raising=False)
    want, _ = run()
    monkeypatch.setenv("BIGSLICE_KERNEL_SELECT", "measured")
    monkeypatch.setenv("BIGSLICE_ADAPTIVE", "skew")
    got, sess = run()
    assert got == want
    assert sess.adaptive.stats.skew_splits >= 1
    assert any("walls_ms" in d for d in
               sess.kernel_select.stats.summary()["decisions"])


def _served_count(n_keys=4096):
    import bigslice_tpu_torch as bs

    keys = np.random.RandomState(15).randint(0, 1 << 20, 1 << 20).astype(
        np.int32)
    return bs.Reduce(bs.Const(4, keys % np.int32(n_keys),
                              np.ones(len(keys), np.int32)),
                     lambda a, b: a + b)


def test_served_reduce_on_the_card_through_the_program_cache(dev):
    """A pipeline served by ``ServeServer`` over a Session on the card:
    its rows equal the CPU server's, K1 and K2 launch, and a fresh
    Session attached finds every group program in the process-wide
    program cache, with the same rows and launches."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.serve import ServeServer, programcache

    cpu = ServeServer(bs.Session(executor=bs.MeshExecutor(device="cpu")))
    cpu.register("count", _served_count)
    want = cpu.invoke_request({"pipeline": "count", "max_rows": 1 << 13})
    cpu.session.shutdown()
    srv = ServeServer(bs.Session(executor=bs.MeshExecutor(auto_dense=False)))
    srv.register("count", _served_count)
    docs, launches, programs = [], [], []
    try:
        for fresh in (False, True):
            if fresh:
                old = srv.session
                srv.attach_session(bs.Session(
                    executor=bs.MeshExecutor(auto_dense=False)))
                old.shutdown()
            torch.cuda.synchronize()
            before = dict(cuda_kernels.LAUNCHES)
            code, doc = srv.invoke_request({"pipeline": "count",
                                            "max_rows": 1 << 13})
            torch.cuda.synchronize()
            assert code == 200, doc
            launches.append({k: cuda_kernels.LAUNCHES[k] - before[k]
                             for k in before})
            docs.append(sorted(map(tuple, doc["rows"])))
            programs.append(srv.session.telemetry_summary()["device"][
                "totals"])
        assert want[0] == 200
        assert docs[0] == docs[1] == sorted(map(tuple, want[1]["rows"]))
        assert launches[0] == launches[1]
        assert launches[0]["hash_partition"] and launches[0]["hash_aggregate"]
        assert programs[1]["program_builds"] == 0
        assert programs[1]["cross_session_hits"] >= 2
        assert programcache.program_cache_stats()["hits"] >= 2
    finally:
        srv.session.shutdown()


def test_first_launch_in_a_fresh_process_does_not_wait(dev):
    """C2.19: a fresh process's first K1 and K2 launch behind a 0.1 s
    busy-wait returns before it ends, since the library loads every
    kernel when it is built (``bs_load_kernels``)."""
    import json
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, str(root / "tools_torch_first_launch.py")],
        capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    for key in ("k1_first", "k2_first", "k1_second", "k2_second"):
        assert doc[key]["waited"] is False, doc
        assert doc[key]["ms"] < 50, doc


def _attention_inputs(seq, heads, hd, seed):
    rng = np.random.RandomState(seed)
    q3, k3, v3 = (rng.randn(seq, heads, hd).astype(np.float32) * 0.3
                  for _ in range(3))
    return (q3, k3, v3), [x.reshape(seq, heads * hd) for x in (q3, k3, v3)]


@pytest.mark.parametrize("method,block_q", [("auto", 0), ("ring", 128)])
def test_selfattend_on_the_card_fp32(dev, method, block_q):
    """The device stage on the card at seq 2^11 in full fp32 (TF32 off)
    against the host's float64 oracle."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.parallel.ulysses import dense_mha_reference

    assert not torch.backends.cuda.matmul.allow_tf32
    seq, heads, hd = 1 << 11, 2, 64
    (q3, k3, v3), flat = _attention_inputs(seq, heads, hd, 0)
    ex = bs.MeshExecutor()
    res = bs.Session(executor=ex).run(bs.SelfAttend(
        bs.Const(1, *flat), causal=True, heads=heads, method=method,
        block_q=block_q))
    out = np.stack([np.asarray(o) for (o,) in res.rows()])
    ref = dense_mha_reference(q3, k3, v3, causal=True).reshape(seq, -1)
    np.testing.assert_allclose(out, ref, rtol=3e-4, atol=3e-4)
    assert set(ex.attend_methods.values()) == {
        "ulysses" if method == "auto" else "ring"}


@pytest.mark.parametrize("method,block_q", [("auto", 0), ("ring", 128)])
def test_selfattend_on_the_card_bf16(dev, method, block_q):
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.parallel.ulysses import dense_mha_reference

    seq, heads, hd = 1 << 11, 2, 64
    (q3, k3, v3), flat = _attention_inputs(seq, heads, hd, 1)
    res = bs.Session(executor=bs.MeshExecutor()).run(bs.SelfAttend(
        bs.Const(1, *flat), causal=True, heads=heads, method=method,
        block_q=block_q, dtype=torch.bfloat16))
    out = np.stack([np.asarray(o) for (o,) in res.rows()])
    assert out.dtype == np.float32
    ref = dense_mha_reference(q3, k3, v3, causal=True).reshape(seq, -1)
    np.testing.assert_allclose(out, ref, rtol=3e-2, atol=3e-2)
    # At 0.3 * randn the softmax is nearly uniform, so the elementwise
    # tolerance alone would pass a body that ignored q k^T and returned
    # the causal running mean of v (a relative error of about 8e-2);
    # bf16 rounding of q, k, v and p gives about 2e-3.
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel <= 1e-2, rel


def test_selfattend_attend_methods_and_tiers_on_the_card(dev):
    """The lowering's choice on the card's one slot, S > 1 on the host
    tier, and the refusal of fp32 attention under TF32."""
    import bigslice_tpu_torch as bs
    from bigslice_tpu_torch.exec.task import TaskError

    _, flat = _attention_inputs(256, 4, 16, 2)
    cases = [(dict(heads=4), {"ulysses"}), (dict(heads=1), {"ring"}),
             (dict(heads=4, block_q=32), {"ring"}),
             (dict(heads=4, method="ring"), {"ring"})]
    for kw, want in cases:
        ex = bs.MeshExecutor()
        bs.Session(executor=ex).run(bs.SelfAttend(bs.Const(1, *flat),
                                                  **kw)).rows()
        assert set(ex.attend_methods.values()) == want, kw
    ex = bs.MeshExecutor()
    rows = bs.Session(executor=ex).run(bs.SelfAttend(
        bs.Const(4, *flat), heads=4)).rows()
    assert len(rows) == 256 and ex.attend_methods == {}
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(TaskError, match="allow_tf32"):
            bs.Session(executor=bs.MeshExecutor()).run(
                bs.SelfAttend(bs.Const(1, *flat), heads=4))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_spmd_two_ranks_share_the_card_over_gloo(dev, tmp_path):
    """chip_smoke.py's phase 32 at a small size: two ranks on the one
    card over gloo run the mesh k-means step and the keyed Reduce
    (K2's map-side combine and K1's routing on each rank, CUDA tensors
    handed to gloo), every row checked; then one rank over NCCL runs
    the exchange seam's own path."""
    import json
    import os
    import sys

    from bigslice_tpu_torch.tools import multihost_smoke as ms

    cmd = [sys.executable, "-m", "bigslice_tpu_torch.tools.multihost_smoke",
           "--worker", "--out", str(tmp_path), "--backend", "gloo",
           "--rows", str(1 << 18), "--keyspace", str(1 << 14),
           "--shards", "8", "--threads", "2"]
    res = ms.launch(2, cmd, deadline_s=240)
    assert res.rc == 0, res.stderr
    for r in range(2):
        with open(os.path.join(tmp_path, f"rank{r}.json")) as fh:
            rep = json.load(fh)
        assert rep["ok"], rep
        assert rep["backend"] == "gloo" and rep["transport"] == "cuda"
        assert rep["launches"]["hash_partition"] > 0
        assert rep["launches"]["hash_aggregate"] > 0
        assert rep["exchanged_bytes"] > 0
    nccl = tmp_path / "nccl"
    nccl.mkdir()
    res = ms.launch(1, [sys.executable, "-m",
                        "bigslice_tpu_torch.tools.multihost_smoke",
                        "--worker", "--out", str(nccl), "--mode", "nccl1"],
                    deadline_s=120)
    assert res.rc == 0, res.stderr
    with open(os.path.join(nccl, "rank0.json")) as fh:
        rep = json.load(fh)
    assert rep["ok"] and rep["backend"] == "nccl", rep


_PPERMUTE_RANKS = r"""
import json, os, sys
import numpy as np
import torch
import bigslice_tpu_torch as bs
from bigslice_tpu_torch.exec.spmd import spmd_session
from bigslice_tpu_torch.frame.frame import to_numpy
from bigslice_tpu_torch.parallel.ulysses import dense_mha_reference
from bigslice_tpu_torch.utils import distributed

torch.backends.cuda.matmul.allow_tf32 = False
rng = np.random.RandomState(3)
q, k, v = (rng.randn(256, 32).astype(np.float32) * 0.3 for _ in "qkv")
ring = bs.func(lambda n: bs.SelfAttend(bs.Const(n, q, k, v), causal=True,
                                       heads=2, method="ring"))
uly = bs.func(lambda n: bs.SelfAttend(bs.Const(n, q, k, v), causal=True,
                                      heads=2, method="ulysses"))
distributed.initialize(backend="gloo")
rank, n = distributed.process_index(), distributed.process_count()
mesh = distributed.global_mesh()
rep = {"checks": {}}
dev = mesh.device
for name, x in (("int32", torch.arange(64, dtype=torch.int32, device=dev)),
                ("bf16", (torch.arange(64, device=dev).reshape(8, 8) / 7
                          ).to(torch.bfloat16)),
                ("uint32", torch.arange(2**32 - 8, 2**32, dtype=torch.int64,
                                        device=dev).to(torch.uint32))):
    mine = x + rank if x.dtype != torch.uint32 else x
    got = mesh._ppermute(mine, 1)
    want = x + (rank - 1) % n if x.dtype != torch.uint32 else x
    rep["checks"][name] = bool(got.device == dev and got.dtype == x.dtype
                               and torch.equal(got, want))
sess = spmd_session()
oracle = dense_mha_reference(q.reshape(256, 2, 16), k.reshape(256, 2, 16),
                             v.reshape(256, 2, 16), causal=True)
oracle = oracle.reshape(256, 32)
for name, fn in (("ring", ring), ("ulysses", uly)):
    res = sess.run(fn, n)
    got = np.concatenate([np.concatenate([to_numpy(f.cols[0])
                                          for f in res.reader(s, ())])
                          for s in range(n)])
    rep[name + "_err"] = float(np.abs(got - oracle).max())
rep["methods"] = sorted(sess.executor.attend_methods.values())
rep["ppermutes"] = mesh.collectives.get("ppermute", 0)
with open(os.path.join(sys.argv[1], f"rank{rank}.json"), "w") as fh:
    json.dump(rep, fh)
mesh.barrier()
sess.shutdown()
distributed.shutdown()
"""


def test_ppermute_with_cuda_tensors_on_the_ranks(dev, tmp_path):
    """The ring's rotation (``Mesh.ppermute``: one ``all_to_all_single``
    with the neighbour's split only) hands gloo the card's tensors: two
    ranks sharing the card rotate int32, bf16 and uint32 planes, then
    run a SelfAttend over both ranks through the ring and Ulysses,
    within 3e-4 of the float64 oracle."""
    import json
    import os
    import sys

    from bigslice_tpu_torch.tools import multihost_smoke as ms

    res = ms.launch(2, [sys.executable, "-c", _PPERMUTE_RANKS,
                        str(tmp_path)], deadline_s=240)
    assert res.rc == 0, res.stderr
    for r in range(2):
        with open(os.path.join(tmp_path, f"rank{r}.json")) as fh:
            rep = json.load(fh)
        assert all(rep["checks"].values()), rep
        assert rep["ring_err"] <= 3e-4 and rep["ulysses_err"] <= 3e-4, rep
        assert rep["methods"] == ["ring", "ulysses"] and rep["ppermutes"] > 0


_HIER_RANKS = r"""
import json, os, sys
import numpy as np
import torch
import bigslice_tpu_torch as bs
from bigslice_tpu_torch.exec.meshexec import MeshExecutor
from bigslice_tpu_torch.parallel import cuda_kernels, hier
from bigslice_tpu_torch.utils import distributed

keys = np.random.RandomState(42).randint(0, 1 << 12, 1 << 16).astype(np.int32)
red = bs.func(lambda s: bs.Reduce(bs.Const(s, keys, np.ones(1 << 16,
                                                            np.int32)),
                                  lambda a, b: a + b))
distributed.initialize(backend="gloo")
rank, n = distributed.process_index(), distributed.process_count()
grid = distributed.global_mesh()
rep = {"is_hier": grid.is_hier}
cap = 1024
k = torch.arange(cap, dtype=torch.int32, device=grid.device) + rank * cap
sh = hier.HierMeshShuffle(grid, ncols=1, nkeys=1, capacity=cap)
cols, cnt, ov = sh([k], torch.tensor([cap], dtype=torch.int32))
rep["shuffle_on_card"] = cols[0].device.type
rep["shuffle_rows"] = int(cnt[0])
rep["shuffle_overflow"] = int(ov)
sess = bs.Session(executor=MeshExecutor(mesh=grid, auto_dense=False))
before = dict(cuda_kernels.LAUNCHES)
rows = bs.result_shard_rows(sess.run(red, 4 * n))
rep["launches"] = {kk: v - before[kk] for kk, v in
                   cuda_kernels.LAUNCHES.items()}
got = {}
for kk, vv in rows:
    got.update(zip(kk.tolist(), vv.tolist()))
want = np.bincount(keys)
rep["rows_ok"] = got == {i: int(c) for i, c in enumerate(want) if c}
rep["collectives"] = dict(grid.collectives)
with open(os.path.join(sys.argv[1], f"rank{rank}.json"), "w") as fh:
    json.dump(rep, fh)
grid.barrier()
sess.shutdown()
distributed.shutdown()
"""


def test_hier_exchange_subgroup_planes_on_the_card(dev, tmp_path):
    """Four ranks sharing the card over gloo as a 2x2 grid: the two
    stages move CUDA planes within row and column subgroups, every key
    lands once with its count, and K1 routes (K2 on the reduce side)."""
    import json
    import os
    import sys

    from bigslice_tpu_torch.tools import multihost_smoke as ms

    res = ms.launch(4, [sys.executable, "-c", _HIER_RANKS, str(tmp_path)],
                    deadline_s=300, env={"BIGSLICE_MESH_SHAPE": "2x2"})
    assert res.rc == 0, res.stderr
    total = 0
    for r in range(4):
        with open(os.path.join(tmp_path, f"rank{r}.json")) as fh:
            rep = json.load(fh)
        assert rep["is_hier"] and rep["rows_ok"], rep
        assert rep["shuffle_on_card"] == "cuda"
        assert rep["shuffle_overflow"] == 0
        total += rep["shuffle_rows"]
        assert rep["launches"]["hash_partition"] > 0
        assert rep["launches"]["hash_aggregate"] > 0
        assert rep["collectives"]["all_to_all_ici"] > 0
        assert rep["collectives"]["all_to_all_dcn"] > 0
    assert total == 4 * 1024


def test_aotcheck_builds_every_source_on_the_card(dev, tmp_path):
    """The sm_90a build check compiles every ``csrc/*.cu`` and reports
    each kernel's registers and shared memory."""
    from bigslice_tpu_torch.tools import aotcheck

    report = aotcheck.check(str(tmp_path / "aot.json"))
    assert set(report["sources"]) == {p.name for p in aotcheck.sources()}
    kernels = [k for e in report["sources"].values()
               for k in e["kernels"].values()]
    assert kernels and all(k["registers"] > 0 for k in kernels)


# -- K2 over vector value columns (chip_smoke.py phase 2's shapes, cut) --


def _vector_table_rows(got):
    """Occupied slots key by key: (sorted keys, each table's rows; a
    uint32 table's as its int32 bits, which CUDA can gather)."""
    present, keys, vals = got[:3]
    idx = torch.nonzero(present).squeeze(1)
    k = keys[0][idx]
    order = torch.argsort(k)
    return k[order], [(v.view(torch.int32) if v.dtype == torch.uint32
                       else v)[idx][order] for v in vals]


def _check_vector_aggregate(dev, G, dtype, ops, n=1 << 16, nparts=4,
                            R=1 << 14, span=1 << 14, seed=0, keys=None):
    """K2 against its plain version over ``len(ops)`` [n, G] columns of
    ``dtype``: the same keys, int and float max/min bits equal (-0.0,
    +0.0 and NaN among the floats), a float add within 1e-4 relative
    and absolute (the kernel adds in the atomics' order of arrival, the
    plain version in row order: the sums of a few hundred normal values
    differ in their last bits)."""
    rng = np.random.RandomState(seed)
    if keys is None:
        keys = rng.randint(0, span, n).astype(np.int32)
    n = len(keys)
    vals = []
    for op in ops:
        if dtype == np.int32:
            v = (rng.randint(-1000, 1000, (n, G)) if op == "add" else
                 rng.randint(-(2**31), 2**31 - 1, (n, G))).astype(np.int32)
        elif dtype == np.uint32:
            v = rng.randint(0, 2**32, (n, G), dtype=np.int64).astype(
                np.uint32)
        else:
            v = rng.randn(n, G).astype(np.float32)
            v[::41, 0] = -0.0
            v[::43, G - 1] = 0.0
            v[::4099, G // 2] = np.nan
        vals.append(torch.from_numpy(v).to(dev))
    key = torch.from_numpy(keys).to(dev)
    valid = torch.from_numpy(rng.rand(n) < 0.95).to(dev)
    part, _ = cuda_kernels.hash_partition([key], nparts, 0,
                                          with_counts=False)
    before = cuda_kernels.LAUNCHES["hash_aggregate"]
    got = cuda_kernels.hash_aggregate(valid, [key], vals, list(ops), part,
                                      nparts, R)
    assert cuda_kernels.LAUNCHES["hash_aggregate"] == before + 1
    want = cuda_kernels.hash_aggregate_plain(valid, [key], vals, list(ops),
                                             part, nparts, R)
    torch.cuda.synchronize()
    assert int(got[3]) == int(want[3]) == 0
    (gk, gv), (wk, wv) = _vector_table_rows(got), _vector_table_rows(want)
    assert torch.equal(gk, wk)
    assert torch.unique(gk).shape[0] == gk.shape[0]
    for a, b, op in zip(gv, wv, ops):
        assert a.shape == b.shape == (gk.shape[0], G)
        if a.dtype == torch.float32 and op == "add":
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4,
                                       equal_nan=True)
        else:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # Empty slots hold the op's identity in every lane.
    from bigslice_tpu_torch.parallel.dense import identity_table

    empty = ~got[0]
    for t, op, v in zip(got[2], ops, vals):
        ident = identity_table(op, v.dtype, 1, dev, (G,))
        assert torch.equal(t.view(torch.int32)[empty],
                           ident.view(torch.int32).expand(
                               int(empty.sum()), G))
    return got


#: The most words a row of one vector column may have on K2's vector
#: route beside one key lane (a 32-slot sub-table in 232448 bytes).
BOUNDARY_G = 1814


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32],
                         ids=["int32", "uint32", "float32"])
@pytest.mark.parametrize("G", [1, 3, 4, 8, 9, 128, BOUNDARY_G])
def test_hash_aggregate_vector_values(dev, G, dtype, op):
    """Every G takes the kernel: [n, 1] as a value lane, every wider
    column as a value row gathered whole into the bucket's shared
    sub-table (16-byte loads at G = 4, 8 and 128, word by word at 3 and
    9), up to the boundary, where a bucket holds 32 slots."""
    assert cuda_kernels.aggregate_routes([(G,)]) == ("kernel",)
    n = 1 << 12 if G == BOUNDARY_G else 1 << 16
    _check_vector_aggregate(dev, G, dtype, [op], n=n, seed=G)


def test_hash_aggregate_past_the_boundary_scatters(dev):
    """One word past the boundary, the rows are placed on the keys and
    scattered whole after the kernel: rows equal all the same."""
    G = BOUNDARY_G + 1
    assert cuda_kernels.aggregate_routes([(G,)]) == ("scatter",)
    _check_vector_aggregate(dev, G, np.int32, ["add"], n=1 << 12, seed=G)


@pytest.mark.parametrize("G", [4, 9, 128])
def test_hash_aggregate_scalar_beside_vector(dev, G):
    """A scalar add column beside a vector max column: a value lane and
    a value row in one sub-table."""
    rng = np.random.RandomState(G)
    n, nparts, R = 1 << 16, 4, 1 << 14
    keys = rng.randint(0, R, n).astype(np.int32)
    s = torch.from_numpy(rng.randint(-50, 50, n).astype(np.int32)).to(dev)
    v = torch.from_numpy(rng.randn(n, G).astype(np.float32)).to(dev)
    key = torch.from_numpy(keys).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    part, _ = cuda_kernels.hash_partition([key], nparts, 0,
                                          with_counts=False)
    args = (valid, [key], [s, v], ["add", "max"], part, nparts, R)
    got = cuda_kernels.hash_aggregate(*args)
    want = cuda_kernels.hash_aggregate_plain(*args)
    (gk, gv), (wk, wv) = _vector_table_rows(got), _vector_table_rows(want)
    assert torch.equal(gk, wk)
    assert torch.equal(gv[0], wv[0])
    assert torch.equal(gv[1].view(torch.int32), wv[1].view(torch.int32))


@pytest.mark.parametrize("G", [8, 128])
def test_hash_aggregate_vector_spill(dev, G):
    """Keys homed in one bucket of region 1, half as many again as its
    slots, with [n, G] values: pass C places the keys the bucket cannot
    hold and combines their rows into the table, each key once."""
    from bigslice_tpu_torch.parallel import hashagg

    nparts, R = 4, 1 << 16
    plan = cuda_kernels.aggregate_plan(1, 0, nparts, R, 0, row_words=G)
    B = 1 << plan.bucket_log2
    cand = torch.arange(1 << 22, dtype=torch.int32)
    part, _ = cuda_kernels.hash_partition_plain([cand], nparts, 0,
                                                with_counts=False)
    home = (hashagg._slot_hash([cand], 0) & (R - 1)) >> plan.bucket_log2
    chosen = cand[(part == 1) & (home == 3)][:B + B // 2].numpy()
    keys = np.random.RandomState(G).permutation(np.repeat(chosen, 3))
    got = _check_vector_aggregate(dev, G, np.int32, ["add"], nparts=nparts,
                                  R=R, seed=G, keys=keys)
    assert int(got[0].sum()) <= len(chosen)
    # Some keys left the bucket: their slots lie outside its range.
    slots = torch.nonzero(got[0]).squeeze(1)
    B = 1 << plan.bucket_log2
    home = (slots - R) // B
    assert bool((home != 3).any())


@pytest.mark.parametrize("G", [8, 128])
def test_vector_value_reduce_on_the_card(dev, G):
    """An undeclared Reduce over [n, G] values through Session() on the
    card (phase 34's two shapes, cut): K1 and K2 launched, no op on the
    sort path, rows equal to the CPU run's (int32 exact)."""
    import bigslice_tpu_torch as bs

    rng = np.random.RandomState(G)
    n = 1 << 16
    keys = rng.randint(0, 1 << 12, n).astype(np.int32)
    vals = rng.randint(-1000, 1000, (n, G)).astype(np.int32)

    def run(device):
        ex = bs.MeshExecutor(device=device, auto_dense=False)
        res = bs.Session(executor=ex).run(
            bs.Reduce(bs.Const(4, keys, vals), lambda a, b: a + b))
        assert ex.hash_off == frozenset()
        return bs.result_shard_rows(res)

    cuda_kernels.reset_launches()
    got = run("cuda")
    assert cuda_kernels.LAUNCHES["hash_partition"] > 0
    assert cuda_kernels.LAUNCHES["hash_aggregate"] > 0
    want = run("cpu")
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            np.testing.assert_array_equal(gc, wc)


def test_declared_hash_aggregate_cost_counts_vector_rows(dev):
    """A [n, G] column's declared bytes are its rows' and its [T, G]
    table's; its flops one op a lane."""
    n, nparts, R, G = 1 << 16, 4, 1 << 14, 128
    key = torch.arange(n, dtype=torch.int32, device=dev) % 4096
    val = torch.ones((n, G), dtype=torch.float32, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    part, _ = cuda_kernels.hash_partition([key], nparts, 0,
                                          with_counts=False)
    heard = []
    with cuda_kernels.launch_sink(lambda name, cost: heard.append(
            (name, cost))):
        present, okeys, ovals, _ = cuda_kernels.hash_aggregate(
            valid, [key], [val], ["add"], part, nparts, R)
    torch.cuda.synchronize()
    want = (valid.nbytes + key.nbytes + val.nbytes + part.nbytes
            + present.nbytes + okeys[0].nbytes + ovals[0].nbytes)
    assert heard == [("hash_aggregate", {"bytes": want,
                                         "flops": n * (10 + G)})]


@pytest.mark.parametrize("case", ["int16", "float16", "nine-columns"])
def test_hash_aggregate_scatters_what_the_kernel_does_not_combine(dev,
                                                                  case):
    """Value columns of a dtype the kernel does not combine, or past its
    eight lanes, are scattered after it into their rows' slots: the
    occupied rows equal the plain version's key by key."""
    rng = np.random.RandomState(len(case))
    n, nparts, R = 1 << 16, 4, 1 << 14
    key = torch.from_numpy(rng.randint(0, R, n).astype(np.int32)).to(dev)
    if case == "nine-columns":
        vals = [torch.from_numpy(rng.randint(-50, 50, n).astype(np.int32))
                .to(dev) for _ in range(9)]
        ops = ["add", "max", "min"] * 3
    else:
        dt = np.int16 if case == "int16" else np.float16
        vals = [torch.from_numpy(rng.randint(-50, 50, n).astype(dt)).to(dev),
                torch.from_numpy(rng.randint(-50, 50, n).astype(np.int32))
                .to(dev)]
        ops = ["max", "add"]
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    part, _ = cuda_kernels.hash_partition([key], nparts, 0,
                                          with_counts=False)
    args = (valid, [key], vals, ops, part, nparts, R)
    got = cuda_kernels.hash_aggregate(*args)
    want = cuda_kernels.hash_aggregate_plain(*args)
    (gk, gv), (wk, wv) = _vector_table_rows(got), _vector_table_rows(want)
    assert torch.equal(gk, wk)
    for a, b in zip(gv, wv):
        assert a.dtype == b.dtype and torch.equal(a, b)
