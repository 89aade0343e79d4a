"""K2's planning on the host: how cuda_kernels.aggregate_plan cuts a
table into shared-memory buckets, and the scratch the wrapper allocates
for the kernel's three passes. Pure Python; no card needed."""

import pytest

torch = pytest.importorskip("torch")

from bigslice_tpu_torch.parallel import cuda_kernels as ck  # noqa: E402

#: Shared memory one H100 block may opt into, and one SM's whole.
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472


@pytest.mark.parametrize("nkeys,nvals,log2", [
    (1, 1, 13), (2, 3, 12), (4, 4, 11), (8, 1, 11), (1, 8, 11), (8, 8, 10),
])
def test_bucket_size_from_lanes(nkeys, nvals, log2):
    """B is the largest power of two whose claim word, key lanes and
    value lanes fit the budget: 8192 slots on the main path (one key,
    one value), 1024 at the most lanes."""
    plan = ck.aggregate_plan(nkeys, nvals, 4, 1 << 21, 1 << 23)
    assert plan.bucket_log2 == log2
    assert plan.smem_bytes == (1 + nkeys + nvals) * 4 << log2


@pytest.mark.parametrize("R", [1, 8, 64, 4096])
def test_bucket_never_wider_than_its_region(R):
    plan = ck.aggregate_plan(1, 1, 5, R, 100)
    assert 1 << plan.bucket_log2 == R
    assert plan.nbuckets == 5


@pytest.mark.parametrize("nparts,R,n", [
    (4, 1 << 21, 1 << 23), (1, 1 << 21, 1 << 21), (3, 1 << 16, 1000),
])
def test_plan_scratch_sizes(nparts, R, n):
    plan = ck.aggregate_plan(2, 3, nparts, R, n)
    B = 1 << plan.bucket_log2
    assert plan.nbuckets * B == nparts * R
    assert plan.payload_words == 5 * n
    assert plan.spill_words == 2 * n
    assert plan.meta_words == 3 * plan.nbuckets + 3


@pytest.mark.parametrize("nkeys", range(1, ck.MAX_COLS + 1))
def test_every_lane_count_fits_two_blocks_an_sm(nkeys):
    """Up to the most lanes (8 keys, 8 values): the sub-table fits the
    budget, two such blocks fit one SM, and a bucket twice as wide would
    not fit."""
    for nvals in range(1, ck.MAX_COLS + 1):
        plan = ck.aggregate_plan(nkeys, nvals, 4, 1 << 24, 1 << 20)
        lanes = 1 + nkeys + nvals
        assert plan.smem_bytes <= ck.AGG_SMEM_BUDGET <= SMEM_PER_BLOCK
        assert 2 * (plan.smem_bytes + 1024) <= SMEM_PER_SM
        assert 2 * plan.smem_bytes > ck.AGG_SMEM_BUDGET
        assert plan.smem_bytes == 4 * lanes << plan.bucket_log2


def test_aggregate_supported_domain():
    """Keys of the kernel's types only; values of any dtype and count,
    the ones the kernel does not combine (an int64 column, a ninth
    column) scattered after it (``aggregate_routes``)."""
    i32 = torch.int32
    assert ck.aggregate_supported([i32], [i32], 4, 1 << 21, 1 << 23)
    assert ck.aggregate_supported([torch.bool] * 8, [torch.float32] * 8,
                                  1, 8, 10)
    assert not ck.aggregate_supported([i32], [i32], 4, 3 << 20, 10)
    assert not ck.aggregate_supported([torch.float32], [i32], 4, 64, 10)
    assert ck.aggregate_supported([i32], [torch.int64], 4, 64, 10)
    assert ck.aggregate_routes([()], [torch.int64]) == ("scatter",)
    assert ck.aggregate_supported([i32], [i32] * 9, 4, 64, 10)
    assert ck.aggregate_routes([()] * 9, [i32] * 9) == (
        ("kernel",) * 8 + ("scatter",))
    assert not ck.aggregate_supported([i32], [], 4, 64, 10)
    assert not ck.aggregate_supported([i32] * 9, [i32], 4, 64, 10)
    assert not ck.aggregate_supported([i32], [i32], 4, 64, 2**31)
    assert not ck.aggregate_supported([i32], [i32], 2**20, 2**20, 10)


@pytest.mark.parametrize("G,log2,smem", [
    (8, 11, 10 * 4 << 11),
    (128, 7, 130 * 4 << 7),
    (766, 5, 768 * 4 << 5),
    (767, 6, 769 * 4 << 6),
    (1814, 5, SMEM_PER_BLOCK),
])
def test_bucket_size_for_vector_rows(G, log2, smem):
    """One key lane and a [n, G] column (G words a slot beside the 64-bit
    claim word): B within the two-blocks-an-SM budget while it keeps 32
    slots (2048 at G = 8, 128 at 34a's G = 128, 32 at G = 766), then
    within one block's whole shared memory (64 slots at G = 767), down
    to the 32 slots of the largest G the kernel takes (1814: exactly
    232448 bytes)."""
    plan = ck.aggregate_plan(1, 0, 4, 1 << 16, 1 << 18, row_words=G)
    assert plan.bucket_log2 == log2
    assert plan.smem_bytes == smem <= SMEM_PER_BLOCK
    assert plan.payload_words == 2 << 18
    assert ck.aggregate_routes([(G,)]) == ("kernel",)


def test_aggregate_buffers():
    """Outputs in the columns' dtypes, int32 scratch of the planned
    sizes, and the overflow count as the last word of meta."""
    keys = [torch.zeros(10, dtype=torch.int16),
            torch.zeros(10, dtype=torch.uint32)]
    vals = [torch.zeros(10, dtype=torch.float32)]
    plan = ck.aggregate_plan(2, 1, 2, 64, 10)
    buf = ck.aggregate_buffers(plan, keys, vals, 128, "cpu")
    assert buf.present.shape == (128,) and buf.present.dtype == torch.bool
    assert [k.dtype for k in buf.out_keys] == [torch.int16, torch.uint32]
    assert [t.dtype for t in buf.tables] == [torch.float32]
    assert buf.pay.numel() == 30 and buf.spill.numel() == 20
    assert buf.claim.numel() == 128
    assert buf.meta.numel() == 3 * plan.nbuckets + 3
    assert buf.overflow.dim() == 0
    assert buf.overflow.data_ptr() == buf.meta[-1].data_ptr()
