// K1, hash_partition. Replaces the JAX package's Pallas kernel
// bigslice_tpu/parallel/pallas_kernels.py hash_partition (:176-224,
// built by _build_hash_partition :80-173): for each row the murmur
// fmix32(bits(key) ^ seed32) per key column, the boost-style
// combine_hashes chain across columns, % nparts, invalid rows to the drop
// lane nparts; optionally the int32[nparts] histogram of routable rows.
//
// What bounds it on an H100: memory. It reads 4 bytes per key column and
// 1 per validity flag and writes 4 bytes of id per row, against about
// 15 integer operations per key column; at 3.35 TB/s the card moves those
// bytes far slower than it does the arithmetic. Reaching that rate takes
// about 2 MB of loads in flight across the card.
//
// Design: the pointers are __restrict__ and the columns load through the
// read-only path. With one 4-byte key column and 16-byte aligned columns
// each thread routes 4 consecutive rows per step: one 16-byte key load,
// one 4-byte load of the 4 flags and one 16-byte id store; the ragged
// edge of fewer than 4 rows goes through the scalar path. Otherwise (more
// key columns, narrower keys, unaligned views such as x[1:]) each thread
// routes 4 rows per step a block-width apart, all 4 rows' loads issued
// before their arithmetic. A power-of-two nparts takes a mask, not a
// remainder. Loops step a whole block at a time, so every warp runs each
// step in full. Histogram: with at most 32 partitions each warp counts
// with ballots over the ids' bit planes, bin p in lane p's register, and
// touches shared memory once at the end; with more, shared atomics per
// row into the block's bins; past 12288 bins, global atomics. Each block
// adds its non-zero bins to the global histogram once.
#include "common.cuh"

static constexpr int kSmemBins = 12 * 1024;  // 48 KiB of int32 bins
static constexpr int kRowsPerThread = 4;

enum HistMode : int {
  HIST_NONE = 0,
  HIST_BALLOT = 1,  // nparts <= 32: per-warp ballots
  HIST_SMEM = 2,    // shared atomics per row
  HIST_GLOBAL = 3,  // global atomics per row
};

// The 32-bit hash lane of a 4-byte key word (KEY_B32 or KEY_F32, whose
// -0.0 folds onto +0.0 as key_bits does).
__device__ __forceinline__ uint32_t word_bits(int code, uint32_t w) {
  return (code == KEY_F32 && (w & 0x7FFFFFFFu) == 0) ? 0u : w;
}

// A routing hash's partition: a mask when nparts is a power of two (the
// main path's 4), else the remainder.
__device__ __forceinline__ uint32_t part_of(uint32_t h, uint32_t nparts,
                                           bool pow2) {
  return pow2 ? (h & (nparts - 1u)) : (h % nparts);
}

// Counts the routed ids of one step of a warp-uniform loop. HIST_BALLOT
// takes the ids apart into nbits bit planes, one ballot each, and lane p
// counts the rows whose planes spell p: nbits + 1 ballots a row for all
// the bins at once.
__device__ __forceinline__ void count_ids(const uint32_t* id, int mode,
                                          uint32_t nparts, int nbits,
                                          uint32_t& mine, int32_t* hist,
                                          int32_t* counts) {
  if (mode == HIST_BALLOT) {
    const uint32_t lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      uint32_t m = __ballot_sync(0xFFFFFFFFu, id[r] < nparts);
      for (int bit = 0; bit < nbits; ++bit) {
        const uint32_t plane = __ballot_sync(0xFFFFFFFFu, (id[r] >> bit) & 1u);
        m &= ((lane >> bit) & 1u) ? plane : ~plane;
      }
      mine += __popc(m);
    }
  } else if (mode != HIST_NONE) {
    int32_t* bins = mode == HIST_SMEM ? hist : counts;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
      if (id[r] < nparts) atomicAdd(&bins[id[r]], 1);
  }
}

template <bool kVec>
__global__ void hash_partition_kernel(ColSet keys,
                                      const bool* __restrict__ valid,
                                      int32_t* __restrict__ ids,
                                      int32_t* __restrict__ counts,
                                      long long n, uint32_t nparts,
                                      uint32_t seed32, int mode) {
  extern __shared__ int32_t hist[];
  const bool smem_hist = mode == HIST_BALLOT || mode == HIST_SMEM;
  if (smem_hist) {
    for (uint32_t b = threadIdx.x; b < nparts; b += blockDim.x) hist[b] = 0;
    __syncthreads();
  }
  uint32_t mine = 0;  // HIST_BALLOT: the count of bin (lane) of this warp
  const bool pow2 = (nparts & (nparts - 1u)) == 0;
  const int nbits = nparts > 1 ? 32 - __clz(nparts - 1u) : 0;
  const long long block_rows =
      static_cast<long long>(blockDim.x) * kRowsPerThread;
  const long long grid_rows = block_rows * gridDim.x;
  long long scalar_from = 0;  // first row of the scalar path
  if (kVec) {
    const int code = keys.code[0];
    const uint4* __restrict__ k4 = static_cast<const uint4*>(keys.ptr[0]);
    const uint32_t* __restrict__ f4 =
        reinterpret_cast<const uint32_t*>(valid);
    int4* __restrict__ o4 = reinterpret_cast<int4*>(ids);
    const long long groups = n / kRowsPerThread;
    for (long long g0 = blockIdx.x * static_cast<long long>(blockDim.x);
         g0 < groups; g0 += static_cast<long long>(gridDim.x) * blockDim.x) {
      const long long g = g0 + threadIdx.x;
      uint32_t id[kRowsPerThread] = {nparts, nparts, nparts, nparts};
      if (g < groups) {
        const uint4 w = __ldg(k4 + g);
        const uint32_t f = valid ? __ldg(f4 + g) : 0x01010101u;
        const uint32_t word[kRowsPerThread] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          if ((f >> (8 * r)) & 0xFFu)
            id[r] = part_of(fmix32(word_bits(code, word[r]) ^ seed32), nparts,
                            pow2);
        o4[g] = make_int4(static_cast<int>(id[0]), static_cast<int>(id[1]),
                          static_cast<int>(id[2]), static_cast<int>(id[3]));
      }
      count_ids(id, mode, nparts, nbits, mine, hist, counts);
    }
    scalar_from = groups * kRowsPerThread;
  }
  // Scalar path: all rows, or the vector path's ragged edge (one step of
  // block 0).
  const long long first = kVec ? 0 : blockIdx.x * block_rows;
  if (!kVec || blockIdx.x == 0) {
    for (long long r0 = scalar_from + first; r0 < n;
         r0 += kVec ? n : grid_rows) {
      long long row[kRowsPerThread];
      uint32_t h[kRowsPerThread];
      uint32_t id[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        row[r] = r0 + r * static_cast<long long>(blockDim.x) + threadIdx.x;
        h[r] = 0;
      }
      // Column indices are constants (see hash_row); the vector path's
      // edge has its one column.
#pragma unroll
      for (int j = 0; j < (kVec ? 1 : BS_MAX_COLS); ++j) {
        if (j >= keys.n) break;
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          if (row[r] < n) {
            const uint32_t x = fmix32(key_bits(keys, j, row[r]) ^ seed32);
            h[r] = j ? combine_hashes(h[r], x) : x;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        id[r] = nparts;
        if (row[r] < n) {
          if (valid == nullptr ||
              __ldg(reinterpret_cast<const uint8_t*>(valid) + row[r]))
            id[r] = part_of(h[r], nparts, pow2);
          ids[row[r]] = static_cast<int32_t>(id[r]);
        }
      }
      count_ids(id, mode, nparts, nbits, mine, hist, counts);
    }
  }
  if (smem_hist) {
    if (mode == HIST_BALLOT && (threadIdx.x & 31) < nparts && mine)
      atomicAdd(&hist[threadIdx.x & 31], static_cast<int32_t>(mine));
    __syncthreads();
    for (uint32_t b = threadIdx.x; b < nparts; b += blockDim.x)
      if (hist[b]) atomicAdd(&counts[b], hist[b]);
  }
}

static inline bool aligned(const void* p, size_t bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

extern "C" int bs_hash_partition(const void* const* key_ptrs,
                                 const int* key_codes, int nkeys,
                                 const bool* valid, int32_t* ids,
                                 int32_t* counts, long long n, int nparts,
                                 unsigned int seed32, cudaStream_t stream) {
  const int block = 256;
  ColSet keys = make_colset(key_ptrs, key_codes, nkeys);
  const int mode = counts == nullptr ? HIST_NONE
                   : nparts <= 32    ? HIST_BALLOT
                   : nparts <= kSmemBins ? HIST_SMEM
                                         : HIST_GLOBAL;
  const size_t smem = (mode == HIST_BALLOT || mode == HIST_SMEM)
                          ? nparts * sizeof(int32_t)
                          : 0;
  const bool vec = nkeys == 1 &&
                   (key_codes[0] == KEY_B32 || key_codes[0] == KEY_F32) &&
                   aligned(key_ptrs[0], 16) && aligned(ids, 16) &&
                   aligned(valid, 4);
  const long long per_thread_rows = kRowsPerThread;
  const int grid = grid_for((n + per_thread_rows - 1) / per_thread_rows,
                            block);
  if (vec)
    hash_partition_kernel<true><<<grid, block, smem, stream>>>(
        keys, valid, ids, counts, n, static_cast<uint32_t>(nparts), seed32,
        mode);
  else
    hash_partition_kernel<false><<<grid, block, smem, stream>>>(
        keys, valid, ids, counts, n, static_cast<uint32_t>(nparts), seed32,
        mode);
  return static_cast<int>(cudaGetLastError());
}

// Loads this file's kernels into the current context (see
// bs_load_kernels in probe.cu).
extern "C" int bs_load_hash_partition() {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, hash_partition_kernel<true>);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, hash_partition_kernel<false>);
  return static_cast<int>(e);
}
