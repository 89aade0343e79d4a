// K2, hash_aggregate. Replaces the JAX package's Pallas kernel
// bigslice_tpu/parallel/pallas_kernels.py hash_aggregate_pallas
// (:436-510, built by _build_hash_aggregate :282-433): open-addressed
// aggregation of the selected rows into a destination-contiguous table of
// T = nparts * R slots, where region p holds only partition-p keys. Each
// distinct key ends in exactly one slot of its region and every row
// combines its values into that slot by add, max or min; rows left
// unplaced are counted as overflow.
//
// What bounds it on an H100: memory, if the rows' random table traffic is
// kept out of device memory. A design with one thread per row and the table
// in device memory pays three to four scattered 32-byte sectors per row
// (claim word, the owner's key, each value atomic) and runs at about 12 G
// rows/s whether the table fits the 50 MB L2 or not. This one moves every
// row's random work into shared memory and pays only streaming traffic.
//
// Design: the T slots are cut into buckets of B = 2^bshift consecutive slots
// inside one region, B chosen by the wrapper (cuda_kernels.aggregate_plan)
// so that a bucket's sub-table (claim word, key lanes, scalar value lanes
// and the vector columns' row words: 4 bytes each per slot) fits one
// block's shared memory. A row's home bucket is
// (p * R + (h & (R - 1))) >> bshift, with h the slot hash of
// hashagg._slot_hash (seed ^ SLOT_SEED_XOR). Three passes run on the stream:
//
//   A  bucket: count the selected rows per bucket (a shared histogram per
//      block; the last block to finish scans the counts), then scatter
//      each row's payload (its key lanes as 32-bit hash lanes, its scalar
//      value lanes as raw bits and, with vector columns or `placed`, its
//      row index) into bucket order. A block sorts its tile of rows
//      by bucket in shared memory and writes each lane out in runs; past
//      kStagedBins buckets rows scatter one by one. Invalid rows and rows
//      of no partition are dropped here and cost nothing later.
//   B  aggregate: one block per bucket streams its rows in with coalesced
//      loads, claims and combines in the shared sub-table with shared
//      atomics (float max/min by the CAS loop of fcombine_atomic), probing
//      by double hashing inside the bucket for at most 16 probes, then
//      writes its B slots of present, keys, values and claim words in one
//      coalesced pass, empty slots included (identity values, the last
//      row's key). A row that finds neither its key nor an empty slot goes
//      to the spill list.
//   C  spill: places the spilled rows into the finished table by double
//      hashing over the whole region (two-level: an odd stride over the
//      region's buckets and one over the slots in a bucket), with atomicCAS
//      claims on the claim words pass B left, for at most 64 probes; the
//      rows still unplaced are the overflow. It is always launched and
//      reads the spill count on the device.
//
// The claim race: a row must never compare against key lanes still being
// written. In pass B with one key lane a slot is one 64-bit word {1, key}
// claimed by a 64-bit shared atomicCAS, so the key is published with the
// claim. With more key lanes the claim word names the claimer's payload
// index, whose lanes in the pass-A buffer are immutable, and a row
// compares against those; the claimer's copy into the sub-table is read
// only after the block's barrier. In pass C a claim word is likewise the
// claimer's payload index, or says FILLED (by pass B), whose keys in the
// output are final.
//
// Why a key lands in exactly one slot: all rows of a key share one hash, so
// one home bucket and one probe sequence; a slot's key never changes once
// claimed, and occupancy only grows. A row that moves past a probe saw there
// a key other than its own, which stays so. Hence two rows of one key cannot
// claim two slots in the bucket, and a row spills only after seeing 16
// other keys on the sequence, so no row of its key is in the bucket and all
// of them spill. Pass C applies the same argument region-wide to the spilled
// keys, none of which is in any slot pass B filled.
//
// Bytes on the main path's map side (n = 2^23 rows, one int32 key and
// value, T = 2^23): A reads 9 n (count) + 13 n (scatter) and writes 8 n;
// B reads 8 n and writes 13 T; in all about 428 MB, 0.128 ms at 3.35 TB/s,
// against the table's own bound of 184 MB (every input read once, every
// output written once): the payload's round trip is the price of taking
// the random traffic off device memory.
//
// Value columns: a scalar column of int32, uint32 or float32 is one value
// lane, a 32-bit word a row, carried through pass A's payload beside the
// keys (at most BS_MAX_COLS lanes). A row-major [n, G] column (G > 1, such
// as k-means' d = 128 point sums) is one value row of G words: pass A
// carries only each row's index (one payload lane for all such columns),
// and pass B gathers each row whole from the column by that index, a group
// of lanes sized to G a row (16-byte loads where G is a multiple of 4 and
// the column 16-byte aligned), and combines it into a row-major [B, W]
// part of the bucket's sub-table (W the words of every vector column's
// row) with shared atomics. The bucket's B consecutive slots are then one
// contiguous [B, G] block of the column's [T, G] table, written with
// 16-byte stores. Pass C combines a spilled row's G words into its slot's
// row of the table from the row's own thread, with global atomics: only
// rows that met 16 other keys in their bucket get there. The wrapper
// (cuda_kernels.aggregate_plan) sizes B from the slot's words, 1 + key
// lanes + scalar lanes + W.
//
// What bounds the vector rows: bytes. Every row is read once by the
// gather and every [T, G] table written once; the keys' payload round
// trip adds 8 bytes a row to pass A, the row index 4 more. At the k-means
// map wave (n = 2^18 rows of 128 float32, T = 2^18) that is 128 MiB of
// rows read and 128 MiB of table written; the design keeps the random
// traffic (the combines) in shared memory and every global access of the
// rows and the table coalesced.
//
// Columns the kernel does not combine (int16, int8, float16, ...), and
// vector rows past what a sub-table of 32 slots can hold, are placed on
// the keys alone: the kernel writes `placed`, each row's slot (-1 for a
// row it did not place), through the same row-index lane, and the wrapper
// scatters those columns whole into their slots, the counterpart of the
// JAX package's claim-then-scatter table build (parallel/hashagg.py
// hash_aggregate).
#include "common.cuh"

// Probe bound per row in a bucket (AGG_PROBE_MAX of the JAX package).
static constexpr int kProbeMax = 16;
// Probe bound per spilled row in its region. A spilled key is lost when
// every probe meets another key, about load^probes: at a load of 0.63 (a
// reduce side whose rows are mostly distinct keys in bucket_size(rows)
// slots) that is 7e-4 a key with 16 probes, enough for such a table to
// overflow now and then and send its op to the sort path for good, and
// 2e-13 with 64. Only the rows pass B spilled walk it, so the longer walk
// costs little.
static constexpr int kSpillProbeMax = 64;

// Claim words pass B leaves for pass C; a claim word >= 0 is the payload
// index of the spilled row that claimed the slot in pass C.
static constexpr int32_t kSlotEmpty = -1;
static constexpr int32_t kSlotFilled = -2;
// Seeds pass C's strides from the slot hash.
static constexpr uint32_t kSpillSeed = 0x2545F491u;
// Seeds the vector rows' kernel's in-bucket probe step.
static constexpr uint32_t kStepSeed = 0x68E31DA4u;

static constexpr int kTileThreads = 1024;
static constexpr int kTileItems = 8;
static constexpr int kTileRows = kTileThreads * kTileItems;
// Buckets a scatter block can sort a tile by (two int32 arrays of bins,
// 32 KiB, beside the tile's buffers); more buckets scatter row by row.
static constexpr int kStagedBins = 4096;
// Bins, starts, the sorted positions and up to two staged lanes.
static constexpr int kStagedSmem = (2 * kStagedBins + 3 * kTileRows) * 4;
// Buckets the count pass histograms in 48 KiB of shared memory; its grid
// is two blocks an SM.
static constexpr int kCountBins = 12 * 1024;
static constexpr int kCountBlocks = 2 * 132;
static constexpr int kAggThreads = 512;
static constexpr int kSpillBlocks = 264;
static constexpr int kSmemMax = 232448;

// Value kinds: dtype * 3 + op, dtype 0 int32 / 1 uint32 / 2 float32,
// op 0 add / 1 max / 2 min (cuda_kernels._VAL_DTYPE_CODES, _OP_CODES).
__device__ __forceinline__ uint32_t identity_bits(int kind) {
  switch (kind) {
    case 1: return 0x80000000u;  // int32 max: INT32_MIN
    case 2: return 0x7FFFFFFFu;  // int32 min: INT32_MAX
    case 5: return 0xFFFFFFFFu;  // uint32 min: UINT32_MAX
    case 7: return 0xFF800000u;  // float32 max: -inf
    case 8: return 0x7F800000u;  // float32 min: +inf
    default: return 0u;          // adds (0, 0.0) and uint32 max (0)
  }
}

__device__ __forceinline__ float fcombine(float cur, float v, bool is_max) {
  if (isnan(v)) return v;
  if (isnan(cur)) return cur;
  if (is_max ? (v > cur) : (v < cur)) return v;
  if (v == cur) {
    // Equal values differ only in the sign of zero: max keeps +0.0
    // (bitwise AND clears the sign), min keeps -0.0 (OR sets it).
    uint32_t a = __float_as_uint(cur), b = __float_as_uint(v);
    return __uint_as_float(is_max ? (a & b) : (a | b));
  }
  return cur;
}

// jnp.maximum / jnp.minimum as an atomic on a shared or global word.
__device__ __forceinline__ void fcombine_atomic(uint32_t* addr, float v,
                                                bool is_max) {
  int* a = reinterpret_cast<int*>(addr);
  int old = *reinterpret_cast<volatile int*>(a);
  while (true) {
    int want = __float_as_int(fcombine(__int_as_float(old), v, is_max));
    if (want == old) return;
    int seen = atomicCAS(a, old, want);
    if (seen == old) return;
    old = seen;
  }
}

__device__ __forceinline__ void combine_at(uint32_t* addr, int kind,
                                           uint32_t v) {
  int* ai = reinterpret_cast<int*>(addr);
  switch (kind) {
    case 0: atomicAdd(ai, static_cast<int>(v)); break;
    case 1: atomicMax(ai, static_cast<int>(v)); break;
    case 2: atomicMin(ai, static_cast<int>(v)); break;
    case 3: atomicAdd(addr, v); break;
    case 4: atomicMax(addr, v); break;
    case 5: atomicMin(addr, v); break;
    case 6:
      atomicAdd(reinterpret_cast<float*>(addr), __uint_as_float(v));
      break;
    case 7: fcombine_atomic(addr, __uint_as_float(v), true); break;
    default: fcombine_atomic(addr, __uint_as_float(v), false); break;
  }
}

// The slot hash from a row's key lanes (the hash_row chain over the lanes
// key_bits gave); k holds KL >= nkeys lanes.
template <int KL>
__device__ __forceinline__ uint32_t hash_lanes(const uint32_t* k, int nkeys,
                                               uint32_t seed32) {
  uint32_t h = fmix32(k[0] ^ seed32);
#pragma unroll
  for (int j = 1; j < KL; ++j)
    if (j < nkeys) h = combine_hashes(h, fmix32(k[j] ^ seed32));
  return h;
}

// A key lane back into its column's dtype (aggregated keys are integer or
// bool columns: key_bits sign- or zero-extended them, truncation undoes it).
__device__ __forceinline__ void store_key(void* col, int code, long long i,
                                          uint32_t bits) {
  switch (code) {
    case KEY_I16:
    case KEY_U16:
      static_cast<uint16_t*>(col)[i] = static_cast<uint16_t>(bits);
      break;
    case KEY_I8:
    case KEY_U8:
      static_cast<uint8_t*>(col)[i] = static_cast<uint8_t>(bits);
      break;
    default:
      static_cast<uint32_t*>(col)[i] = bits;
      break;
  }
}

struct AggArgs {
  ColSet keys;                         // input key columns
  ColSet out_keys;                     // [T] key columns, to read
  void* out_key[BS_MAX_COLS];          // the same columns, to write
  const uint32_t* val[BS_MAX_COLS];    // input scalar value lanes (raw bits)
  uint32_t* out_val[BS_MAX_COLS];      // their [T] tables
  int kind[BS_MAX_COLS];
  int nvals;                           // scalar value lanes, 0..BS_MAX_COLS
  // Vector value columns: row-major [n, G] words, gathered whole by row.
  const uint32_t* row_val[BS_MAX_COLS];
  uint32_t* row_out[BS_MAX_COLS];      // their [T, G] tables
  int row_kind[BS_MAX_COLS];
  int row_g[BS_MAX_COLS];              // G, the words of a row
  int row_off[BS_MAX_COLS];            // its first word in a slot's row
  bool row_vec4[BS_MAX_COLS];          // G % 4 == 0, 16-byte aligned
  int nrows;                           // vector columns, 0..BS_MAX_COLS
  int row_words;                       // W: every vector column's words
  bool row_lane;                       // the payload carries row indices
  int32_t* placed;    // [n] each row's slot or -1; null: not wanted
  const bool* valid;
  const int32_t* part;
  long long n;
  int nparts;
  long long R;
  int bshift;                          // log2 of the bucket's slots
  int nbuckets;
  uint32_t seed32;
  uint32_t* pay;      // (nkeys + nvals [+ 1 row index]) lanes of n
                      // words, lane-major
  int32_t* spill;     // 2 words per spilled row: payload index, bucket
  int32_t* claim;     // [T] claim words for pass C
  int32_t* counts;    // [nbuckets] selected rows per bucket
  int32_t* starts;    // [nbuckets] first payload index of each bucket
  int32_t* cursor;    // [nbuckets] scatter cursors
  int32_t* nspill;
  int32_t* done;      // count blocks finished
  int32_t* overflow;
  bool* present;
};

// Value lane j of row i, as raw bits.
__device__ __forceinline__ uint32_t val_bits(const AggArgs& a, int j,
                                             long long i) {
  return a.val[j][i];
}

// The payload lane that carries each row's index (with vector columns or
// `placed`).
__device__ __forceinline__ long long row_lane(const AggArgs& a, int nkeys) {
  return static_cast<long long>(nkeys + a.nvals) * a.n;
}

// A row's home bucket, -1 when the row is not selected.
__device__ __forceinline__ int row_bucket(const AggArgs& a, long long i) {
  const int p = a.part[i];
  if (!a.valid[i] || p < 0 || p >= a.nparts) return -1;
  const uint32_t h = hash_row(a.keys, i, a.seed32);
  const long long slot = static_cast<long long>(p) * a.R +
                         (h & static_cast<uint32_t>(a.R - 1));
  return static_cast<int>(slot >> a.bshift);
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32);
// *total gets the block's sum. Every thread of the block must call it.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < nwarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int excl = (warp ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[nwarps - 1];
  __syncthreads();
  return excl;
}

// -- pass A -----------------------------------------------------------------

// The second payload lane of a narrow scatter: none (the count pass), the
// one scalar value lane, or the row index.
enum SecondLane : int { kLaneNone = 0, kLaneValue = 1, kLaneRow = 2 };

// The home buckets of this thread's kTileItems rows of the tile at tile0,
// a block-width apart (-1 for a row not selected). With kNarrow (one key
// lane) also the rows' key lanes and their kLane lane, kept in registers
// for the scatter. The validity flags load first; then every
// other load of the selected rows is issued before any is used, so that a
// tile costs two memory latencies and its invalid rows (the padding of a
// reduce wave's buffer) cost only their flags.
template <bool kNarrow, int kLane>
__device__ __forceinline__ void tile_buckets(const AggArgs& a,
                                             long long tile0, int* bk,
                                             uint32_t* key, uint32_t* val) {
  bool v[kTileItems];
  int p[kTileItems];
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const long long i = tile0 + k * kTileThreads + threadIdx.x;
    v[k] = i < a.n && a.valid[i];
  }
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const long long i = tile0 + k * kTileThreads + threadIdx.x;
    p[k] = v[k] ? a.part[i] : -1;
    if constexpr (kNarrow) {
      key[k] = v[k] ? key_bits(a.keys, 0, i) : 0u;
      if constexpr (kLane == kLaneValue)
        val[k] = v[k] ? val_bits(a, 0, i) : 0u;
      else if constexpr (kLane == kLaneRow)
        val[k] = static_cast<uint32_t>(i);
    }
  }
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    bk[k] = -1;
    if (p[k] >= 0 && p[k] < a.nparts) {
      uint32_t h;
      if constexpr (kNarrow)
        h = fmix32(key[k] ^ a.seed32);
      else
        h = hash_row(a.keys, tile0 + k * kTileThreads + threadIdx.x,
                     a.seed32);
      bk[k] = static_cast<int>((static_cast<long long>(p[k]) * a.R +
                                (h & static_cast<uint32_t>(a.R - 1))) >>
                               a.bshift);
    }
  }
}

// Counts the selected rows per bucket: two persistent blocks an SM walk the
// tiles, counting into shared bins (global atomics past kCountBins), and
// adds each bin to the global count once. The last block to finish scans
// the counts into the buckets' starts and the scatter's cursors.
template <bool kNarrow>
__global__ void __launch_bounds__(kTileThreads, 2)
    agg_count_kernel(AggArgs a, bool smem_bins) {
  extern __shared__ int32_t bins[];
  __shared__ int warp_sums[kTileThreads / 32];
  __shared__ bool last;
  if (smem_bins) {
    for (int b = threadIdx.x; b < a.nbuckets; b += kTileThreads) bins[b] = 0;
    __syncthreads();
  }
  int32_t* hist = smem_bins ? bins : a.counts;
  const long long ntiles = (a.n + kTileRows - 1) / kTileRows;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int bk[kTileItems];
    uint32_t key[kNarrow ? kTileItems : 1];
    tile_buckets<kNarrow, kLaneNone>(a, t * kTileRows, bk, key, nullptr);
#pragma unroll
    for (int k = 0; k < kTileItems; ++k)
      if (bk[k] >= 0) atomicAdd(&hist[bk[k]], 1);
  }
  if (smem_bins) {
    __syncthreads();
    for (int b = threadIdx.x; b < a.nbuckets; b += kTileThreads)
      if (bins[b]) atomicAdd(&a.counts[b], bins[b]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(a.done, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  int carry = 0;
  for (int base = 0; base < a.nbuckets; base += kTileThreads) {
    const int b = base + threadIdx.x;
    const int v = b < a.nbuckets ? __ldcg(a.counts + b) : 0;
    int total;
    const int excl = carry + block_exclusive_scan(v, warp_sums, &total);
    if (b < a.nbuckets) {
      a.starts[b] = excl;
      a.cursor[b] = excl;
    }
    carry += total;
  }
}

// A payload lane of row i: its key hash lane, its value's raw bits, or
// (the last lane, with `placed`) the row's index.
__device__ __forceinline__ uint32_t lane_of(const AggArgs& a, int nkeys,
                                            int l, long long i) {
  if (l < nkeys) return key_bits(a.keys, l, i);
  if (l < nkeys + a.nvals) return val_bits(a, l - nkeys, i);
  return static_cast<uint32_t>(i);
}

// The payload lanes a row carries.
__device__ __forceinline__ int pay_lanes(const AggArgs& a, int nkeys) {
  return nkeys + a.nvals + (a.row_lane ? 1 : 0);
}

// One tile of kTileRows rows per block: rank each selected row within its
// bucket in the tile, reserve each bucket's run of the payload with one
// global atomic, sort the tile by bucket in shared memory and write the
// lanes out in runs. A narrow kLane (one key lane and one more: a scalar
// value lane on the main path, or the row index of a vector column) keeps
// the rows' lanes in registers from the first load and stages both at
// once; otherwise (kLaneNone) each lane is read again when it is staged.
template <int kLane>
__global__ void __launch_bounds__(kTileThreads)
    agg_scatter_staged_kernel(AggArgs a, int nkeys) {
  constexpr bool kNarrow = kLane != kLaneNone;
  extern __shared__ int32_t smem[];
  int32_t* bins = smem;                  // tile counts, then dest - lstart
  int32_t* lstart = bins + a.nbuckets;   // the tile's bucket starts
  int32_t* sdest = lstart + a.nbuckets;  // sorted position -> payload index
  uint32_t* stage = reinterpret_cast<uint32_t*>(sdest + kTileRows);
  __shared__ int warp_sums[kTileThreads / 32];
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTileRows;
  for (int b = threadIdx.x; b < a.nbuckets; b += kTileThreads) bins[b] = 0;
  __syncthreads();

  // Per row: bucket << 16 | rank in the bucket (kTileRows <= 2^16,
  // nbuckets <= kStagedBins), or kNoRow.
  constexpr uint32_t kNoRow = 0xFFFFFFFFu;
  uint32_t rec[kTileItems];
  int bk[kTileItems];
  uint32_t key[kNarrow ? kTileItems : 1], val[kNarrow ? kTileItems : 1];
  tile_buckets<kNarrow, kLane>(a, tile0, bk, key, val);
#pragma unroll
  for (int k = 0; k < kTileItems; ++k)
    rec[k] = bk[k] < 0 ? kNoRow
                       : (static_cast<uint32_t>(bk[k]) << 16) |
                             static_cast<uint32_t>(atomicAdd(&bins[bk[k]], 1));
  __syncthreads();

  // The tile's bucket starts: each thread scans a run of bins.
  const int per = (a.nbuckets + kTileThreads - 1) / kTileThreads;
  const int b0 = threadIdx.x * per;
  const int b1 = min(b0 + per, a.nbuckets);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += bins[b];
  int total;
  int run = block_exclusive_scan(sum, warp_sums, &total);
  for (int b = b0; b < b1; ++b) {
    lstart[b] = run;
    run += bins[b];
  }
  __syncthreads();
  for (int b = threadIdx.x; b < a.nbuckets; b += kTileThreads) {
    const int c = bins[b];
    if (c) bins[b] = atomicAdd(&a.cursor[b], c) - lstart[b];
  }
  __syncthreads();
  // rec becomes the row's position in the sorted tile.
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    if (rec[k] != kNoRow) {
      const int b = static_cast<int>(rec[k] >> 16);
      const int pos = lstart[b] + static_cast<int>(rec[k] & 0xFFFFu);
      sdest[pos] = bins[b] + pos;
      rec[k] = static_cast<uint32_t>(pos);
    }
  }

  if constexpr (kNarrow) {
#pragma unroll
    for (int k = 0; k < kTileItems; ++k) {
      if (rec[k] != kNoRow) {
        stage[rec[k]] = key[k];
        stage[kTileRows + rec[k]] = val[k];
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < total; j += kTileThreads) {
      const int d = sdest[j];
      a.pay[d] = stage[j];
      a.pay[a.n + d] = stage[kTileRows + j];
    }
  } else {
    __syncthreads();
    const int lanes = pay_lanes(a, nkeys);
    for (int l = 0; l < lanes; ++l) {
      uint32_t x[kTileItems];
#pragma unroll
      for (int k = 0; k < kTileItems; ++k)
        if (rec[k] != kNoRow)
          x[k] = lane_of(a, nkeys, l, tile0 + k * kTileThreads + threadIdx.x);
#pragma unroll
      for (int k = 0; k < kTileItems; ++k)
        if (rec[k] != kNoRow) stage[rec[k]] = x[k];
      __syncthreads();
      uint32_t* out = a.pay + static_cast<long long>(l) * a.n;
      for (int j = threadIdx.x; j < total; j += kTileThreads)
        out[sdest[j]] = stage[j];
      __syncthreads();
    }
  }
}

// Too many buckets to sort a tile by in shared memory: one cursor atomic
// per row.
__global__ void agg_scatter_direct_kernel(AggArgs a, int nkeys) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int lanes = pay_lanes(a, nkeys);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < a.n; i += stride) {
    const int b = row_bucket(a, i);
    if (b < 0) continue;
    const long long dest = atomicAdd(&a.cursor[b], 1);
    for (int l = 0; l < lanes; ++l)
      a.pay[static_cast<long long>(l) * a.n + dest] = lane_of(a, nkeys, l, i);
  }
}

// -- pass B -----------------------------------------------------------------

// One row of pass B: claims or finds its key's slot in the sub-table and
// combines its scalar values there, or goes to the spill list. k and v
// hold KL >= nkeys key lanes and VL >= nvals value lanes. Returns the slot
// in the bucket, -1 for a spilled row.
template <int KL, int VL, bool kMixedStep = false>
__device__ __forceinline__ int place_row(const AggArgs& a, int nkeys,
                                          uint32_t* sub, int b, int idx,
                                          const uint32_t* k,
                                          const uint32_t* v) {
  const int B = 1 << a.bshift;
  const uint32_t bmask = static_cast<uint32_t>(B - 1);
  unsigned long long* word = reinterpret_cast<unsigned long long*>(sub);
  int* claim = reinterpret_cast<int*>(sub);
  uint32_t* skeys = sub + B;
  uint32_t* svals = sub + (1 + nkeys) * B;
  const uint32_t h = hash_lanes<KL>(k, nkeys, a.seed32);
  uint32_t off = h & bmask;
  // The step's bits from h >> 9 overlap the bits that chose the bucket,
  // which its keys share, so a bucket's keys have few distinct steps.
  // kMixedStep (the vector rows' kernel) takes them from a remix of h.
  const uint32_t step =
      ((kMixedStep ? fmix32(h ^ kStepSeed) : (h >> 9)) | 1u) & bmask;
  int placed = -1;
  if (nkeys == 1) {
    const unsigned long long mine = (1ull << 32) | k[0];
    for (int probe = 0; probe < kProbeMax; ++probe) {
      unsigned long long c =
          reinterpret_cast<volatile unsigned long long*>(word)[off];
      if (c == 0ull) c = atomicCAS(word + off, 0ull, mine);
      if (c == 0ull || c == mine) {
        placed = static_cast<int>(off);
        break;
      }
      off = (off + step) & bmask;
    }
  } else {
    for (int probe = 0; probe < kProbeMax; ++probe) {
      int c = reinterpret_cast<volatile int*>(claim)[off];
      if (c == 0) {
        c = atomicCAS(claim + off, 0, idx + 1);
        if (c == 0) {
#pragma unroll
          for (int l = 0; l < KL; ++l)
            if (l < nkeys) skeys[l * B + off] = k[l];
          placed = static_cast<int>(off);
          break;
        }
      }
      bool eq = true;
#pragma unroll
      for (int l = 0; l < KL; ++l)
        if (l < nkeys)
          eq = eq && a.pay[static_cast<long long>(l) * a.n + (c - 1)] == k[l];
      if (eq) {
        placed = static_cast<int>(off);
        break;
      }
      off = (off + step) & bmask;
    }
  }
  if (placed < 0) {
    const int j = atomicAdd(a.nspill, 1);
    a.spill[2 * j] = idx;
    a.spill[2 * j + 1] = b;
    return -1;
  }
  if (a.placed != nullptr)
    a.placed[a.pay[row_lane(a, nkeys) + idx]] = (b << a.bshift) + placed;
#pragma unroll
  for (int j = 0; j < VL; ++j)
    if (j < a.nvals) combine_at(svals + j * B + placed, a.kind[j], v[j]);
  return placed;
}

// One block per bucket. U rows a thread per step, a block-width apart,
// their lanes loaded together; the narrow instantiation (one key lane, at
// most two value lanes) keeps U = 4 rows' lanes in registers.
template <int U, int KL, int VL>
__global__ void __launch_bounds__(kAggThreads, 2)
    agg_bucket_kernel(AggArgs a, int nkeys) {
  extern __shared__ __align__(16) uint32_t sub[];
  const int B = 1 << a.bshift;
  // One key lane: a slot is one 64-bit word {1, key}, 0 when empty. More
  // key lanes: a slot's claim word is the claimer's payload index + 1, 0
  // when empty, and its key lanes follow for the write-out.
  unsigned long long* word = reinterpret_cast<unsigned long long*>(sub);
  int* claim = reinterpret_cast<int*>(sub);
  uint32_t* skeys = sub + B;
  uint32_t* svals = sub + (1 + nkeys) * B;   // value lanes of B slots
  const int b = blockIdx.x;
  for (int s = threadIdx.x; s < B; s += kAggThreads) {
    if (nkeys == 1)
      word[s] = 0ull;
    else
      claim[s] = 0;
    for (int j = 0; j < a.nvals; ++j)
      svals[j * B + s] = identity_bits(a.kind[j]);
  }
  __syncthreads();

  const int start = a.starts[b], cnt = a.counts[b];
  for (int r0 = threadIdx.x; r0 < cnt; r0 += kAggThreads * U) {
    uint32_t k[U][KL], v[U][VL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long idx = start + r0 + u * kAggThreads;
      const bool in = r0 + u * kAggThreads < cnt;
#pragma unroll
      for (int l = 0; l < KL; ++l)
        k[u][l] = in && l < nkeys
                      ? a.pay[static_cast<long long>(l) * a.n + idx] : 0u;
#pragma unroll
      for (int j = 0; j < VL; ++j)
        v[u][j] = in && j < a.nvals
                      ? a.pay[static_cast<long long>(nkeys + j) * a.n + idx]
                      : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r0 + u * kAggThreads < cnt)
        place_row<KL, VL>(a, nkeys, sub, b, start + r0 + u * kAggThreads,
                          k[u], v[u]);
  }
  __syncthreads();

  // The bucket's B slots, empty ones included.
  uint32_t last[KL];  // empty slots' keys: the last row's
#pragma unroll
  for (int l = 0; l < KL; ++l)
    last[l] = l < nkeys ? key_bits(a.keys, l, a.n - 1) : 0u;
  const long long g0 = static_cast<long long>(b) << a.bshift;
  for (int s = threadIdx.x; s < B; s += kAggThreads) {
    const bool full = nkeys == 1 ? word[s] != 0ull : claim[s] != 0;
    const long long g = g0 + s;
    a.present[g] = full;
    a.claim[g] = full ? kSlotFilled : kSlotEmpty;
#pragma unroll
    for (int l = 0; l < KL; ++l) {
      if (l < nkeys) {
        uint32_t key = last[l];
        if (full)
          key = nkeys == 1 ? static_cast<uint32_t>(word[s]) : skeys[l * B + s];
        store_key(a.out_key[l], a.keys.code[l], g, key);
      }
    }
#pragma unroll
    for (int j = 0; j < VL; ++j)
      if (j < a.nvals) a.out_val[j][g] = svals[j * B + s];
  }
}

// -- pass B with vector rows ----------------------------------------------

static constexpr unsigned kFullMask = 0xFFFFFFFFu;
// Steps of a warp's row gathers a lane keeps in flight (4 is faster at
// G = 128 but spills at 64 registers).
static constexpr int kRowsUnroll = 2;

// VEC words of a row at p: one 16-byte streaming load, or one word.
template <int VEC>
struct RowWords {
  uint32_t w[VEC];
};

template <int VEC>
__device__ __forceinline__ RowWords<VEC> load_words(const uint32_t* p) {
  RowWords<VEC> r;
  if constexpr (VEC == 4) {
    const uint4 x = __ldcs(reinterpret_cast<const uint4*>(p));
    r.w[0] = x.x;
    r.w[1] = x.y;
    r.w[2] = x.z;
    r.w[3] = x.w;
  } else {
    r.w[0] = __ldcs(p);
  }
  return r;
}

// The warp's 32 rows of one vector column into their slots' rows in the
// sub-table: lane l holds row l's slot (-1 for none) and payload row index.
// A row of G words is U = G / VEC units; lpr lanes (the least power of two
// >= U, at most 32) take a row, so 32 / lpr rows go at once, and
// kRowsUnroll such steps are loaded before any is combined. dst is the
// column's first word of slot 0's row, W words a slot. A lane combines
// its unit's VEC words starting at the (lane / 8)-th, so that the lanes
// of one row, 4 words apart, meet distinct shared-memory banks. Every
// lane of the warp must call it.
template <int VEC>
__device__ __forceinline__ void combine_warp_rows(
    const uint32_t* src, int G, int kind, uint32_t* dst, int W, int slot,
    uint32_t ridx, int lane) {
  const int U = G / VEC;
  int lpr = 1;
  while (lpr < U && lpr < 32) lpr <<= 1;
  const int rps = 32 / lpr;
  const int mine = lane / lpr, part = lane & (lpr - 1);
  const int turn = lane >> 3;
  for (int base = 0; base < 32; base += rps * kRowsUnroll) {
    int s[kRowsUnroll];
    uint32_t ri[kRowsUnroll];
#pragma unroll
    for (int q = 0; q < kRowsUnroll; ++q) {
      const int row = base + q * rps + mine;
      s[q] = __shfl_sync(kFullMask, slot, row & 31);
      ri[q] = __shfl_sync(kFullMask, ridx, row & 31);
      if (row >= 32) s[q] = -1;
    }
    for (int u = part; u < U; u += lpr) {
      RowWords<VEC> x[kRowsUnroll];
#pragma unroll
      for (int q = 0; q < kRowsUnroll; ++q)
        if (s[q] >= 0)
          x[q] = load_words<VEC>(src + static_cast<long long>(ri[q]) * G +
                                 u * VEC);
#pragma unroll
      for (int q = 0; q < kRowsUnroll; ++q)
        if (s[q] >= 0) {
          uint32_t* d = dst + s[q] * W + u * VEC;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int f = (e + turn) & (VEC - 1);
            uint32_t w = x[q].w[0];
#pragma unroll
            for (int g = 1; g < VEC; ++g)
              if (f == g) w = x[q].w[g];
            combine_at(d + f, kind, w);
          }
        }
    }
  }
}

// Every vector column's rows of the warp into the sub-table's [B, W]
// part at srows (combine_warp_rows per column, RC >= nrows columns
// unrolled, so that the descriptor is indexed by constants only).
template <int RC>
__device__ __forceinline__ void combine_rows(const AggArgs& a,
                                             uint32_t* srows, int W,
                                             int slot, uint32_t ridx,
                                             int lane) {
#pragma unroll
  for (int c = 0; c < RC; ++c) {
    if (c < a.nrows) {
      uint32_t* d = srows + a.row_off[c];
      if (a.row_vec4[c])
        combine_warp_rows<4>(a.row_val[c], a.row_g[c],
                                          a.row_kind[c], d, W, slot, ridx,
                                          lane);
      else
        combine_warp_rows<1>(a.row_val[c], a.row_g[c],
                                          a.row_kind[c], d, W, slot, ridx,
                                          lane);
    }
  }
}

// One block per bucket, as agg_bucket_kernel, with RC >= nrows vector
// columns: the sub-table's scalar lanes are followed by a row-major
// [B, W] part, W = row_words. Each warp takes 32 consecutive rows of the
// bucket a step (one a lane): a lane claims its row's slot and combines
// its scalar lanes, then the warp gathers the rows of every vector column
// by their payload row index and combines them into the slots' rows. The
// write-out adds each column's [B, G] block of its [T, G] table,
// contiguous in device memory, with 16-byte stores where it can.
template <int KL, int VL, int RC>
__global__ void __launch_bounds__(kAggThreads, 2)
    agg_bucket_rows_kernel(AggArgs a, int nkeys) {
  extern __shared__ __align__(16) uint32_t sub[];
  const int B = 1 << a.bshift;
  unsigned long long* word = reinterpret_cast<unsigned long long*>(sub);
  int* claim = reinterpret_cast<int*>(sub);
  uint32_t* skeys = sub + B;
  uint32_t* svals = sub + (1 + nkeys) * B;
  uint32_t* srows = sub + (1 + nkeys + a.nvals) * B;  // [B, W]
  const int W = a.row_words;
  const int b = blockIdx.x;
  for (int s = threadIdx.x; s < B; s += kAggThreads) {
    if (nkeys == 1)
      word[s] = 0ull;
    else
      claim[s] = 0;
    for (int j = 0; j < a.nvals; ++j)
      svals[j * B + s] = identity_bits(a.kind[j]);
  }
  if constexpr (RC == 1) {
    const uint32_t id = identity_bits(a.row_kind[0]);
    for (int f = threadIdx.x; f < B * W; f += kAggThreads) srows[f] = id;
  } else {
    for (int f = threadIdx.x; f < B * W; f += kAggThreads) {
      const int w = f % W;
      uint32_t id = 0u;
#pragma unroll
      for (int c = 0; c < RC; ++c)
        if (c < a.nrows && w >= a.row_off[c])
          id = identity_bits(a.row_kind[c]);
      srows[f] = id;
    }
  }
  __syncthreads();

  const int start = a.starts[b], cnt = a.counts[b];
  const int lane = threadIdx.x & 31;
  const long long rl = row_lane(a, nkeys);
  for (int w0 = threadIdx.x & ~31; w0 < cnt; w0 += kAggThreads) {
    const bool in = w0 + lane < cnt;
    const int idx = start + w0 + lane;
    uint32_t k[KL], v[VL];
#pragma unroll
    for (int l = 0; l < KL; ++l)
      k[l] = in && l < nkeys ? a.pay[static_cast<long long>(l) * a.n + idx]
                             : 0u;
#pragma unroll
    for (int j = 0; j < VL; ++j)
      v[j] = in && j < a.nvals
                 ? a.pay[static_cast<long long>(nkeys + j) * a.n + idx]
                 : 0u;
    const uint32_t ridx = in ? a.pay[rl + idx] : 0u;
    const int slot =
        in ? place_row<KL, VL, true>(a, nkeys, sub, b, idx, k, v) : -1;
    combine_rows<RC>(a, srows, W, slot, ridx, lane);
  }
  __syncthreads();

  uint32_t last[KL];
#pragma unroll
  for (int l = 0; l < KL; ++l)
    last[l] = l < nkeys ? key_bits(a.keys, l, a.n - 1) : 0u;
  const long long g0 = static_cast<long long>(b) << a.bshift;
  for (int s = threadIdx.x; s < B; s += kAggThreads) {
    const bool full = nkeys == 1 ? word[s] != 0ull : claim[s] != 0;
    const long long g = g0 + s;
    a.present[g] = full;
    a.claim[g] = full ? kSlotFilled : kSlotEmpty;
#pragma unroll
    for (int l = 0; l < KL; ++l) {
      if (l < nkeys) {
        uint32_t key = last[l];
        if (full)
          key = nkeys == 1 ? static_cast<uint32_t>(word[s]) : skeys[l * B + s];
        store_key(a.out_key[l], a.keys.code[l], g, key);
      }
    }
#pragma unroll
    for (int j = 0; j < VL; ++j)
      if (j < a.nvals) a.out_val[j][g] = svals[j * B + s];
  }
  // Each column's B rows: one contiguous [B, G] block of its table.
#pragma unroll
  for (int c = 0; c < RC; ++c) {
    if (c < a.nrows) {
      const int G = a.row_g[c];
      uint32_t* out = a.row_out[c] + g0 * G;
      const int words = B * G;
      if (W == G && words % 4 == 0 &&
          (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(srows) & 15) == 0) {
        const uint4* from = reinterpret_cast<const uint4*>(srows);
        uint4* to = reinterpret_cast<uint4*>(out);
        for (int f = threadIdx.x; f < words / 4; f += kAggThreads)
          to[f] = from[f];
      } else {
        const int off = a.row_off[c];
        for (int f = threadIdx.x; f < words; f += kAggThreads) {
          const int s = f / G;
          out[f] = srows[s * W + off + (f - s * G)];
        }
      }
    }
  }
}

// -- pass C -----------------------------------------------------------------

// One spilled row a thread: it places the row over its region and
// combines its scalar lanes and its vector rows' words into the slot
// with global atomics (spilled rows are the few that met 16 other keys in
// their bucket).
__global__ void agg_spill_kernel(AggArgs a, int nkeys) {
  const long long nspill = *a.nspill;
  const uint32_t bmask = (1u << a.bshift) - 1u;
  const uint32_t nbmask = static_cast<uint32_t>((a.R >> a.bshift) - 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       j < nspill; j += stride) {
    const int32_t idx = a.spill[2 * j];
    const long long bucket = a.spill[2 * j + 1];
    uint32_t k[BS_MAX_COLS];
#pragma unroll
    for (int l = 0; l < BS_MAX_COLS; ++l)
      k[l] = l < nkeys ? a.pay[static_cast<long long>(l) * a.n + idx] : 0u;
    const uint32_t h = hash_lanes<BS_MAX_COLS>(k, nkeys, a.seed32);
    const long long base = (bucket << a.bshift) & ~(a.R - 1);
    // Double hashing at two levels: probe k goes to bucket
    // home + k * bstep of the region and slot home + k * sstep in it, both
    // strides odd, so the probes after the first leave the bucket that
    // overflowed (whose every slot may be taken) for the region's others.
    const uint32_t home_bucket =
        (h & static_cast<uint32_t>(a.R - 1)) >> a.bshift;
    const uint32_t g = fmix32(h ^ kSpillSeed);
    const uint32_t bstep = (g | 1u) & nbmask;
    const uint32_t sstep = ((g >> 16) | 1u) & bmask;
    long long placed = -1;
    for (int probe = 0; probe < kSpillProbeMax; ++probe) {
      const long long slot =
          base +
          (static_cast<long long>((home_bucket + probe * bstep) & nbmask)
           << a.bshift) +
          ((h + probe * sstep) & bmask);
      int32_t c = *reinterpret_cast<volatile int32_t*>(a.claim + slot);
      if (c == kSlotEmpty) {
        c = atomicCAS(a.claim + slot, kSlotEmpty, idx);
        if (c == kSlotEmpty) {
          a.present[slot] = true;
#pragma unroll
          for (int l = 0; l < BS_MAX_COLS; ++l)
            if (l < nkeys) store_key(a.out_key[l], a.keys.code[l], slot,
                                     k[l]);
          placed = slot;
          break;
        }
      }
      bool eq = true;
#pragma unroll
      for (int l = 0; l < BS_MAX_COLS; ++l) {
        if (l < nkeys) {
          const uint32_t o =
              c == kSlotFilled
                  ? key_bits(a.out_keys, l, slot)
                  : a.pay[static_cast<long long>(l) * a.n + c];
          eq = eq && o == k[l];
        }
      }
      if (eq) {
        placed = slot;
        break;
      }
    }
    if (placed < 0) {
      atomicAdd(a.overflow, 1);
      continue;
    }
    const uint32_t ridx = a.row_lane ? a.pay[row_lane(a, nkeys) + idx] : 0u;
    if (a.placed != nullptr)
      a.placed[ridx] = static_cast<int32_t>(placed);
#pragma unroll
    for (int v = 0; v < BS_MAX_COLS; ++v)
      if (v < a.nvals)
        combine_at(a.out_val[v] + placed, a.kind[v],
                   a.pay[static_cast<long long>(nkeys + v) * a.n + idx]);
#pragma unroll
    for (int c = 0; c < BS_MAX_COLS; ++c)
      if (c < a.nrows) {
        const int G = a.row_g[c];
        const uint32_t* src = a.row_val[c] + static_cast<long long>(ridx) * G;
        uint32_t* dst = a.row_out[c] + placed * G;
        for (int w = 0; w < G; ++w) combine_at(dst + w, a.row_kind[c], src[w]);
      }
  }
}

// -- entry point ------------------------------------------------------------

// passes: bit 0 pass A (with the reset of meta), bit 1 pass B, bit 2
// pass C; the main path runs all three (7), a timing may run one at a time
// after the earlier ones. meta holds counts, starts and cursors (nbuckets
// words each), then the spill count, the count pass's finished blocks and
// the overflow count. val_ptrs and out_val_ptrs name nvals scalar value
// lanes (0..BS_MAX_COLS); row_ptrs and out_row_ptrs name nrows row-major
// [n, G] vector columns and their [T, G] tables (0..BS_MAX_COLS), G in
// row_gs. placed, when not null, gets each placed row's slot (the caller
// fills it with -1). With vector columns or placed, pay holds one more
// lane of n words, the row indices.
extern "C" int bs_hash_aggregate(
    const void* const* key_ptrs, const int* key_codes, int nkeys,
    const void* const* val_ptrs, const int* kinds, int nvals,
    const void* const* row_ptrs, const int* row_kinds, const int* row_gs,
    int nrows, const bool* valid, const int32_t* part, long long n,
    int nparts, long long R, unsigned int slot_seed32, int bucket_log2,
    int nbuckets, void* pay, int32_t* spill, int32_t* claim, int32_t* meta,
    bool* present, void* const* out_key_ptrs, void* const* out_val_ptrs,
    void* const* out_row_ptrs, int32_t* placed, int passes,
    cudaStream_t stream) {
  static bool smem_attr_set = false;
  if (!smem_attr_set) {
    const void* big[] = {
        reinterpret_cast<const void*>(agg_bucket_kernel<4, 1, 2>),
        reinterpret_cast<const void*>(
            agg_bucket_kernel<1, BS_MAX_COLS, BS_MAX_COLS>),
        reinterpret_cast<const void*>(agg_bucket_rows_kernel<1, 2, 1>),
        reinterpret_cast<const void*>(
            agg_bucket_rows_kernel<BS_MAX_COLS, BS_MAX_COLS, BS_MAX_COLS>),
    };
    const void* staged[] = {
        reinterpret_cast<const void*>(agg_scatter_staged_kernel<kLaneNone>),
        reinterpret_cast<const void*>(agg_scatter_staged_kernel<kLaneValue>),
        reinterpret_cast<const void*>(agg_scatter_staged_kernel<kLaneRow>),
    };
    cudaError_t e = cudaSuccess;
    for (const void* fn : big)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    for (const void* fn : staged)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kStagedSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_attr_set = true;
  }
  int row_words = 0;
  for (int c = 0; c < nrows && c < BS_MAX_COLS; ++c) {
    if (row_gs[c] < 2) return static_cast<int>(cudaErrorInvalidValue);
    row_words += row_gs[c];
  }
  const size_t sub_bytes = (static_cast<size_t>(1) << bucket_log2) *
                           (1 + nkeys + nvals + row_words) * 4;
  if (sub_bytes > static_cast<size_t>(kSmemMax) || nkeys < 1 ||
      nkeys > BS_MAX_COLS || nvals < 0 || nvals > BS_MAX_COLS ||
      nrows < 0 || nrows > BS_MAX_COLS)
    return static_cast<int>(cudaErrorInvalidValue);

  AggArgs a;
  a.keys = make_colset(key_ptrs, key_codes, nkeys);
  a.out_keys = make_colset(out_key_ptrs, key_codes, nkeys);
  int off = 0;
  for (int j = 0; j < BS_MAX_COLS; ++j) {
    a.val[j] = j < nvals ? static_cast<const uint32_t*>(val_ptrs[j]) : nullptr;
    a.out_val[j] = j < nvals ? static_cast<uint32_t*>(out_val_ptrs[j])
                             : nullptr;
    a.kind[j] = j < nvals ? kinds[j] : 0;
    a.out_key[j] = j < nkeys ? out_key_ptrs[j] : nullptr;
    const bool r = j < nrows;
    a.row_val[j] = r ? static_cast<const uint32_t*>(row_ptrs[j]) : nullptr;
    a.row_out[j] = r ? static_cast<uint32_t*>(out_row_ptrs[j]) : nullptr;
    a.row_kind[j] = r ? row_kinds[j] : 0;
    a.row_g[j] = r ? row_gs[j] : 0;
    a.row_off[j] = off;
    a.row_vec4[j] = r && row_gs[j] % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(row_ptrs[j]) & 15) == 0;
    if (r) off += row_gs[j];
  }
  a.nvals = nvals;
  a.nrows = nrows;
  a.row_words = row_words;
  a.row_lane = nrows > 0 || placed != nullptr;
  a.placed = placed;
  a.valid = valid;
  a.part = part;
  a.n = n;
  a.nparts = nparts;
  a.R = R;
  a.bshift = bucket_log2;
  a.nbuckets = nbuckets;
  a.seed32 = slot_seed32;
  a.pay = static_cast<uint32_t*>(pay);
  a.spill = spill;
  a.claim = claim;
  a.counts = meta;
  a.starts = meta + nbuckets;
  a.cursor = meta + 2LL * nbuckets;
  a.nspill = meta + 3LL * nbuckets;
  a.done = meta + 3LL * nbuckets + 1;
  a.overflow = meta + 3LL * nbuckets + 2;
  a.present = present;

  if (passes & 1) {
    cudaError_t e = cudaMemsetAsync(
        meta, 0, (3 * static_cast<size_t>(nbuckets) + 3) * sizeof(int32_t),
        stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    // Few blocks, each over many tiles: every block adds each of its bins
    // to the bucket's global count once, and those atomics serialise per
    // bucket.
    const bool smem_bins = nbuckets <= kCountBins;
    const long long tiles = (n + kTileRows - 1) / kTileRows;
    const unsigned count_grid =
        static_cast<unsigned>(tiles < kCountBlocks ? tiles : kCountBlocks);
    const size_t count_smem = smem_bins ? nbuckets * sizeof(int32_t) : 0;
    if (nkeys == 1)
      agg_count_kernel<true><<<count_grid, kTileThreads, count_smem,
                               stream>>>(a, smem_bins);
    else
      agg_count_kernel<false><<<count_grid, kTileThreads, count_smem,
                                stream>>>(a, smem_bins);
    if (nbuckets <= kStagedBins) {
      // One key lane and one more payload lane: a scalar value (the main
      // path) or the row index.
      const int lanes = nkeys + nvals + (a.row_lane ? 1 : 0);
      const int second = nkeys != 1 || lanes != 2
                             ? kLaneNone
                             : (nvals == 1 ? kLaneValue : kLaneRow);
      const size_t smem =
          (2 * static_cast<size_t>(nbuckets) +
           (second != kLaneNone ? 3 : 2) * static_cast<size_t>(kTileRows)) *
          sizeof(int32_t);
      const unsigned grid = static_cast<unsigned>(tiles);
      if (second == kLaneValue)
        agg_scatter_staged_kernel<kLaneValue>
            <<<grid, kTileThreads, smem, stream>>>(a, nkeys);
      else if (second == kLaneRow)
        agg_scatter_staged_kernel<kLaneRow>
            <<<grid, kTileThreads, smem, stream>>>(a, nkeys);
      else
        agg_scatter_staged_kernel<kLaneNone>
            <<<grid, kTileThreads, smem, stream>>>(a, nkeys);
    } else {
      agg_scatter_direct_kernel<<<grid_for(n, 256), 256, 0, stream>>>(a,
                                                                     nkeys);
    }
    const cudaError_t le = cudaGetLastError();
    if (le != cudaSuccess) return static_cast<int>(le);
  }
  if (passes & 2) {
    const unsigned grid = static_cast<unsigned>(nbuckets);
    if (nrows == 0 && nkeys == 1 && nvals <= 2)
      agg_bucket_kernel<4, 1, 2><<<grid, kAggThreads, sub_bytes, stream>>>(
          a, nkeys);
    else if (nrows == 0)
      agg_bucket_kernel<1, BS_MAX_COLS, BS_MAX_COLS>
          <<<grid, kAggThreads, sub_bytes, stream>>>(a, nkeys);
    else if (nrows == 1 && nkeys == 1 && nvals <= 2)
      agg_bucket_rows_kernel<1, 2, 1>
          <<<grid, kAggThreads, sub_bytes, stream>>>(a, nkeys);
    else
      agg_bucket_rows_kernel<BS_MAX_COLS, BS_MAX_COLS, BS_MAX_COLS>
          <<<grid, kAggThreads, sub_bytes, stream>>>(a, nkeys);
    const cudaError_t le = cudaGetLastError();
    if (le != cudaSuccess) return static_cast<int>(le);
  }
  if (passes & 4)
    agg_spill_kernel<<<kSpillBlocks, 256, 0, stream>>>(a, nkeys);
  return static_cast<int>(cudaGetLastError());
}

// Loads every instantiation bs_hash_aggregate launches into the current
// context (see bs_load_kernels in probe.cu).
extern "C" int bs_load_hash_aggregate() {
  cudaFuncAttributes attr;
  const void* fns[] = {
      reinterpret_cast<const void*>(agg_count_kernel<true>),
      reinterpret_cast<const void*>(agg_count_kernel<false>),
      reinterpret_cast<const void*>(agg_scatter_staged_kernel<kLaneNone>),
      reinterpret_cast<const void*>(agg_scatter_staged_kernel<kLaneValue>),
      reinterpret_cast<const void*>(agg_scatter_staged_kernel<kLaneRow>),
      reinterpret_cast<const void*>(agg_scatter_direct_kernel),
      reinterpret_cast<const void*>(agg_bucket_kernel<4, 1, 2>),
      reinterpret_cast<const void*>(
          agg_bucket_kernel<1, BS_MAX_COLS, BS_MAX_COLS>),
      reinterpret_cast<const void*>(agg_bucket_rows_kernel<1, 2, 1>),
      reinterpret_cast<const void*>(
          agg_bucket_rows_kernel<BS_MAX_COLS, BS_MAX_COLS, BS_MAX_COLS>),
      reinterpret_cast<const void*>(agg_spill_kernel),
  };
  for (const void* fn : fns) {
    const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
