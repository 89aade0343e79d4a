// Shared device helpers of the kernels in this directory: the routing
// hash (bit-equal to bigslice_tpu_torch/frame/ops.py) and the column
// descriptors passed to kernels by value.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define BS_MAX_COLS 8

// Key column codes (parallel/cuda_kernels.py _KEY_CODES).
enum KeyCode : int {
  KEY_B32 = 0,  // int32 / uint32: the 32 bits as they are
  KEY_F32 = 1,  // float32: -0.0 folded onto +0.0, then the bits
  KEY_I16 = 2,  // sign-extended
  KEY_U16 = 3,  // zero-extended
  KEY_I8 = 4,   // sign-extended
  KEY_U8 = 5,   // zero-extended (uint8 and bool)
  KEY_F16 = 6,  // half: -0.0 folded onto +0.0, then the 16 bits
};

struct ColSet {
  const void* ptr[BS_MAX_COLS];
  int code[BS_MAX_COLS];
  int n;
};

static inline ColSet make_colset(const void* const* ptrs, const int* codes,
                                 int n) {
  ColSet c;
  for (int i = 0; i < BS_MAX_COLS; ++i) {
    c.ptr[i] = i < n ? ptrs[i] : nullptr;
    c.code[i] = i < n ? codes[i] : 0;
  }
  c.n = n;
  return c;
}

static constexpr uint32_t kGolden32 = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t combine_hashes(uint32_t a, uint32_t b) {
  return fmix32(a ^ (b + kGolden32 + (a << 6) + (a >> 2)));
}

// A key column's 32-bit hash lane at row i (frame/ops.py _bits32).
__device__ __forceinline__ uint32_t key_bits(const ColSet& c, int j,
                                             long long i) {
  switch (c.code[j]) {
    case KEY_B32:
      return static_cast<const uint32_t*>(c.ptr[j])[i];
    case KEY_F32: {
      float f = static_cast<const float*>(c.ptr[j])[i];
      if (f == 0.0f) f = 0.0f;
      return __float_as_uint(f);
    }
    case KEY_I16:
      return static_cast<uint32_t>(
          static_cast<int32_t>(static_cast<const int16_t*>(c.ptr[j])[i]));
    case KEY_U16:
      return static_cast<const uint16_t*>(c.ptr[j])[i];
    case KEY_I8:
      return static_cast<uint32_t>(
          static_cast<int32_t>(static_cast<const int8_t*>(c.ptr[j])[i]));
    case KEY_U8:
      return static_cast<const uint8_t*>(c.ptr[j])[i];
    default: {  // KEY_F16
      uint32_t b = static_cast<const uint16_t*>(c.ptr[j])[i];
      return (b & 0x7FFFu) == 0 ? 0u : b;
    }
  }
}

// The combine_hashes chain of fmix32(bits(key) ^ seed32) over the key
// columns in order (Frame.hash_keys). The loop is unrolled over the most
// columns so that every column index is a constant: indexing the
// descriptor with a variable would copy it into each thread's local
// memory.
__device__ __forceinline__ uint32_t hash_row(const ColSet& keys,
                                             long long i, uint32_t seed32) {
  uint32_t h = fmix32(key_bits(keys, 0, i) ^ seed32);
#pragma unroll
  for (int j = 1; j < BS_MAX_COLS; ++j)
    if (j < keys.n)
      h = combine_hashes(h, fmix32(key_bits(keys, j, i) ^ seed32));
  return h;
}

static inline int grid_for(long long n, int block) {
  long long blocks = (n + block - 1) / block;
  // Grid-stride loops: enough blocks to fill 132 SMs many times over.
  const long long cap = 132LL * 32;
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}
