// K3, the build probe. Replaces the capability probe of the JAX
// package's Pallas tier, bigslice_tpu/parallel/pallas_kernels.py
// interpret_capable (:45-68): a trivial +1 over an (8, 128) int32 block,
// run once per process (cuda_kernels.kernels_available) to show that the
// library built for this card loads and launches. Bound: 4 KiB of
// traffic, so pure launch latency; nothing to design around.
#include "common.cuh"

__global__ void probe_add1_kernel(int32_t* x, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) x[i] += 1;
}

extern "C" int bs_probe_add1(int32_t* x, long long n, cudaStream_t stream) {
  const int block = 256;
  probe_add1_kernel<<<(unsigned)((n + block - 1) / block), block, 0,
                      stream>>>(x, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bs_load_hash_partition();
extern "C" int bs_load_hash_aggregate();

// Loads every kernel of the library into the current context, once, when
// the library is built (cuda_kernels.build). Under CUDA's lazy module
// loading (the default) a kernel is otherwise loaded at its first launch,
// and that launch waits for the device: a stall in a process's first run,
// or a server's first request, and a host sync behind any work queued on
// another stream. cudaFuncGetAttributes loads the kernel it names.
extern "C" int bs_load_kernels() {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, probe_add1_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  int rc = bs_load_hash_partition();
  if (rc == 0) rc = bs_load_hash_aggregate();
  return rc;
}
