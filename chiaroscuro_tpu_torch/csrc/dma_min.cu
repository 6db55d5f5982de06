// X2, the double-buffered block fetch, for Hopper (sm_90a).
//
// Replaces tools/_tpu_dma_min.py::kern, the JAX package's minimal repro of
// a double-buffered DMA from device memory with a trip count and block ids
// known only on the device (the pattern of the streaming cluster visits).
// It computes
//
//   out[0, c] = sum over j < trip of sum over r < M of big[cid(j) * M + r, c]
//
// with trip = meta[0, 0] and cid(j) = min(j, K - 1), K = rows(big) / M:
// trip = 0 writes zeros, and trip > K adds the last block again for every
// visit past K, as the clamp at :13 does.  M = 128 rows and W = 48 columns,
// the repro's shape.
//
// Design.  One block of 128 threads.  Two slots of M x W floats in static
// shared memory (2 x 128 x 48 x 4 B = 48 KiB, exactly the static limit):
// visit j + 1's block is copied with cp.async (16 bytes a copy, 12 copies
// a thread) into the other slot while visit j's is summed, the counterpart
// of make_async_copy(...).start() on the TPU.  cp.async.wait_group 1 and a
// barrier stand for the DMA semaphore's wait; a second barrier frees the
// slot before the copy after next overwrites it.  trip is read from device
// memory by every thread: no host sync.
//
// Order of the sums.  Thread c < W owns column c: for each visit it sums
// rows 0..M-1 in order into s (starting from 0), then adds s to its
// running total, visits in order.  The plain torch version
// (tools/dma_min.py) adds in the same order, so the output is bitwise
// equal to it; the TPU kernel's jnp.sum reduces in another order.
//
// What bounds it on an H100.  Bytes: each distinct block is 24 KiB, K = 16
// blocks are 393 KB, ~0.12 us at 3.35 TB/s, far below one launch; one
// block on one SM with a serial chain of M adds a visit is latency-bound.
// It is a repro, kept for the record, not a kernel of the renderer.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kM = 128;           // rows of one block
constexpr int kW = 48;            // columns
constexpr int kThreads = 128;
constexpr int kBlockFloats = kM * kW;
constexpr int kCopies = kBlockFloats / 4;   // 16-byte copies per block

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Cooperative asynchronous copy of block `cid` (M x W floats) into `dst`.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ big,
                                      int cid) {
  const float* src = big + (size_t)cid * kBlockFloats;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(dst);
  for (int k = threadIdx.x; k < kCopies; k += kThreads) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + 16u * (uint32_t)k),
                 "l"(src + 4 * k)
                 : "memory");
  }
}

__global__ void __launch_bounds__(kThreads)
    dma_min_kernel(const int32_t* __restrict__ meta,
                   const float* __restrict__ big, int n_blocks,
                   float* __restrict__ out) {
  __shared__ __align__(16) float buf[2][kBlockFloats];
  const int trip = meta[0];
  const int c = threadIdx.x;
  float acc = 0.0f;
  if (trip > 0) stage(buf[0], big, 0);
  cp_async_commit();
  for (int j = 0; j < trip; ++j) {
    // Prefetch visit j + 1 (an empty group past the end keeps the wait
    // count uniform), then wait for visit j's copy.
    if (j + 1 < trip) stage(buf[(j + 1) & 1], big, min(j + 1, n_blocks - 1));
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (c < kW) {
      const float* blk = buf[j & 1];
      float s = 0.0f;
      for (int r = 0; r < kM; ++r) s += blk[r * kW + c];
      acc += s;
    }
    __syncthreads();
  }
  if (c < kW) out[c] = acc;
}

}  // namespace

// Plain C entry points, bound with ctypes.  The launch runs on `stream`,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
// big is (n_blocks * 128, 48) f32, 16-byte aligned (the wrapper checks it);
// meta is (1, 2) int32 on the device.
extern "C" {

int dma_min_launch(const void* meta, const void* big, int n_blocks, void* out,
                   void* stream) {
  dma_min_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)meta, (const float*)big, n_blocks, (float*)out);
  return (int)cudaGetLastError();
}

const char* dma_min_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
