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
// Design.  One block of 128 threads: a producer thread and two consumer
// warps, over a ring of kSlots slots of M x W floats (dynamic shared
// memory, two mbarriers a slot past them).  The producer (lane 0 of warp
// 3) copies each visit's whole 24 KiB block with one cp.async.bulk into
// its slot, completing on the slot's "full" barrier (expect_tx of 24,576
// bytes): Hopper's form of make_async_copy(...).start() and the DMA
// semaphore.  The TPU kernel keeps two slots, one copy ahead; here a
// block's copy (device-memory latency, about a microsecond) can outlast a
// visit's 128 adds, so the producer runs up to kSlots visits ahead,
// waiting on a slot's "empty" barrier before it refills it.  Warps 0 and 1
// (columns 0..47) wait on visit j's full barrier with
// mbarrier.try_wait.parity (the k-th fill of a slot completes phase k),
// sum, and each arrives once on the slot's empty barrier: no block-wide
// barrier in the loop, and no copy is issued from a warp that sums.
// trip is read from device memory by every thread: no host sync.
//
// Order of the sums.  Thread c < W owns column c: for each visit it sums
// rows 0..M-1 in order into s (starting from 0), then adds s to its
// running total, visits in order.  The plain torch version
// (tools/dma_min.py) adds in the same order, so the output is bitwise
// equal to it; the TPU kernel's jnp.sum reduces in another order.  The
// row loop is unrolled, each row's shared load issued kAhead adds before
// the add that takes it, so each step of the chain waits for an add, not
// for a load.
//
// What bounds it on an H100.  Bytes: each distinct block is 24 KiB, K = 16
// blocks are 393 KB, ~0.12 us at 3.35 TB/s, far below one launch.  The
// fixed order is one chain of trip x M dependent adds a column (2,048 at
// trip 16, ~4 cycles each), so the kernel is latency-bound; it is a repro,
// kept for the record, not a kernel of the renderer.
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
constexpr uint32_t kBlockBytes = kBlockFloats * 4;          // 24,576
constexpr int kSlots = 8;         // copies in flight: 192 KiB of slots
constexpr int kAhead = 16;        // rows loaded ahead of the add chain
constexpr int kConsumers = 2;     // warps that sum (columns 0..63)
constexpr int kProducer = 96;     // the thread that copies (warp 3)
constexpr int kSmemBytes = kSlots * (kBlockBytes + 16);     // slots, barriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The producer: expect the block's bytes on `bar`, then copy it into `dst`.
__device__ __forceinline__ void fetch(float* dst, const float* src,
                                      uint64_t* bar) {
  // The slot's earlier contents were read by the generic proxy (ordered by
  // its empty barrier); the copy writes through the async proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(kBlockBytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(kBlockBytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
    dma_min_kernel(const int32_t* __restrict__ meta,
                   const float* __restrict__ big, int n_blocks,
                   float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto slot = [&](int s) {
    return reinterpret_cast<float*>(smem + s * kBlockBytes);
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSlots * kBlockBytes);
  uint64_t* empty = full + kSlots;
  const int trip = meta[0];
  const int c = threadIdx.x;
  if (c == 0) {
    for (int s = 0; s < kSlots; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(full + s))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_addr(empty + s)),
                   "r"(kConsumers)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (c == kProducer) {
    for (int j = 0; j < trip; ++j) {
      const int s = j % kSlots;
      // Visit j - kSlots, the slot's last, must have been summed.
      if (j >= kSlots) wait_parity(&empty[s], (j / kSlots - 1) & 1);
      fetch(slot(s), big + (size_t)min(j, n_blocks - 1) * kBlockFloats,
            &full[s]);
    }
  } else if (c < 32 * kConsumers) {
    float acc = 0.0f;
    for (int j = 0; j < trip; ++j) {
      const int s = j % kSlots;
      wait_parity(&full[s], (j / kSlots) & 1);
      if (c < kW) {
        const float* blk = slot(s);
        float v[kM];
#pragma unroll
        for (int r = 0; r < kAhead; ++r) v[r] = blk[r * kW + c];
        float sum = 0.0f;
#pragma unroll
        for (int r = 0; r < kM; ++r) {
          if (r + kAhead < kM) v[r + kAhead] = blk[(r + kAhead) * kW + c];
          sum += v[r];
        }
        acc += sum;
      }
      __syncwarp();
      if ((c & 31) == 0) arrive(&empty[s]);
    }
    if (c < kW) out[c] = acc;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes.  The launch runs on `stream`,
// allocates nothing, does not synchronise, and returns the first CUDA error
// (the shared-memory opt-in, then cudaGetLastError()).  big is
// (n_blocks * 128, 48) f32, 16-byte aligned (the wrapper checks it); meta is
// (1, 2) int32 on the device.
extern "C" {

int dma_min_launch(const void* meta, const void* big, int n_blocks, void* out,
                   void* stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      dma_min_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (opt_in != cudaSuccess) return (int)opt_in;
  dma_min_kernel<<<1, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const int32_t*)meta, (const float*)big, n_blocks, (float*)out);
  return (int)cudaGetLastError();
}

const char* dma_min_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
