// Persistent launches of K1/K2 (intersect_dense.cu, 32-lane units of work)
// and B1/B2 (bvh_traverse.cu, rays): the grid and the work counters.
//
// A launch's grid is the blocks the device holds at once
// (resident_blocks), and its warps take work from a counter in device
// memory with atomicAdd; the launch's last warp to finish resets the
// counters for the next launch.  Launches on one stream run in order, so
// each stream of each device has its own counters and launches on
// concurrent streams never share one.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace work_counters {

// The blocks of `kernel` (`threads` a block, `smem` bytes of dynamic
// shared memory) that the current device holds at once: its SMs times the
// occupancy's blocks an SM, asked of the runtime once per (device, kernel,
// smem), so that a launch makes no such call again.  Where `smem_opt_in`
// > 0 the kernel is first allowed that much dynamic shared memory.  0 on
// error (*err set).
template <class K>
int resident_blocks(K kernel, int threads, size_t smem, int smem_opt_in, int* err) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, size_t>, int> known;
  int dev = 0;
  *err = (int)cudaGetDevice(&dev);
  if (*err != 0) return 0;
  const std::tuple<int, const void*, size_t> key(dev, (const void*)kernel, smem);
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(key);
  if (it != known.end()) return it->second;
  if (smem_opt_in > 0) {
    *err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     smem_opt_in);
    if (*err != 0) return 0;
  }
  int per_sm = 0, n_sm = 0;
  *err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (*err != 0) return 0;
  *err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (*err != 0) return 0;
  if (per_sm < 1 || n_sm < 1) {
    *err = (int)cudaErrorInvalidConfiguration;
    return 0;
  }
  known.emplace(key, per_sm * n_sm);
  return per_sm * n_sm;
}

// The counters of kernel `which` (0 or 1) for launches on `stream` of the
// current device: {next unit, warps finished}, allocated and zeroed on the
// stream's first launch and left zero by every launch; nullptr on error
// (*err set).
inline unsigned* stream_counters(void* stream, int which, int* err) {
  static std::mutex mu;
  static std::map<std::pair<int, uintptr_t>, unsigned*> by_stream;
  int dev = 0;
  *err = (int)cudaGetDevice(&dev);
  if (*err != 0) return nullptr;
  const std::pair<int, uintptr_t> key(dev, (uintptr_t)stream);
  std::lock_guard<std::mutex> lock(mu);
  auto it = by_stream.find(key);
  if (it == by_stream.end()) {
    unsigned* p = nullptr;
    const size_t bytes = 4 * sizeof(unsigned);
    *err = (int)cudaMalloc((void**)&p, bytes);
    if (*err == 0) {
      *err = (int)cudaMemsetAsync(p, 0, bytes, (cudaStream_t)stream);
    }
    if (*err != 0) {
      if (p != nullptr) cudaFree(p);
      return nullptr;
    }
    it = by_stream.emplace(key, p).first;
  }
  return it->second + 2 * which;
}

// After a warp's last take: the launch's last warp to get here (of
// gridDim.x x warps_per_block) resets the counters.
__device__ __forceinline__ void finish(unsigned* counters, unsigned warps_per_block) {
  if ((threadIdx.x & 31) == 0) {
    __threadfence();
    if (atomicAdd(counters + 1, 1u) == gridDim.x * warps_per_block - 1) {
      atomicExch(counters, 0u);
      atomicExch(counters + 1, 0u);
    }
  }
}

}  // namespace work_counters
