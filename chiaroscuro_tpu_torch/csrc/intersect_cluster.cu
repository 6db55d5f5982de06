// Streaming cluster visits for Hopper (sm_90a).
//
// K6 closest_cluster replaces
// chiaroscuro_tpu/ops/cluster_pallas.py::_stream_closest_kernel and K7
// any_cluster replaces ::_stream_any_kernel.  Both consume the per-row
// lists the cull K3 writes (ops/cull_triton.py): meta (B0, 2) [trip,
// overflow], ids (B0, Le) near-ascending cluster ids, nears (B0, Le) entry
// lower bounds, cutoff (B0,) the entry of the first box left off the list
// (+inf unless the row overflowed).
//
// What they compute, as the TPU kernels do.  Phase 1 visits the listed
// clusters near to far and stops once no lane can improve: closest while
// some lane's best t >= the next box's near, any while some unoccluded lane
// has tmax >= it.  Phase 2 sweeps all K clusters in identity order while
// some lane's pending work reaches the cutoff (overflow rows only).  The
// closest hit is the lexicographic (t, original id) minimum, so the result
// does not depend on visit order and equals the brute oracle's lowest-id
// tie-break; the winner's 32 attributes are fetched once, at the end, by
// its original id from the original-order (T, 32) table (the TPU's one-hot
// MXU fetch and attribute rows 16-47 of its packed block are not carried
// over).  Ids are int32 throughout; a miss writes t = BIG, id = 0,
// u = v = 0 and zero attributes.  The JAX package's 2^24 triangle limit is
// kept by the wrapper (ops/cluster_cuda.py).
//
// Layout.  One block of 128 threads owns one 128-lane ray row, one thread
// per ray; the running best lives in registers.  The cluster matrix is
// (K, 10, M) f32 in global memory, field-major per cluster: rows 0-8 are
// v0|e1|e2, row 9 the original triangle id as int32 bits; padded slots are
// all-zero triangles (determinant 0, never hit).  Each visited cluster's
// 10 x M block (5 KB at M = 128) is staged into shared memory with cp.async
// into a two-slot buffer, the next listed cluster's copy in flight while the
// current one is tested: the counterpart of the TPU kernels' DMA double
// buffer (cluster_pallas.py:642-697).  Every thread then reads the same
// triangle at once (a shared-memory broadcast).  The early-exit test runs
// after every visit as a block-wide vote (__syncthreads_or), which is also
// the barrier that frees the slot the next copy overwrites.
//
// What bounds it on an H100.  A visit is 128 x M Moller-Trumbore tests of
// ~40 FP32 operations on 5 KB staged from device memory or L2: ~8 FLOP per
// byte at M = 128, above the card's ~20 FLOP/byte balance point only when
// the blocks come from L2 (the 88 MB atrium matrix does not fit the 50 MB
// L2).  The serial part is the per-visit barrier and vote: with one block
// per row and a few blocks per SM, latency of the copy and the vote, not
// arithmetic, is expected to dominate until visits are batched (later
// work; this is the simple design that is right).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC.  With -fmad=false and mt_core.cuh's
// operand order the kernels equal their plain torch versions
// (ops/cluster_cuda.py) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt_core.cuh"

namespace {

using mt::kBig;
using mt::kLanes;
using mt::load_ray;
using mt::Ray;

constexpr int kGeoRows = 10;    // v0 | e1 | e2 | original id
constexpr int kIdRow = 9;
constexpr int kNoId = 0x7fffffff;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Cooperative asynchronous copy of cluster `cid`'s 10 x M block into `dst`,
// 16 bytes per cp.async (the wrapper checks alignment and M % 4 == 0).
__device__ __forceinline__ void stage_block(float* dst,
                                            const float* __restrict__ packed,
                                            int cid, int block_floats) {
  const float* src = packed + (size_t)cid * block_floats;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(dst);
  for (int k = threadIdx.x; k < block_floats / 4; k += kLanes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + 16u * (uint32_t)k),
                 "l"(src + 4 * k)
                 : "memory");
  }
}

// Visit clusters cid_of(0), cid_of(1), ... cid_of(n - 1) in order through
// the two-slot shared buffer, for as long as some thread's keep(j) holds
// before visit j.  keep and the list are uniform across the block's calls;
// every thread calls this the same number of times.
template <class CidOf, class Keep, class Visit>
__device__ __forceinline__ void stream_visits(float* buf,
                                              const float* __restrict__ packed,
                                              int block_floats, int n,
                                              CidOf cid_of, Keep keep,
                                              Visit visit) {
  if (n <= 0 || !__syncthreads_or(keep(0))) return;
  stage_block(buf, packed, cid_of(0), block_floats);
  cp_async_commit();
  for (int j = 0;;) {
    // Prefetch visit j + 1 into the other slot (an empty group past the
    // end keeps the wait count uniform), then wait for visit j's copy.
    if (j + 1 < n) {
      stage_block(buf + ((j + 1) & 1) * block_floats, packed, cid_of(j + 1),
                  block_floats);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    visit(buf + (j & 1) * block_floats);
    ++j;
    // The vote is also the barrier before the next prefetch overwrites the
    // slot just visited.
    if (j >= n || !__syncthreads_or(keep(j))) break;
  }
  // Drain a prefetch that an early exit left in flight before the slots are
  // reused.
  cp_async_wait_all();
  __syncthreads();
}

__global__ void __launch_bounds__(kLanes)
closest_cluster_kernel(const int32_t* __restrict__ meta,
                       const int32_t* __restrict__ ids,
                       const float* __restrict__ nears,
                       const float* __restrict__ cutoff,
                       const float* __restrict__ o3,
                       const float* __restrict__ d3,
                       const float* __restrict__ packed,
                       const float* __restrict__ attrs, int n_rows, int le,
                       int n_clusters, int m, float* __restrict__ t_out,
                       int32_t* __restrict__ id_out, float* __restrict__ u_out,
                       float* __restrict__ v_out,
                       float* __restrict__ attr_out) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  const int row = blockIdx.x;
  const size_t plane = (size_t)n_rows * kLanes;
  const size_t i = (size_t)row * kLanes + threadIdx.x;
  const int block_floats = kGeoRows * m;
  const Ray r = load_ray(o3, d3, plane, i);
  const int trip = meta[2 * row];
  const int32_t* row_ids = ids + (size_t)row * le;
  const float* row_nears = nears + (size_t)row * le;
  const float cut = cutoff[row];

  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = kNoId;
  auto visit = [&](const float* blk) {
    for (int s = 0; s < m; ++s) {
      float t, u, v;
      if (mt::mt_hit(r, blk + s, m, t, u, v) && t < kBig) {
        const int id = __float_as_int(blk[kIdRow * m + s]);
        if (t < best_t || (t == best_t && id < best_id)) {
          best_t = t;
          best_u = u;
          best_v = v;
          best_id = id;
        }
      }
    }
  };
  // Phase 1: the listed clusters, near to far.
  stream_visits(
      buf, packed, block_floats, trip, [&](int j) { return row_ids[j]; },
      [&](int j) { return best_t >= row_nears[j]; }, visit);
  // Phase 2: every cluster, while some lane could still be beaten past the
  // cutoff (never for rows that did not overflow: cutoff = +inf).
  stream_visits(
      buf, packed, block_floats, n_clusters, [](int j) { return j; },
      [&](int) { return best_t >= cut; }, visit);

  const bool hit = best_t < kBig;
  const int id = hit ? best_id : 0;
  t_out[i] = best_t;
  id_out[i] = id;
  u_out[i] = best_u;
  v_out[i] = best_v;
  mt::store_attrs(attrs, hit, id, plane, i, attr_out);
}

__global__ void __launch_bounds__(kLanes)
any_cluster_kernel(const int32_t* __restrict__ meta,
                   const int32_t* __restrict__ ids,
                   const float* __restrict__ nears,
                   const float* __restrict__ cutoff,
                   const float* __restrict__ o3, const float* __restrict__ d3,
                   const float* __restrict__ tmax,
                   const int32_t* __restrict__ excl,
                   const float* __restrict__ packed, int n_rows, int le,
                   int n_clusters, int m, uint8_t* __restrict__ occ_out) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  const int row = blockIdx.x;
  const size_t plane = (size_t)n_rows * kLanes;
  const size_t i = (size_t)row * kLanes + threadIdx.x;
  const int block_floats = kGeoRows * m;
  const Ray r = load_ray(o3, d3, plane, i);
  const float tm = tmax[i];
  const int ex = excl[i];
  const int trip = meta[2 * row];
  const int32_t* row_ids = ids + (size_t)row * le;
  const float* row_nears = nears + (size_t)row * le;
  const float cut = cutoff[row];

  bool occ = false;
  auto visit = [&](const float* blk) {
    for (int s = 0; s < m && !occ; ++s) {
      float t, u, v;
      occ = mt::mt_hit(r, blk + s, m, t, u, v) && t < tm &&
            __float_as_int(blk[kIdRow * m + s]) != ex;
    }
  };
  // Some lane still open whose shadow segment reaches the next box (phase
  // 1) or the cutoff (phase 2).
  stream_visits(
      buf, packed, block_floats, trip, [&](int j) { return row_ids[j]; },
      [&](int j) { return !occ && tm >= row_nears[j]; }, visit);
  stream_visits(
      buf, packed, block_floats, n_clusters, [](int j) { return j; },
      [&](int) { return !occ && tm >= cut; }, visit);
  occ_out[i] = occ ? 1 : 0;
}

}  // namespace

// Plain C entry points, bound with ctypes.  Each launches on `stream`,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
extern "C" {

int closest_cluster_launch(const void* meta, const void* ids,
                           const void* nears, const void* cutoff,
                           const void* o3, const void* d3, const void* packed,
                           const void* attrs, int n_rows, int le,
                           int n_clusters, int m, void* t_out, void* id_out,
                           void* u_out, void* v_out, void* attr_out,
                           void* stream) {
  if (n_rows > 0) {
    const size_t smem = 2 * kGeoRows * (size_t)m * sizeof(float);
    closest_cluster_kernel<<<n_rows, kLanes, smem, (cudaStream_t)stream>>>(
        (const int32_t*)meta, (const int32_t*)ids, (const float*)nears,
        (const float*)cutoff, (const float*)o3, (const float*)d3,
        (const float*)packed, (const float*)attrs, n_rows, le, n_clusters, m,
        (float*)t_out, (int32_t*)id_out, (float*)u_out, (float*)v_out,
        (float*)attr_out);
  }
  return (int)cudaGetLastError();
}

int any_cluster_launch(const void* meta, const void* ids, const void* nears,
                       const void* cutoff, const void* o3, const void* d3,
                       const void* tmax, const void* excl, const void* packed,
                       int n_rows, int le, int n_clusters, int m,
                       void* occ_out, void* stream) {
  if (n_rows > 0) {
    const size_t smem = 2 * kGeoRows * (size_t)m * sizeof(float);
    any_cluster_kernel<<<n_rows, kLanes, smem, (cudaStream_t)stream>>>(
        (const int32_t*)meta, (const int32_t*)ids, (const float*)nears,
        (const float*)cutoff, (const float*)o3, (const float*)d3,
        (const float*)tmax, (const int32_t*)excl, (const float*)packed,
        n_rows, le, n_clusters, m, (uint8_t*)occ_out);
  }
  return (int)cudaGetLastError();
}

const char* cluster_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
