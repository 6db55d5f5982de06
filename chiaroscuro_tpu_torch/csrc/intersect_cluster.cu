// Cluster visits for Hopper (sm_90a): streaming and resident.
//
// K6 closest_cluster replaces
// chiaroscuro_tpu/ops/cluster_pallas.py::_stream_closest_kernel and K7
// any_cluster replaces ::_stream_any_kernel; K4 closest_resident replaces
// ::_closest_kernel and K5 any_resident replaces ::_any_kernel.  All four
// consume the per-row lists the cull K3 writes (ops/cull_triton.py): meta
// (B0, 2) [trip, overflow], ids (B0, Le) near-ascending cluster ids, nears
// (B0, Le) entry lower bounds, cutoff (B0,) the entry of the first box left
// off the list (+inf unless the row overflowed).
//
// What they compute, as the TPU kernels do.  Phase 1 visits the listed
// clusters near to far and stops once no lane can improve: closest while
// some lane's best t >= the next box's near, any while some unoccluded lane
// has tmax >= it.  Phase 2 sweeps all K clusters in identity order while
// some lane's pending work reaches the cutoff (overflow rows only).  The
// closest hit is the lexicographic (t, original id) minimum, so the result
// does not depend on visit order or grouping and equals the brute oracle's
// lowest-id tie-break; the winner's 32 attributes are fetched once, at the
// end, by its original id from the original-order (T, 32) table (the TPU's
// one-hot MXU fetch and attribute rows 16-47 of its packed block are not
// carried over).  Ids are int32 throughout; a miss writes t = BIG, id = 0,
// u = v = 0 and zero attributes.  The JAX package's 2^24 triangle limit is
// kept by the wrapper (ops/cluster_cuda.py).  K4 and K6 (K5 and K7) compute
// the same function by two memory routes and are bitwise equal.
//
// Layout.  One block of 128 threads owns one 128-lane ray row, one thread
// per ray; the running best lives in registers.  The cluster matrix is
// (K, 10, M) f32 in global memory, field-major per cluster: rows 0-8 are
// v0|e1|e2, row 9 the original triangle id as int32 bits; padded slots are
// all-zero triangles (determinant 0, never hit).  Every thread reads the
// same triangle at once (a broadcast).
//
// - Streaming (K6/K7): each visited cluster's 10 x M block (5 KB at
//   M = 128) is staged into shared memory with cp.async into a two-slot
//   buffer, the next listed cluster's copy in flight while the current one
//   is tested: the counterpart of the TPU kernels' DMA double buffer
//   (cluster_pallas.py:642-697).  The early-exit test runs after every
//   visit as a block-wide vote (__syncthreads_or), which is also the
//   barrier that frees the slot the next copy overwrites.
// - Resident (K4/K5): on the TPU the whole packed matrix sits in VMEM.  The
//   card's counterpart is its 50 MB L2: the JAX rule sends a scene here only
//   when its 48-row matrix is within 72 MiB, so the port's 10-row matrix is
//   at most 15 MiB.  Each visited block is read straight from global memory
//   through L2 and L1 with warp-uniform loads (one transaction per warp), no
//   staging and no shared memory.  The early exit is voted once per group
//   of kU = 8 visits, as _closest_kernel checks it once per unrolled group
//   (cluster_pallas.py:497-518, visit_u = 8); visits past the end of a list
//   are skipped where the TPU kernel repeats the last one (idempotent).
//
// Every thread runs the same number of votes: the loop bounds and the vote
// results are block-uniform, and a thread whose lanes are done still takes
// part.  A row with trip 0 (parked rays) makes no visit.  With a non-null
// visits_out, thread 0 writes the row's cluster visit count (both phases):
// the work these inputs needed, for the bound in PERF.md.
//
// What bounds it on an H100.  A visit is 128 x M Moller-Trumbore tests of
// ~50 FP32 operations (-fmad=false: no fused multiply-add) on 5 KB from
// device memory or L2: ~160 operations per byte at M = 128, so with the
// blocks in L2 the kernels are arithmetic-bound, at 33.5 T unfused FP32
// operations/s.  The serial part is the vote (after every visit when
// streaming, every eighth resident) and, streaming, the copy it waits on;
// with one block per row and a few blocks per SM, latency rather than
// arithmetic is expected to dominate until visits are batched (later work;
// this is the simple design that is right).
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
constexpr int kU = 8;           // resident visits per early-exit vote

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
// every thread calls this the same number of times.  Returns the number of
// clusters visited.
template <class CidOf, class Keep, class Visit>
__device__ __forceinline__ int stream_visits(float* buf,
                                             const float* __restrict__ packed,
                                             int block_floats, int n,
                                             CidOf cid_of, Keep keep,
                                             Visit visit) {
  if (n <= 0 || !__syncthreads_or(keep(0))) return 0;
  stage_block(buf, packed, cid_of(0), block_floats);
  cp_async_commit();
  int j = 0;
  for (;;) {
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
  return j;
}

// Visit clusters cid_of(0) ... cid_of(n - 1) in order straight from global
// memory, kU at a time, for as long as some thread's keep(j) holds before
// group j.  The vote is block-uniform, so every thread runs the same groups.
// Returns the number of clusters visited.
template <class CidOf, class Keep, class Visit>
__device__ __forceinline__ int resident_visits(
    const float* __restrict__ packed, int block_floats, int n, CidOf cid_of,
    Keep keep, Visit visit) {
  int j = 0;
  for (; j < n; j += kU) {
    if (!__syncthreads_or(keep(j))) return j;
    const int end = min(j + kU, n);
    for (int q = j; q < end; ++q) {
      visit(packed + (size_t)cid_of(q) * block_floats);
    }
  }
  return n > 0 ? n : 0;
}

// Phase 1 over the row's list, then phase 2 over every cluster, by the
// route kStream; returns the row's visit count.
template <bool kStream, class Keep1, class Keep2, class Visit>
__device__ __forceinline__ int visit_row(float* buf,
                                         const float* __restrict__ packed,
                                         int block_floats, int trip,
                                         const int32_t* row_ids,
                                         int n_clusters, Keep1 keep1,
                                         Keep2 keep2, Visit visit) {
  auto listed = [&](int j) { return row_ids[j]; };
  auto every = [](int j) { return j; };
  if constexpr (kStream) {
    const int n1 = stream_visits(buf, packed, block_floats, trip, listed,
                                 keep1, visit);
    return n1 + stream_visits(buf, packed, block_floats, n_clusters, every,
                              keep2, visit);
  } else {
    const int n1 =
        resident_visits(packed, block_floats, trip, listed, keep1, visit);
    return n1 + resident_visits(packed, block_floats, n_clusters, every,
                                keep2, visit);
  }
}

template <bool kStream>
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
                       float* __restrict__ attr_out,
                       int32_t* __restrict__ visits_out) {
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
  // Phase 1 while some lane's best t reaches the next box; phase 2 while
  // some lane could still be beaten past the cutoff (never for rows that
  // did not overflow: cutoff = +inf).
  const int visits = visit_row<kStream>(
      buf, packed, block_floats, trip, row_ids, n_clusters,
      [&](int j) { return best_t >= row_nears[j]; },
      [&](int) { return best_t >= cut; }, visit);

  const bool hit = best_t < kBig;
  const int id = hit ? best_id : 0;
  t_out[i] = best_t;
  id_out[i] = id;
  u_out[i] = best_u;
  v_out[i] = best_v;
  mt::store_attrs(attrs, hit, id, plane, i, attr_out);
  if (visits_out != nullptr && threadIdx.x == 0) visits_out[row] = visits;
}

template <bool kStream>
__global__ void __launch_bounds__(kLanes)
any_cluster_kernel(const int32_t* __restrict__ meta,
                   const int32_t* __restrict__ ids,
                   const float* __restrict__ nears,
                   const float* __restrict__ cutoff,
                   const float* __restrict__ o3, const float* __restrict__ d3,
                   const float* __restrict__ tmax,
                   const int32_t* __restrict__ excl,
                   const float* __restrict__ packed, int n_rows, int le,
                   int n_clusters, int m, uint8_t* __restrict__ occ_out,
                   int32_t* __restrict__ visits_out) {
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
  const int visits = visit_row<kStream>(
      buf, packed, block_floats, trip, row_ids, n_clusters,
      [&](int j) { return !occ && tm >= row_nears[j]; },
      [&](int) { return !occ && tm >= cut; }, visit);
  occ_out[i] = occ ? 1 : 0;
  if (visits_out != nullptr && threadIdx.x == 0) visits_out[row] = visits;
}

// Streaming kernels stage two blocks in dynamic shared memory; resident
// ones use none.
template <bool kStream>
size_t smem_bytes(int m) {
  return kStream ? 2 * kGeoRows * (size_t)m * sizeof(float) : 0;
}

template <bool kStream>
int launch_closest(const void* meta, const void* ids, const void* nears,
                   const void* cutoff, const void* o3, const void* d3,
                   const void* packed, const void* attrs, int n_rows, int le,
                   int n_clusters, int m, void* t_out, void* id_out,
                   void* u_out, void* v_out, void* attr_out, void* visits_out,
                   void* stream) {
  if (n_rows > 0) {
    closest_cluster_kernel<kStream>
        <<<n_rows, kLanes, smem_bytes<kStream>(m), (cudaStream_t)stream>>>(
            (const int32_t*)meta, (const int32_t*)ids, (const float*)nears,
            (const float*)cutoff, (const float*)o3, (const float*)d3,
            (const float*)packed, (const float*)attrs, n_rows, le,
            n_clusters, m, (float*)t_out, (int32_t*)id_out, (float*)u_out,
            (float*)v_out, (float*)attr_out, (int32_t*)visits_out);
  }
  return (int)cudaGetLastError();
}

template <bool kStream>
int launch_any(const void* meta, const void* ids, const void* nears,
               const void* cutoff, const void* o3, const void* d3,
               const void* tmax, const void* excl, const void* packed,
               int n_rows, int le, int n_clusters, int m, void* occ_out,
               void* visits_out, void* stream) {
  if (n_rows > 0) {
    any_cluster_kernel<kStream>
        <<<n_rows, kLanes, smem_bytes<kStream>(m), (cudaStream_t)stream>>>(
            (const int32_t*)meta, (const int32_t*)ids, (const float*)nears,
            (const float*)cutoff, (const float*)o3, (const float*)d3,
            (const float*)tmax, (const int32_t*)excl, (const float*)packed,
            n_rows, le, n_clusters, m, (uint8_t*)occ_out,
            (int32_t*)visits_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes.  Each launches on `stream`,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
// visits_out may be null.
extern "C" {

int closest_cluster_launch(const void* meta, const void* ids,
                           const void* nears, const void* cutoff,
                           const void* o3, const void* d3, const void* packed,
                           const void* attrs, int n_rows, int le,
                           int n_clusters, int m, void* t_out, void* id_out,
                           void* u_out, void* v_out, void* attr_out,
                           void* visits_out, void* stream) {
  return launch_closest<true>(meta, ids, nears, cutoff, o3, d3, packed, attrs,
                              n_rows, le, n_clusters, m, t_out, id_out, u_out,
                              v_out, attr_out, visits_out, stream);
}

int closest_resident_launch(const void* meta, const void* ids,
                            const void* nears, const void* cutoff,
                            const void* o3, const void* d3,
                            const void* packed, const void* attrs, int n_rows,
                            int le, int n_clusters, int m, void* t_out,
                            void* id_out, void* u_out, void* v_out,
                            void* attr_out, void* visits_out, void* stream) {
  return launch_closest<false>(meta, ids, nears, cutoff, o3, d3, packed,
                               attrs, n_rows, le, n_clusters, m, t_out, id_out,
                               u_out, v_out, attr_out, visits_out, stream);
}

int any_cluster_launch(const void* meta, const void* ids, const void* nears,
                       const void* cutoff, const void* o3, const void* d3,
                       const void* tmax, const void* excl, const void* packed,
                       int n_rows, int le, int n_clusters, int m,
                       void* occ_out, void* visits_out, void* stream) {
  return launch_any<true>(meta, ids, nears, cutoff, o3, d3, tmax, excl, packed,
                          n_rows, le, n_clusters, m, occ_out, visits_out,
                          stream);
}

int any_resident_launch(const void* meta, const void* ids, const void* nears,
                        const void* cutoff, const void* o3, const void* d3,
                        const void* tmax, const void* excl,
                        const void* packed, int n_rows, int le,
                        int n_clusters, int m, void* occ_out,
                        void* visits_out, void* stream) {
  return launch_any<false>(meta, ids, nears, cutoff, o3, d3, tmax, excl,
                           packed, n_rows, le, n_clusters, m, occ_out,
                           visits_out, stream);
}

const char* intersect_cluster_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
