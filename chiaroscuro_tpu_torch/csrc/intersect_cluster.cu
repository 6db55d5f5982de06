// Cluster visits for Hopper (sm_90a): closest hit and occlusion.
//
// K4 closest_resident replaces
// chiaroscuro_tpu/ops/cluster_pallas.py::_closest_kernel and K5 any_resident
// ::_any_kernel; K6 closest_cluster replaces ::_stream_closest_kernel and K7
// any_cluster ::_stream_any_kernel.  All four consume the per-row lists the
// cull K3 writes (csrc/cull_rows.cu): meta (B0, 2) [trip, overflow], ids
// (B0, Le) near-ascending cluster ids, nears (B0, Le) entry lower bounds,
// cutoff (B0,) the entry of the first box left off the list (+inf unless the
// row overflowed).
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
// the same function and are bitwise equal.
//
// Layout.  One block owns one 128-lane ray row, one thread per ray; the
// running best lives in registers.  The cluster matrix is (K, 10, M) f32 in
// global memory, field-major per cluster: rows 0-8 are v0|e1|e2, row 9 the
// original triangle id as int32 bits; padded slots are all-zero triangles
// (determinant 0, never hit).  Every thread reads the same triangle at once
// (a broadcast).
//
// The walk (all four).  Each of the row's four warps walks the row's list
// on its own and decides its own exit after every visit with one __any_sync
// over its 32 lanes (closest: some lane's best t >= the next near, then
// >= the cutoff; any: some unoccluded lane's tmax >= it).  The rule is
// exact for the reason a row vote is: the row's nears lower-bound every
// lane's box entry, and the (t, id) minimum and the OR do not depend on
// which warp visits what.  A warp stops at its own last needed visit.  The
// visit bodies read four triangles' fields with one 16-byte load a row, and
// the M = 128 instantiation has a compile-time trip count, so loads and MT
// arithmetic of several triangles overlap; other M (multiples of 4 up to
// 1024) take the generic instantiation.  In an occlusion visit a lane that
// is already occluded tests nothing, and the warp leaves a block once all
// its lanes are occluded (__all_sync every 8 triangles).
//
// The fetch, and why the four are two kernels.  On the TPU the resident
// kernels read a VMEM-resident matrix and the streaming ones DMA each
// visited block from HBM per row.  On the card every kernel reads the one
// matrix in device memory, through the 50 MB L2 that holds it up to ~400k
// triangles.  The closest visit (K4 and K6: closest_visits_kernel) stages a
// block: each warp owns a ring of two slots in shared memory (one where two
// do not fit, M > 724); lane 0 copies a visit's whole block with one
// cp.async.bulk completing on the slot's mbarrier, the next visit's copy in
// flight while this one is tested (40 KB a block of rows at M = 128).  The
// occlusion visit (K5 and K7: any_visits_kernel) reads each block in place
// through L1/L2, its lines prefetched into L1 (prefetch.global.L1) one
// visit ahead: an occlusion visit often ends a few triangles into its
// block.  A streaming fetch that copies each block once per row-visit -- a
// fifth, producer warp keeping bulk copies in flight into a ring of four
// slots the row's warps share -- was measured against these on the same
// lists, with the matrix in L2 (481k triangles, 18.4 MiB) and outgrowing it
// (3M, 114.4 MiB): it lost at full occupancy on every wavefront (0.83-0.94x
// for the closest visit, 0.92-0.93x for occlusion), because its extra warp
// costs a fifth of the registers a multiprocessor can give to testing
// warps, while the L2 absorbs a row's four warps reading one block a few
// visits apart (PERF.md).  So one kernel serves both routes of a
// query, and the wrappers (ops/cluster_cuda.py) keep the routes' names and
// launch counts.
//
// Visit counts.  With a non-null visits_out the kernels write the clusters
// each warp visited (both phases), (B0, 4).  These equal the torch replay of
// the exit rule (ops/cluster_cuda.py::visit_counts_plain) and give the
// bound in PERF.md the work these inputs needed.  A row with trip 0 (parked
// rays) makes no phase-1 visit.
//
// What bounds it on an H100.  A visit is lanes x M Moller-Trumbore tests of
// ~54 FP32 operations (-fmad=false: no fused multiply-add, so the peak is
// 33.5 T unfused operations/s) on one 5 KB block at M = 128.  The card's
// balance is 10 operations a byte (33.5 T / 3.35 TB/s of device memory): a
// warp's closest visit does ~43 per byte it fetches, an occlusion visit
// fewer (its lanes stop at their first blocker), and the four warps of a
// row fetch a block a few visits apart, so the L2 serves the repeats even
// when the matrix outgrows it.  The kernels are arithmetic-bound.  Tensor
// cores do not apply: the test is scalar FP32 with a bitwise contract.
// What the design does about the bound: it cuts the tests (per-warp exits,
// occluded lanes idle) and keeps the next blocks' bytes in flight, so a
// warp waits on arithmetic rather than on memory.
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
using mt::Tri;

constexpr int kGeoRows = 10;    // v0 | e1 | e2 | original id
constexpr int kIdRow = 9;
constexpr int kNoId = 0x7fffffff;
constexpr int kWarps = kLanes / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMainM = 128;     // the main path's cluster width
constexpr int kMaxSlots = 2;    // ring slots a warp (closest)
constexpr int kBarBytes = 128;  // kWarps * kMaxSlots mbarriers, padded
constexpr int kAnyGroup = 8;    // triangles between occlusion votes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One warp's ring of n_slots block-sized slots in shared memory, each with
// an mbarrier that its bulk copy completes.  The counters are the same in
// every lane: fill f goes to slot f % n_slots and completes that slot's
// barrier phase f / n_slots.
struct WarpRing {
  float* slots;
  uint64_t* bars;
  int n_slots;
  int block_floats;
  int fills;
  int waits;

  // Lane 0 issues the copy of the block at `src` into the next slot, whose
  // previous contents every lane has read (the caller's __syncwarp).
  __device__ __forceinline__ void issue(const float* src) {
    const int s = fills % n_slots;
    if ((threadIdx.x & 31) == 0) {
      const uint32_t bytes = (uint32_t)block_floats * 4u;
      const uint32_t bar = smem_addr(bars + s);
      // The slot was read through the generic proxy; the copy writes it
      // through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(
              smem_addr(slots + (size_t)s * block_floats)),
          "l"(src), "r"(bytes), "r"(bar)
          : "memory");
    }
    ++fills;
  }

  // Wait for the oldest fill not yet waited on; returns its slot.
  __device__ __forceinline__ const float* wait() {
    const int s = waits % n_slots;
    const uint32_t parity = (uint32_t)(waits / n_slots) & 1u;
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_addr(bars + s)), "r"(parity)
          : "memory");
    }
    ++waits;
    return slots + (size_t)s * block_floats;
  }

  // Wait for copies left in flight by an early exit, before the slots are
  // refilled or the block ends.
  __device__ __forceinline__ void drain() {
    while (waits < fills) wait();
  }
};

// The calling warp's ring in the dynamic shared memory: kBarBytes of
// barriers, then kWarps rings of n_slots slots.  Lane 0 initialises the
// barriers; only this warp uses them, so a warp barrier suffices.
__device__ __forceinline__ WarpRing warp_ring(unsigned char* smem,
                                              int block_floats, int n_slots) {
  const int warp = threadIdx.x >> 5;
  WarpRing ring;
  ring.bars = reinterpret_cast<uint64_t*>(smem) + warp * kMaxSlots;
  ring.slots = reinterpret_cast<float*>(smem + kBarBytes) +
               (size_t)warp * n_slots * block_floats;
  ring.n_slots = n_slots;
  ring.block_floats = block_floats;
  ring.fills = 0;
  ring.waits = 0;
  if ((threadIdx.x & 31) == 0) {
    for (int s = 0; s < n_slots; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(ring.bars + s))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  return ring;
}

// The warp prefetches a block's 128-byte lines into L1, one a lane.
__device__ __forceinline__ void prefetch_block(const float* blk,
                                               int block_floats) {
  for (int f = (threadIdx.x & 31) * 32; f < block_floats; f += 32 * 32) {
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(
        __cvta_generic_to_global(blk + f)));
  }
}

// One warp visits cid_of(0), ..., cid_of(n - 1) in order for as long as some
// lane's keep(j) holds before visit j, voted by the warp alone after every
// visit.  Staged (closest): the first n_slots blocks are copied at once and
// each later copy is issued as a slot frees, so n_slots - 1 copies fly while
// a block is tested (a copy past an exit is drained, never visited).  Direct
// (occlusion, no ring): the block is read in place and the next one
// prefetched.  Returns the visit count.
template <bool kStaged, class CidOf, class Keep, class Visit>
__device__ __forceinline__ int warp_visits(WarpRing& ring,
                                           const float* __restrict__ packed,
                                           int block_floats, int n,
                                           CidOf cid_of, Keep keep,
                                           Visit visit) {
  if (n <= 0 || !__any_sync(kFull, keep(0))) return 0;
  auto block = [&](int j) {
    return packed + (size_t)cid_of(j) * block_floats;
  };
  if constexpr (kStaged) {
    for (int q = 0; q < min(ring.n_slots, n); ++q) ring.issue(block(q));
  }
  int j = 0;
  for (;;) {
    if constexpr (kStaged) {
      visit(ring.wait());
    } else {
      if (j + 1 < n) prefetch_block(block(j + 1), block_floats);
      visit(block(j));
    }
    ++j;
    // Every lane is done with the block before its slot is refilled.
    __syncwarp();
    if (j >= n || !__any_sync(kFull, keep(j))) break;
    if constexpr (kStaged) {
      if (j + ring.n_slots - 1 < n) ring.issue(block(j + ring.n_slots - 1));
    }
  }
  if constexpr (kStaged) ring.drain();
  return j;
}

// The warp's phase 1 over the row's list, then its phase 2 over every
// cluster; returns the warp's visit count.
template <bool kStaged, class Keep1, class Keep2, class Visit>
__device__ __forceinline__ int warp_row(WarpRing& ring,
                                        const float* __restrict__ packed,
                                        int block_floats, int trip,
                                        const int32_t* row_ids,
                                        int n_clusters, Keep1 keep1,
                                        Keep2 keep2, Visit visit) {
  auto listed = [&](int j) { return row_ids[j]; };
  auto every = [](int j) { return j; };
  const int n1 = warp_visits<kStaged>(ring, packed, block_floats, trip,
                                      listed, keep1, visit);
  return n1 + warp_visits<kStaged>(ring, packed, block_floats, n_clusters,
                                   every, keep2, visit);
}

// Triangle i (0-3) of four whose fields were read as one float4 a row.
__device__ __forceinline__ float pick(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

__device__ __forceinline__ Tri tri_of(const float4 (&f)[kGeoRows], int i) {
  return Tri{pick(f[0], i), pick(f[1], i), pick(f[2], i),
             pick(f[3], i), pick(f[4], i), pick(f[5], i),
             pick(f[6], i), pick(f[7], i), pick(f[8], i)};
}

// Fields of triangles s..s+3 of a block with M = m (s % 4 == 0).
__device__ __forceinline__ void load_quad(const float* blk, int m, int s,
                                          float4 (&f)[kGeoRows]) {
#pragma unroll
  for (int k = 0; k < kGeoRows; ++k) {
    f[k] = *reinterpret_cast<const float4*>(blk + k * m + s);
  }
}

struct Best {
  float t, u, v;
  int id;
};

// The closest visit: every triangle of the block against the lane's ray, the
// lexicographic (t, id) minimum kept.  kM > 0 fixes M at compile time.
template <int kM>
__device__ __forceinline__ void closest_visit(const Ray& r, const float* blk,
                                              int m_rt, Best& b) {
  const int m = kM > 0 ? kM : m_rt;
#pragma unroll 2
  for (int s = 0; s < m; s += 4) {
    float4 f[kGeoRows];
    load_quad(blk, m, s, f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float t, u, v;
      if (mt::mt_test(r, tri_of(f, i), t, u, v) && t < kBig) {
        const int id = __float_as_int(pick(f[kIdRow], i));
        if (t < b.t || (t == b.t && id < b.id)) b = Best{t, u, v, id};
      }
    }
  }
}

// The occlusion visit: an open lane tests triangles for a blocker (id != ex at
// t < tm); an occluded lane tests none, and the warp leaves the block once
// every lane is occluded, voted every kAnyGroup triangles.
template <int kM>
__device__ __forceinline__ void any_visit(const Ray& r, float tm, int ex,
                                          const float* blk, int m_rt,
                                          bool& occ) {
  const int m = kM > 0 ? kM : m_rt;
  for (int g = 0; g < m; g += kAnyGroup) {
    if (!occ) {
#pragma unroll
      for (int h = 0; h < kAnyGroup; h += 4) {
        if (g + h < m) {
          float4 f[kGeoRows];
          load_quad(blk, m, g + h, f);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float t, u, v;
            const bool hit = mt::mt_test(r, tri_of(f, i), t, u, v);
            occ |= hit & (t < tm) &
                   (__float_as_int(pick(f[kIdRow], i)) != ex);
          }
        }
      }
    }
    if (__all_sync(kFull, occ)) break;
  }
}

template <int kM>
__global__ void __launch_bounds__(kLanes)
closest_visits_kernel(const int32_t* __restrict__ meta,
                      const int32_t* __restrict__ ids,
                      const float* __restrict__ nears,
                      const float* __restrict__ cutoff,
                      const float* __restrict__ o3,
                      const float* __restrict__ d3,
                      const float* __restrict__ packed,
                      const float* __restrict__ attrs, int n_rows, int le,
                      int n_clusters, int m, int n_slots,
                      float* __restrict__ t_out, int32_t* __restrict__ id_out,
                      float* __restrict__ u_out, float* __restrict__ v_out,
                      float* __restrict__ attr_out,
                      int32_t* __restrict__ visits_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int row = blockIdx.x;
  const size_t plane = (size_t)n_rows * kLanes;
  const size_t i = (size_t)row * kLanes + threadIdx.x;
  const int block_floats = kGeoRows * m;
  const Ray r = load_ray(o3, d3, plane, i);
  const int trip = meta[2 * row];
  const int32_t* row_ids = ids + (size_t)row * le;
  const float* row_nears = nears + (size_t)row * le;
  const float cut = cutoff[row];
  WarpRing ring = warp_ring(smem, block_floats, n_slots);

  Best b{kBig, 0.0f, 0.0f, kNoId};
  const int visits = warp_row<true>(
      ring, packed, block_floats, trip, row_ids, n_clusters,
      [&](int j) { return b.t >= row_nears[j]; },
      [&](int) { return b.t >= cut; },
      [&](const float* blk) { closest_visit<kM>(r, blk, m, b); });

  const bool hit = b.t < kBig;
  const int id = hit ? b.id : 0;
  t_out[i] = b.t;
  id_out[i] = id;
  u_out[i] = b.u;
  v_out[i] = b.v;
  mt::store_attrs(attrs, hit, id, plane, i, attr_out);
  if (visits_out != nullptr && (threadIdx.x & 31) == 0) {
    visits_out[(size_t)row * kWarps + (threadIdx.x >> 5)] = visits;
  }
}

template <int kM>
__global__ void __launch_bounds__(kLanes)
any_visits_kernel(const int32_t* __restrict__ meta,
                  const int32_t* __restrict__ ids,
                  const float* __restrict__ nears,
                  const float* __restrict__ cutoff,
                  const float* __restrict__ o3, const float* __restrict__ d3,
                  const float* __restrict__ tmax,
                  const int32_t* __restrict__ excl,
                  const float* __restrict__ packed, int n_rows, int le,
                  int n_clusters, int m, uint8_t* __restrict__ occ_out,
                  int32_t* __restrict__ visits_out) {
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
  WarpRing ring{};   // unused: occlusion reads its blocks in place

  bool occ = false;
  const int visits = warp_row<false>(
      ring, packed, block_floats, trip, row_ids, n_clusters,
      [&](int j) { return !occ && tm >= row_nears[j]; },
      [&](int) { return !occ && tm >= cut; },
      [&](const float* blk) { any_visit<kM>(r, tm, ex, blk, m, occ); });
  occ_out[i] = occ ? 1 : 0;
  if (visits_out != nullptr && (threadIdx.x & 31) == 0) {
    visits_out[(size_t)row * kWarps + (threadIdx.x >> 5)] = visits;
  }
}

// The closest visit's ring slots a warp for M = m (two, or one where two do
// not fit the card's opt-in shared memory; 0 if none fits) and the dynamic
// shared memory that takes.
int closest_slots(int m, size_t* bytes) {
  static int optin = -1;
  if (optin < 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess) {
      optin = 48 * 1024;
    }
  }
  for (int s = kMaxSlots; s >= 1; --s) {
    *bytes = kBarBytes + (size_t)kWarps * s * kGeoRows * m * sizeof(float);
    if (*bytes <= (size_t)optin) return s;
  }
  return 0;
}

// The shared memory and ring slots of a closest launch, `kernel` opted in
// where the ring exceeds the 48 KB default; returns a CUDA error code.
template <class Kernel>
int closest_setup(Kernel kernel, int m, size_t* bytes, int* n_slots) {
  *n_slots = closest_slots(m, bytes);
  if (*n_slots == 0) return (int)cudaErrorInvalidValue;
  if (*bytes > 48 * 1024) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
  }
  return (int)cudaSuccess;
}

}  // namespace

// Plain C entry points, bound with ctypes: the closest visits (K4 and K6)
// and the occlusion visits (K5 and K7).  Each launches on `stream`,
// allocates nothing, does not synchronise, and returns the first CUDA error
// (a shared-memory opt-in, then cudaGetLastError()).  visits_out may be
// null; else it is (n_rows, 4) int32.
extern "C" {

int closest_visits_launch(const void* meta, const void* ids, const void* nears,
                          const void* cutoff, const void* o3, const void* d3,
                          const void* packed, const void* attrs, int n_rows,
                          int le, int n_clusters, int m, void* t_out,
                          void* id_out, void* u_out, void* v_out,
                          void* attr_out, void* visits_out, void* stream) {
  // M = 128 takes the instantiation with a compile-time trip count.
  const bool main_m = m == kMainM;
  const auto kernel = main_m ? closest_visits_kernel<kMainM>
                             : closest_visits_kernel<0>;
  size_t bytes;
  int n_slots;
  const int err = closest_setup(kernel, m, &bytes, &n_slots);
  if (err != 0) return err;
  if (n_rows > 0) {
    kernel<<<n_rows, kLanes, bytes, (cudaStream_t)stream>>>(
        (const int32_t*)meta, (const int32_t*)ids, (const float*)nears,
        (const float*)cutoff, (const float*)o3, (const float*)d3,
        (const float*)packed, (const float*)attrs, n_rows, le, n_clusters, m,
        n_slots, (float*)t_out, (int32_t*)id_out, (float*)u_out,
        (float*)v_out, (float*)attr_out, (int32_t*)visits_out);
  }
  return (int)cudaGetLastError();
}

int any_visits_launch(const void* meta, const void* ids, const void* nears,
                      const void* cutoff, const void* o3, const void* d3,
                      const void* tmax, const void* excl, const void* packed,
                      int n_rows, int le, int n_clusters, int m, void* occ_out,
                      void* visits_out, void* stream) {
  const auto kernel = m == kMainM ? any_visits_kernel<kMainM>
                                  : any_visits_kernel<0>;
  if (n_rows > 0) {
    kernel<<<n_rows, kLanes, 0, (cudaStream_t)stream>>>(
        (const int32_t*)meta, (const int32_t*)ids, (const float*)nears,
        (const float*)cutoff, (const float*)o3, (const float*)d3,
        (const float*)tmax, (const int32_t*)excl, (const float*)packed,
        n_rows, le, n_clusters, m, (uint8_t*)occ_out, (int32_t*)visits_out);
  }
  return (int)cudaGetLastError();
}

// The dynamic shared memory of a closest launch at M = m (its ring and
// barriers); 0 where no ring fits.
int closest_visits_smem_bytes(int m) {
  size_t bytes;
  return closest_slots(m, &bytes) > 0 ? (int)bytes : 0;
}

const char* intersect_cluster_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
