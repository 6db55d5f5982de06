// Dense ray-triangle intersection kernels for Hopper (sm_90a).
//
// K1 closest_dense replaces chiaroscuro_tpu/ops/intersect_pallas.py::_closest_kernel
// and K2 any_dense replaces ::_any_kernel.  Both compute what the TPU kernels
// compute: Moller-Trumbore of every ray against every triangle, with the
// reference's epsilon and acceptance tests (_mt_core), the lowest id winning
// a tie in t, and sentinel outputs for rows the caller marks dead.
//
// Layout.  Rays arrive planar, (3, B0, 128) component-major, as everywhere in
// the port.  Triangles arrive as the padded kernel copy of the (T, 9) rows,
// (T, 12) = v0|0|e1|0|e2|0, 48 bytes a triangle (ops/intersect_cuda.py
// pad_table, made once per intersector pair), so a triangle is three 16-byte
// shared-memory loads that every lane of a warp reads at once.
//
// The table is resident.  The TPU kernel keeps the whole (T, 9) table in
// VMEM; here each persistent block copies it once into dynamic shared memory
// with cp.async.bulk completing on an mbarrier (196,608 B at the dense path's
// 4,096-triangle ceiling, kChunkTris), and no barrier follows.  The grid is
// the card's resident blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor x
// SMs) of 32 warps: one block an SM, every warp that 64 registers a thread
// allow.  A table larger than kChunkTris (intersector dense on a large
// scene) is swept in chunks staged one after another, with a block barrier
// around each: right, not fast.
//
// Warps own their work.  A unit is 32 lanes of a 128-lane row, one ray a
// thread (two or four rays a thread, tried on the card, lost to one: at 16
// warps an SM they tie it, and at 32 two rays spill past 64 registers).  A
// warp takes its next unit from a counter in device memory (an atomic add
// issued a unit ahead), so a warp that meets dead, occluded or rejected
// rows takes more of them.  A static split (block b's warps taking groups
// b, b + gridDim.x, ... of 32 units) was 27-28% slower on the
// 4,096-triangle soup's queries, a third of whose rows are dead, and
// 0.5-3% on a frame's wavefronts (an H100, tools/dense_compare.py): rows
// that cost little fall unevenly to the blocks.  Each stream has its own counters, and a launch's
// last warp resets them for the next launch on that stream, so launches on
// concurrent streams never share one.
// A row whose `live` flag is 0 writes the sentinels (t = BIG, id = 0,
// u = v = 0, attributes 0; occluded = false).
//
// The warp-uniform reject.  After u (mt_front), a warp in which no lane can
// still accept the triangle (nonpar and 0 <= u <= 1, mt_u_ok) skips q, v, t
// and the acceptance test: a skipped lane is a miss either way, so the
// results are the same bits.  On a frame's coherent wavefronts most
// (warp, triangle) pairs are skipped; the bound counts the tests it leaves
// (ops/intersect_cuda.py reject_counts).
//
// The reciprocal.  With `1.0f / (nonpar ? a : 1.0f)` nvcc divides first and
// selects after, so a lane with a == 0 (a ray parallel to the triangle's
// plane: the integrator parks a dead lane along +x, parallel to every
// axis-aligned wall) takes the division's slow path; __frcp_rn of the
// selected value (the same correctly rounded bits) keeps the select first.
// On a bounce wavefront and its shadow rays, most of whose lanes are
// parked, that is 12-20% of the kernels' time.
//
// K1 scans ids in ascending order with a strict `t < best` update, which is
// the lowest-id tie-break.  Its outputs are 36 floats a ray (t, id, u, v and
// the winner's 32 attributes, loaded as eight float4 from the row-major
// (T, 32) table where the TPU used a one-hot MXU matmul): coalesced planar
// stores, each warp's overlapping the other warps' sweeps.
// K2 stops at the first blocker: every kVote triangles the warp leaves its
// unit once every lane is occluded (a vote every 1, 4, 16 or 32 triangles
// measured no better); an occluded lane does not vote in the reject.
//
// What bounds it on an H100.  A test is 54 FP32 operations, 29 up to the
// reject.  At the 4,096 triangles the dense path admits both are bound by
// those operations; the loop issues the arithmetic, the reciprocal's
// refinement and range check, the votes and the best-hit selects, so the
// issue rate, not memory, limits it.  At Cornell's 36 triangles K1 is bound
// by its 36 floats a ray of stores (85 MB for a 768x768 wavefront).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC.  -fmad=false keeps every product
// and sum rounded on its own, as torch's eager ops round them, and the
// operand order in mt_core.cuh is _mt_core's, so the kernels equal their
// plain torch versions (ops/intersect_cuda.py) bit for bit.  Contracting to
// FMA is later work that will have to bound id flips at near-ties.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt_core.cuh"
#include "work_counters.cuh"

namespace {

using mt::kBig;
using mt::kLanes;
using mt::load_ray;
using mt::Ray;
using mt::Tri;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;             // 32 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kUnitsPerRow = kLanes / 32;  // a unit: 32 lanes of a row
constexpr int kTriF4 = 3;                  // float4 rows a triangle
constexpr int kTriBytes = kTriF4 * 16;
constexpr int kChunkTris = 4096;           // triangles resident at once
constexpr int kBarBytes = 16;              // the staging mbarrier, padded
constexpr uint32_t kCopyBytes = 32768;     // bytes a bulk copy
constexpr int kVote = 8;                   // K2's triangles between exit votes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Thread 0 copies `n` triangles of the padded table at `src` into `tab` with
// bulk copies completing on `bar`; every thread then waits for the phase of
// parity `parity`.  The caller has made sure that no thread still reads
// `tab` (a block barrier).
__device__ __forceinline__ void stage(float4* tab, uint64_t* bar,
                                      const float4* src, int n,
                                      uint32_t parity) {
  const uint32_t bytes = (uint32_t)n * kTriBytes;
  const uint32_t b = smem_addr(bar);
  if (threadIdx.x == 0) {
    // Earlier chunks were read through the generic proxy; the copy writes
    // through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(b), "r"(bytes)
                 : "memory");
    for (uint32_t off = 0; off < bytes; off += kCopyBytes) {
      const uint32_t n_bytes = min(bytes - off, kCopyBytes);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(tab) + off),
          "l"(reinterpret_cast<const char*>(src) + off), "r"(n_bytes), "r"(b)
          : "memory");
    }
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  }
}

// Lane 0 asks for the warp's next unit; the answer is read with take().
__device__ __forceinline__ unsigned ask(unsigned* work) {
  return (threadIdx.x & 31) == 0 ? atomicAdd(work, 1u) : 0u;
}

__device__ __forceinline__ int take(unsigned asked) {
  return (int)__shfl_sync(kFull, asked, 0);
}

struct ClosestArgs {
  const float* o3;
  const float* d3;
  const float* attrs;
  float* t_out;
  int32_t* id_out;
  float* u_out;
  float* v_out;
  float* attr_out;
};

struct AnyArgs {
  const float* o3;
  const float* d3;
  const float* tmax;
  const int32_t* excl;
  uint8_t* occ_out;
};

// K1's unit: the lane's ray and its running best.
struct Closest {
  using Args = ClosestArgs;
  Ray r;
  float t = kBig, u = 0.0f, v = 0.0f;
  int id = 0;

  __device__ __forceinline__ void begin(const Args& a, size_t plane, size_t i,
                                        bool live) {
    if (live) r = load_ray(a.o3, a.d3, plane, i);
  }

  // Triangles [0, n) of `tab`, ids id0 + j.  Returns whether the unit is
  // done (never: every triangle may be closer).
  __device__ __forceinline__ bool sweep(const float4* tab, int n, int id0) {
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const Tri tri = mt::tri_from_rows(tab + kTriF4 * j);
      const mt::Front h = mt::mt_front<true>(r, tri);
      if (__any_sync(kFull, mt::mt_u_ok(h))) {
        float tt, vv;
        if (mt::mt_back(r, tri, h, tt, vv) && tt < t) {
          t = tt;
          u = h.u;
          v = vv;
          id = id0 + j;
        }
      }
    }
    return false;
  }

  __device__ __forceinline__ void end(const Args& a, size_t plane, size_t i) {
    a.t_out[i] = t;
    a.id_out[i] = id;
    a.u_out[i] = u;
    a.v_out[i] = v;
    mt::store_attrs(a.attrs, t < kBig, id, plane, i, a.attr_out);
  }
};

// K2's unit: the lane's ray, limit, exclusion and occlusion.
struct Any {
  using Args = AnyArgs;
  Ray r;
  float tm;
  int ex;
  bool occ = false;

  __device__ __forceinline__ void begin(const Args& a, size_t plane, size_t i,
                                        bool live) {
    if (live) {
      r = load_ray(a.o3, a.d3, plane, i);
      tm = a.tmax[i];
      ex = a.excl[i];
    }
  }

  __device__ __forceinline__ void test(const float4* tab, int j, int id) {
    const Tri tri = mt::tri_from_rows(tab + kTriF4 * j);
    const mt::Front h = mt::mt_front<true>(r, tri);
    if (__any_sync(kFull, !occ && mt::mt_u_ok(h))) {
      float tt, vv;
      const bool hit = mt::mt_back(r, tri, h, tt, vv);
      occ = occ || (hit && tt < tm && id != ex);
    }
  }

  // Returns whether every lane is occluded.
  __device__ __forceinline__ bool sweep(const float4* tab, int n, int id0) {
    for (int j0 = 0; j0 < n; j0 += kVote) {
      if (__all_sync(kFull, occ)) return true;
      if (j0 + kVote <= n) {
#pragma unroll
        for (int k = 0; k < kVote; ++k) test(tab, j0 + k, id0 + j0 + k);
      } else {
        for (int j = j0; j < n; ++j) test(tab, j, id0 + j);
      }
    }
    return __all_sync(kFull, occ);
  }

  __device__ __forceinline__ void end(const Args& a, size_t, size_t i) {
    a.occ_out[i] = occ ? 1 : 0;
  }
};

// The persistent sweep of one query kind Q over n_rows rows of 128 rays.
template <class Q>
__global__ void __launch_bounds__(kThreads, 1)
dense_kernel(typename Q::Args a, const int32_t* __restrict__ live,
             const float4* __restrict__ table, int n_rows, int n_tris,
             unsigned* work) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float4* tab = reinterpret_cast<float4*>(smem + kBarBytes);
  const int n_units = n_rows * kUnitsPerRow;
  const size_t plane = (size_t)n_rows * kLanes;
  const int lane = threadIdx.x & 31;
  const int n_chunks = (n_tris + kChunkTris - 1) / kChunkTris;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (n_chunks <= 1) {
    // The table is resident: one copy, then every warp on its own.
    if (n_chunks == 1) stage(tab, bar, table, n_tris, 0);
    int unit = take(ask(work));
    while (unit < n_units) {
      const unsigned next = ask(work);
      const size_t i = (size_t)unit * 32 + lane;
      const bool lv = live[unit / kUnitsPerRow] != 0;
      Q q;
      q.begin(a, plane, i, lv);
      if (lv) q.sweep(tab, n_tris, 0);
      q.end(a, plane, i);
      unit = take(next);
    }
    work_counters::finish(work, kWarps);
    return;
  }

  // The table outgrows shared memory: a block's warps take kWarps units at
  // a time and sweep the chunks together, restaging each between barriers.
  const int n_groups = (n_units + kWarps - 1) / kWarps;
  uint32_t stages = 0;
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const int unit = g * kWarps + (threadIdx.x >> 5);
    const bool valid = unit < n_units;
    const size_t i = (size_t)unit * 32 + lane;
    const bool lv = valid && live[unit / kUnitsPerRow] != 0;
    Q q;
    if (valid) q.begin(a, plane, i, lv);
    bool done = !lv;
    for (int c = 0; c < n_chunks; ++c) {
      const int base = c * kChunkTris;
      const int n = min(kChunkTris, n_tris - base);
      __syncthreads();
      stage(tab, bar, table + (size_t)base * kTriF4, n, stages & 1u);
      ++stages;
      if (!done) done = q.sweep(tab, n, base);
    }
    if (valid) q.end(a, plane, i);
  }
}

// Launch dense_kernel<Q> on as many blocks as the card holds at once, at
// most one a kWarps units of work.
template <class Q>
int launch(const typename Q::Args& a, const void* live, const void* table,
           int n_rows, int n_tris, int which, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  const int n = min(max(n_tris, 0), kChunkTris);
  const size_t bytes = kBarBytes + (size_t)n * kTriBytes;
  int err = 0;
  const int blocks = work_counters::resident_blocks(
      dense_kernel<Q>, kThreads, bytes, kBarBytes + kChunkTris * kTriBytes, &err);
  if (err != 0) return err;
  unsigned* work = work_counters::stream_counters(stream, which, &err);
  if (err != 0) return err;
  const int groups = (n_rows * kUnitsPerRow + kWarps - 1) / kWarps;
  dense_kernel<Q><<<min(blocks, groups), kThreads, bytes,
                    (cudaStream_t)stream>>>(a, (const int32_t*)live,
                                            (const float4*)table, n_rows,
                                            n_tris, work);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes.  Each launches on `stream`,
// does not synchronise, and returns the first CUDA error: on a table
// size's first launch on a device the shared-memory opt-in and the
// occupancy query (work_counters.cuh), on a stream's first launch the
// counters' allocation, then cudaGetLastError().
// `table` is the padded (T, 12) copy, 16-byte aligned.
extern "C" {

int closest_dense_launch(const void* live, const void* o3, const void* d3,
                         const void* table, const void* attrs, int n_rows,
                         int n_tris, void* t_out, void* id_out, void* u_out,
                         void* v_out, void* attr_out, void* stream) {
  const ClosestArgs a{(const float*)o3,    (const float*)d3,
                      (const float*)attrs, (float*)t_out,
                      (int32_t*)id_out,    (float*)u_out,
                      (float*)v_out,       (float*)attr_out};
  return launch<Closest>(a, live, table, n_rows, n_tris, 0, stream);
}

int any_dense_launch(const void* live, const void* o3, const void* d3,
                     const void* tmax, const void* excl, const void* table,
                     int n_rows, int n_tris, void* occ_out, void* stream) {
  const AnyArgs a{(const float*)o3, (const float*)d3, (const float*)tmax,
                  (const int32_t*)excl, (uint8_t*)occ_out};
  return launch<Any>(a, live, table, n_rows, n_tris, 1, stream);
}

const char* intersect_dense_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
