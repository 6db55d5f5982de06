// B1 and B2, the threaded-BVH walks, for Hopper (sm_90a).
//
// Replace the JAX package's lock-step wavefront loops
// chiaroscuro_tpu/accel/bvh.py:362 bvh_closest (B1) and :415 bvh_any (B2),
// each a lax.while_loop over a ray wavefront (not Pallas kernels: the walk
// has no TPU kernel).  Torch has no device-side loop, so the plain torch
// version (accel/bvh.py) reads its loop condition back to the host and
// launches some forty small ops on every step.
//
// The walk (accel/bvh.py): node = 0; at node i the ray's slab test against
// the node's box (padded by BOX_PAD at the build, so that it holds every
// hit the test below reports), with tmax = the running best t (B1) or the
// ray's tmax (B2); on a box hit at a leaf, Moller-Trumbore (mt_core.cuh)
// against the leaf's count triangles in slot order; on a box hit at an
// internal node step to i + 1, otherwise jump to miss_link[i]; stop at -1
// or after `limit` steps (4 * n_nodes + 8).
//   B1: a hit replaces the running best where its t is smaller, or equal
//       with a smaller original id, so the answer is the least (t, id) of
//       the hits, whatever the walk order (the plain version's rule, and
//       K1's and K4's).  The ids are read only on an exact tie.  Outputs
//       hit (t finite), t (inf on a miss), the original id
//       (tri_order[slot]), u, v.
//   B2: stops at the first blocker: a hit at t < tmax whose original id is
//       not the ray's exclude id.  Output occluded.
// Optional per-ray counts: the steps walked and the leaf triangle tests
// (B2: up to and including its blocker), equal to the plain walk's.  The
// design below changes when a lane does its work, never which box and
// triangle tests each ray does in which order, so the outputs and counts
// equal the plain walk's bit for bit.
//
// What bounds it on an H100.  ~25 FP32 operations a box test and 54 a
// triangle test over the steps and leaf tests the rays' walks take (the BVH
// is read from L2 after first touch: 29 MB at the 481k atrium).  That is
// the per-lane bound.  A design of one thread a ray pays, in each warp, the
// longest of its 32 walks in steps and in tests: the per-warp bound, which
// tools/bvh_compare.py and chip_smoke.py print beside the per-lane one
// (their ratio, the SIMT efficiency, is 0.43-0.75 on the atrium frames'
// wavefronts).  Divergence explains only part of the gap: one thread a ray
// reached 9-19% of the per-warp bound, and the same rays in a random order
// took up to twice as long while their per-warp bound grew 1.4x.  Every
// step is a dependent load of the next node, from L1 or L2, and lanes of a
// warp that walk apart read different lines: latency and memory, not the
// FP32 rate, decide.  The design:
//   - Persistent warps with lane refill.  The grid is the card's resident
//     blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs).  A lane
//     whose walk ends stores its outputs and is idle; once at least
//     kRefillMin of a warp's lanes are idle, one lane takes that many new
//     rays from a per-stream device counter with one atomicAdd and the
//     idle lanes share them, so refilled lanes walk consecutive rays.  A
//     warp no longer waits for its longest walk: that is what the per-warp
//     bound charges.
//   - Leaf tests run converged.  Each lane steps over internal nodes until
//     it holds a leaf whose box it hit, or its walk ends; a lane holding a
//     leaf waits (its next box test must see the leaf's best t, B1), until
//     kHoldMin lanes hold one or none can step.  Then the warp runs the
//     held leaves' tests together, one loop over the slots k < the largest
//     count, each test issued once for every lane holding a k-th slot
//     (Aila and Laine's while-while traversal, without speculation, which
//     would change the counts).  The schedule is kHoldMin 8 and
//     kRefillMin 16 (swept: hold 1 lost 1.2-2.0x and 32 lost 5-13%;
//     refilling one lane at a time lost up to 9%, 8-24 within 6%).
//   - Occupancy: 128-thread blocks, kMinBlocks in __launch_bounds__ (48
//     registers, 1,280 threads an SM); nodes, leaf starts, triangles and
//     rays read through the read-only path (__ldg, 16 bytes a load for
//     nodes and triangles); B1 keeps the best hit's slot and reads
//     tri_order once, at the end.
//   - The slab test's NaN rule (below) with NaN-propagating min/max
//     (PTX min.NaN / max.NaN) instead of six isnan checks.
// Measured and removed (PERF.md, section 6): loading both successors of a
// node before its box test resolves (1.1-1.3x slower at 1,280 threads),
// the two lanes of a pair loading each node together and trading halves
// by shuffles (1.2-1.4x slower), the largest L1 carveout (4-7% slower),
// and sorting bounce rays by the integrator's spatial key before the walk
// (the sort and its gathers cost more than the walk).
//
// NaN.  An axis-parallel ray whose origin lies on a slab plane gives
// 0 * inf = NaN in the slab test.  torch.minimum/maximum propagate it and
// the box misses; fminf/fmaxf would drop it and the box would hit.  Here
// min.NaN/max.NaN propagate it into near and far, and far >= near is false.
//
// Layout.  A node is two float4, (bmin.xyz, miss_link bits) then
// (bmax.xyz, leaf_count bits), 32 bytes; leaf_start is read at leaves only.
// Triangles are the padded (T, 12) rows v0|0|e1|0|e2|0 in leaf order
// (BVHArrays.nodes and .tris, accel/bvh.py): three 16-byte loads a triangle.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (ops/cuda_build.py).  With
// -fmad=false and the plain version's operand order the outputs equal the
// plain torch walk bit for bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mt_core.cuh"
#include "work_counters.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Resident blocks an SM that __launch_bounds__ asks for: at most 64
// registers a thread (the walks take 48 and 47, so 10 blocks fit: 1,280
// threads).  12 (1,536 threads, 40 registers) spilled and ran 2-6% slower.
constexpr int kMinBlocks = 8;
// The walk's schedule (walk()): a warp's traversal round ends once kHoldMin
// of its lanes hold a leaf, and the warp takes new rays once kRefillMin of
// its lanes are idle.  It changes when a lane works, never an output or a
// count.
constexpr int kHoldMin = 8;
constexpr int kRefillMin = 16;

struct Bvh {
  const float4* nodes;
  const int* leaf_start;
  const float4* tris;
  const int* tri_order;
};

struct RayInv {
  mt::Ray r;
  float ix, iy, iz;
};

__device__ __forceinline__ RayInv load_ray(const float* __restrict__ origins,
                                           const float* __restrict__ dirs,
                                           size_t i) {
  RayInv q;
  q.r = mt::Ray{__ldg(origins + 3 * i), __ldg(origins + 3 * i + 1),
                __ldg(origins + 3 * i + 2), __ldg(dirs + 3 * i),
                __ldg(dirs + 3 * i + 1), __ldg(dirs + 3 * i + 2)};
  q.ix = 1.0f / q.r.dx;
  q.iy = 1.0f / q.r.dy;
  q.iz = 1.0f / q.r.dz;
  return q;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// accel/bvh.py::_box_hit, NaN-propagating (file header).
__device__ __forceinline__ bool box_hit(const RayInv& q, const float4 lo,
                                        const float4 hi, float tmax) {
  const float t0x = (lo.x - q.r.ox) * q.ix, t1x = (hi.x - q.r.ox) * q.ix;
  const float t0y = (lo.y - q.r.oy) * q.iy, t1y = (hi.y - q.r.oy) * q.iy;
  const float t0z = (lo.z - q.r.oz) * q.iz, t1z = (hi.z - q.r.oz) * q.iz;
  const float near = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)),
                             min_nan(t0z, t1z));
  const float far = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)),
                            max_nan(t0z, t1z));
  return far >= near && far >= 0.0f && near < tmax;
}

// The test of the triangle in slot s: t, u, v and whether it accepts
// (without the t limit).  __frcp_rn gives the division's bits
// (mt_core.cuh).
__device__ __forceinline__ bool tri_test(const mt::Ray& r,
                                         const float4* __restrict__ tris,
                                         int s, float& t, float& u,
                                         float& v) {
  const float4* p = tris + 3 * (size_t)s;
  const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
  const mt::Tri tri{a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z};
  const mt::Front h = mt::mt_front<true>(r, tri);
  u = h.u;
  return mt::mt_back(r, tri, h, t, v);
}

struct ClosestArgs {
  const float* origins;
  const float* dirs;
  bool* hit;
  float* t;
  int* id;
  float* u;
  float* v;
  int* steps;
  int* tests;
};

struct AnyArgs {
  const float* origins;
  const float* dirs;
  const float* tmax;
  const int* excl;
  bool* occluded;
  int* steps;
  int* tests;
};

// B1's ray: the running best hit, by slot (its id read at a tie and at the end).
struct Closest {
  using Args = ClosestArgs;
  float bt, bu, bv;
  int slot;

  __device__ __forceinline__ void begin(const Args&, size_t) {
    bt = INFINITY;
    bu = bv = 0.0f;
    slot = -1;
  }
  __device__ __forceinline__ float tmax() const { return bt; }
  __device__ __forceinline__ bool done() const { return false; }
  __device__ __forceinline__ void test(const Bvh& b, const mt::Ray& r, int s) {
    float t, u, v;
    if (tri_test(r, b.tris, s, t, u, v) &&
        (t < bt || (t == bt && slot >= 0 &&
                    __ldg(b.tri_order + s) < __ldg(b.tri_order + slot)))) {
      bt = t;
      bu = u;
      bv = v;
      slot = s;
    }
  }
  __device__ __forceinline__ void end(const Args& a, const Bvh& b, size_t i) {
    a.hit[i] = isfinite(bt);
    a.t[i] = bt;
    a.id[i] = slot >= 0 ? __ldg(b.tri_order + slot) : 0;
    a.u[i] = bu;
    a.v[i] = bv;
  }
};

// B2's ray: its limit, exclusion and occlusion.
struct Any {
  using Args = AnyArgs;
  float tm;
  int ex;
  bool occ;

  __device__ __forceinline__ void begin(const Args& a, size_t i) {
    tm = __ldg(a.tmax + i);
    ex = __ldg(a.excl + i);
    occ = false;
  }
  __device__ __forceinline__ float tmax() const { return tm; }
  __device__ __forceinline__ bool done() const { return occ; }
  __device__ __forceinline__ void test(const Bvh& b, const mt::Ray& r, int s) {
    float t, u, v;
    occ = tri_test(r, b.tris, s, t, u, v) && t < tm && __ldg(b.tri_order + s) != ex;
  }
  __device__ __forceinline__ void end(const Args& a, const Bvh&, size_t i) {
    a.occluded[i] = occ;
  }
};

// The persistent walk of query kind Q over n_rays rays (file header).
template <class Q>
__device__ __forceinline__ void walk(const typename Q::Args& a, const Bvh& b,
                                     int n_rays, int limit, unsigned* work) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  bool more = true;        // warp-uniform: the counter may still hold rays
  int ray = -1;            // the lane's ray; -1 idle
  int node = 0, steps = 0, tests = 0;
  int lstart = 0, lcount = 0;   // the held leaf's first slot and count
  RayInv q;
  Q s;
  while (true) {
    // Refill: the idle lanes take consecutive rays, one atomic a warp.
    const unsigned idle = __ballot_sync(kFull, ray < 0);
    if (more && __popc(idle) >= kRefillMin) {
      const int n = __popc(idle);
      const int leader = __ffs(idle) - 1;
      unsigned base = 0;
      if (lane == leader) base = atomicAdd(work, (unsigned)n);
      base = __shfl_sync(kFull, base, leader);
      more = base + (unsigned)n < (unsigned)n_rays;
      if (ray < 0) {
        const unsigned r = base + __popc(idle & below);
        if (r < (unsigned)n_rays) {
          ray = (int)r;
          q = load_ray(a.origins, a.dirs, (size_t)r);
          s.begin(a, (size_t)r);
          node = 0;
          steps = 0;
          tests = 0;
        }
      }
    }
    if (__ballot_sync(kFull, ray >= 0) == 0) break;

    // Traverse: step over internal nodes until holding a leaf or ended.
    while (true) {
      const bool go = ray >= 0 && lcount == 0 && node != -1 && steps < limit;
      if (__ballot_sync(kFull, go) == 0) break;
      if (__popc(__ballot_sync(kFull, lcount > 0)) >= kHoldMin) break;
      if (go) {
        const float4 lo = __ldg(b.nodes + 2 * (size_t)node);
        const float4 hi = __ldg(b.nodes + 2 * (size_t)node + 1);
        const bool hit = box_hit(q, lo, hi, s.tmax());
        const int count = __float_as_int(hi.w);
        ++steps;
        if (hit && count > 0) {
          lstart = __ldg(b.leaf_start + node);
          lcount = count;
        }
        node = (hit && count == 0) ? node + 1 : __float_as_int(lo.w);
      }
    }

    // The held leaves' tests, converged: slot k of every holding lane.
    if (__ballot_sync(kFull, lcount > 0) != 0) {
      const int kmax = __reduce_max_sync(kFull, lcount);
      for (int k = 0; k < kmax; ++k) {
        if (k < lcount && !s.done()) {
          ++tests;
          s.test(b, q.r, lstart + k);
        }
      }
      lcount = 0;
    }

    // Retire the lanes whose walk ended.
    if (ray >= 0 && (node == -1 || steps >= limit || s.done())) {
      s.end(a, b, (size_t)ray);
      if (a.steps != nullptr) {
        a.steps[ray] = steps;
        a.tests[ray] = tests;
      }
      ray = -1;
    }
  }
  work_counters::finish(work, kWarps);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) bvh_closest_kernel(
    ClosestArgs a, Bvh b, int n_rays, int limit, unsigned* work) {
  walk<Closest>(a, b, n_rays, limit, work);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) bvh_any_kernel(
    AnyArgs a, Bvh b, int n_rays, int limit, unsigned* work) {
  walk<Any>(a, b, n_rays, limit, work);
}

// Launch `kernel` on as many blocks as the card holds at once, at most one
// a kThreads rays.
template <class K, class A>
int launch(K kernel, const A& a, const Bvh& b, int n_rays, long long limit,
           int which, void* stream) {
  if (n_rays <= 0) return (int)cudaGetLastError();
  int err = 0;
  const int blocks = work_counters::resident_blocks(kernel, kThreads, 0, 0, &err);
  if (err != 0) return err;
  unsigned* work = work_counters::stream_counters(stream, which, &err);
  if (err != 0) return err;
  const int lim = (int)(limit < INT_MAX ? limit : INT_MAX);
  const int grid = min(blocks, (n_rays + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, b, n_rays, lim, work);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch entry points (ctypes): pointers to contiguous device tensors and
// the stream as a cudaStream_t; each launches one kernel on the stream,
// allocates nothing but the stream's counters on its first launch, does not
// synchronise, and returns the first CUDA error.  nodes: (N, 8) f32 (two
// float4 a node, file header); leaf_start: (N,) int32; tris: (T_padded, 12)
// f32, 16-byte aligned; tri_order: (T_padded,) int32; origins, dirs: (R, 3)
// f32.  steps and tests may both be null (no counts).
extern "C" {

int bvh_closest_launch(const void* nodes, const void* leaf_start,
                       const void* tris, const void* tri_order,
                       const void* origins, const void* dirs, int n_rays,
                       long long limit, void* hit, void* t, void* id, void* u,
                       void* v, void* steps, void* tests, void* stream) {
  const ClosestArgs a{(const float*)origins, (const float*)dirs, (bool*)hit,
                      (float*)t, (int*)id, (float*)u, (float*)v, (int*)steps,
                      (int*)tests};
  const Bvh b{(const float4*)nodes, (const int*)leaf_start, (const float4*)tris,
              (const int*)tri_order};
  return launch(bvh_closest_kernel, a, b, n_rays, limit, 0, stream);
}

int bvh_any_launch(const void* nodes, const void* leaf_start, const void* tris,
                   const void* tri_order, const void* origins,
                   const void* dirs, const void* tmax, const void* excl,
                   int n_rays, long long limit, void* occluded, void* steps,
                   void* tests, void* stream) {
  const AnyArgs a{(const float*)origins, (const float*)dirs, (const float*)tmax,
                  (const int*)excl, (bool*)occluded, (int*)steps, (int*)tests};
  const Bvh b{(const float4*)nodes, (const int*)leaf_start, (const float4*)tris,
              (const int*)tri_order};
  return launch(bvh_any_kernel, a, b, n_rays, limit, 1, stream);
}

const char* bvh_traverse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
