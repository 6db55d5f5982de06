// B1 and B2, the threaded-BVH walks, for Hopper (sm_90a).
//
// Replace the JAX package's lock-step wavefront loops
// chiaroscuro_tpu/accel/bvh.py::bvh_closest (B1) and ::bvh_any (B2), each a
// lax.while_loop over a ray wavefront (not Pallas kernels: the walk has no
// TPU kernel).  Torch has no device-side loop, so the plain torch version
// (accel/bvh.py) reads its loop condition back to the host and launches
// some forty small ops on every step; a walk takes hundreds to thousands of
// steps.  Here one thread walks one ray to its end.
//
// The walk (accel/bvh.py): node = 0; at node i the ray's slab test against
// the node's box, with tmax = the running best t (B1) or the ray's tmax
// (B2); on a box hit at a leaf, Moller-Trumbore (mt_core.cuh) against the
// leaf's count triangles in slot order; on a box hit at an internal node
// step to i + 1, otherwise jump to miss_link[i]; stop at -1 or after
// `limit` steps (4 * n_nodes + 8).
//   B1: a hit must beat the running best strictly, so ties go to walk order
//       (the first minimum in slot order inside a leaf, the earlier leaf
//       across leaves), as the plain version's argmin and strict update do.
//       Outputs hit (t finite), t (inf on a miss), the original id
//       (tri_order[slot]), u, v.
//   B2: stops at the first blocker: a hit at t < tmax whose original id is
//       not the ray's exclude id.  Output occluded.
// Optional per-ray counts: the steps walked and the leaf triangle tests
// (B2: up to and including its blocker), equal to the plain walk's.
//
// NaN.  An axis-parallel ray whose origin lies on a slab plane gives
// 0 * inf = NaN in the slab test.  torch.minimum/maximum propagate it and
// the box misses; fminf/fmaxf would drop it and the box would hit, so the
// test rejects the box when any of its six slab distances is NaN.
//
// Layout.  A node is two float4, (bmin.xyz, miss_link bits) then
// (bmax.xyz, leaf_count bits), 32 bytes; leaf_start is read at leaves only.
// Triangles are the padded (T, 12) rows v0|0|e1|0|e2|0 in leaf order
// (BVHArrays.nodes and .tris, accel/bvh.py): three 16-byte loads a triangle.
//
// What bounds it on an H100.  ~25 FP32 operations a box test and 54 a
// triangle test (mt_core.cuh), over the steps and leaf tests the rays'
// walks take; the BVH itself is read from L2 after first touch (the 481k
// atrium's is ~37 MB).  So operations bound it, but the walk is divergent
// (lanes of a warp walk different nodes) and every step is a dependent
// global load: latency, not the FP32 rate, is its likely limit.  This is the
// simple design: one thread a ray, 128-thread blocks, no shared memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (ops/cuda_build.py).  With
// -fmad=false and the plain version's operand order the outputs equal the
// plain torch walk bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mt_core.cuh"

namespace {

constexpr int kThreads = 128;

struct RayInv {
  mt::Ray r;
  float ix, iy, iz;
};

__device__ __forceinline__ RayInv load_ray(const float* __restrict__ origins,
                                           const float* __restrict__ dirs,
                                           size_t i) {
  RayInv q;
  q.r = mt::Ray{origins[3 * i], origins[3 * i + 1], origins[3 * i + 2],
                dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2]};
  q.ix = 1.0f / q.r.dx;
  q.iy = 1.0f / q.r.dy;
  q.iz = 1.0f / q.r.dz;
  return q;
}

// accel/bvh.py::_box_hit, NaN-propagating (file header).
__device__ __forceinline__ bool box_hit(const RayInv& q, const float4 lo,
                                        const float4 hi, float tmax) {
  const float t0x = (lo.x - q.r.ox) * q.ix, t1x = (hi.x - q.r.ox) * q.ix;
  const float t0y = (lo.y - q.r.oy) * q.iy, t1y = (hi.y - q.r.oy) * q.iy;
  const float t0z = (lo.z - q.r.oz) * q.iz, t1z = (hi.z - q.r.oz) * q.iz;
  if (isnan(t0x) || isnan(t1x) || isnan(t0y) || isnan(t1y) || isnan(t0z) ||
      isnan(t1z)) {
    return false;
  }
  const float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return far >= near && far >= 0.0f && near < tmax;
}

// The test of the triangle in slot s: t, u, v and whether it accepts
// (without the t limit).  __frcp_rn gives the division's bits
// (mt_core.cuh).
__device__ __forceinline__ bool tri_test(const mt::Ray& r,
                                         const float4* __restrict__ tris,
                                         size_t s, float& t, float& u,
                                         float& v) {
  const mt::Tri tri = mt::tri_from_rows(tris + 3 * s);
  const mt::Front h = mt::mt_front<true>(r, tri);
  u = h.u;
  return mt::mt_back(r, tri, h, t, v);
}

__global__ void __launch_bounds__(kThreads) bvh_closest_kernel(
    const float4* __restrict__ nodes, const int* __restrict__ leaf_start,
    const float4* __restrict__ tris, const int* __restrict__ tri_order,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    int n_rays, long long limit, bool* __restrict__ hit_out,
    float* __restrict__ t_out, int* __restrict__ id_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ steps_out, int* __restrict__ tests_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const RayInv q = load_ray(origins, dirs, i);
  float best_t = INFINITY, best_u = 0.0f, best_v = 0.0f;
  int best_id = 0, tests = 0;
  int node = 0;
  long long step = 0;
  for (; step < limit && node != -1; ++step) {
    const float4 lo = nodes[2 * (size_t)node];
    const float4 hi = nodes[2 * (size_t)node + 1];
    const bool hit = box_hit(q, lo, hi, best_t);
    const int count = __float_as_int(hi.w);
    if (hit && count > 0) {
      const size_t start = (size_t)leaf_start[node];
      for (int k = 0; k < count; ++k) {
        float t, u, v;
        if (tri_test(q.r, tris, start + k, t, u, v) && t < best_t) {
          best_t = t;
          best_u = u;
          best_v = v;
          best_id = tri_order[start + k];
        }
      }
      tests += count;
    }
    node = (hit && count == 0) ? node + 1 : __float_as_int(lo.w);
  }
  const bool hit = isfinite(best_t);
  hit_out[i] = hit;
  t_out[i] = best_t;
  id_out[i] = best_id;
  u_out[i] = best_u;
  v_out[i] = best_v;
  if (steps_out != nullptr) {
    steps_out[i] = (int)step;
    tests_out[i] = tests;
  }
}

__global__ void __launch_bounds__(kThreads) bvh_any_kernel(
    const float4* __restrict__ nodes, const int* __restrict__ leaf_start,
    const float4* __restrict__ tris, const int* __restrict__ tri_order,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ tmax, const int* __restrict__ excl, int n_rays,
    long long limit, bool* __restrict__ occ_out, int* __restrict__ steps_out,
    int* __restrict__ tests_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const RayInv q = load_ray(origins, dirs, i);
  const float tm = tmax[i];
  const int ex = excl[i];
  bool occluded = false;
  int tests = 0;
  int node = 0;
  long long step = 0;
  for (; step < limit && node != -1; ++step) {
    const float4 lo = nodes[2 * (size_t)node];
    const float4 hi = nodes[2 * (size_t)node + 1];
    const bool hit = box_hit(q, lo, hi, tm);
    const int count = __float_as_int(hi.w);
    if (hit && count > 0) {
      const size_t start = (size_t)leaf_start[node];
      for (int k = 0; k < count; ++k) {
        float t, u, v;
        ++tests;
        if (tri_test(q.r, tris, start + k, t, u, v) && t < tm &&
            tri_order[start + k] != ex) {
          occluded = true;
          break;
        }
      }
    }
    node = occluded ? -1 : ((hit && count == 0) ? node + 1 : __float_as_int(lo.w));
  }
  occ_out[i] = occluded;
  if (steps_out != nullptr) {
    steps_out[i] = (int)step;
    tests_out[i] = tests;
  }
}

int blocks_for(int n_rays) { return (n_rays + kThreads - 1) / kThreads; }

}  // namespace

// Launch entry points (ctypes): pointers to contiguous device tensors and
// the stream as a cudaStream_t; each launches one kernel on the stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
// nodes: (N, 8) f32 (two float4 a node, file header); leaf_start: (N,)
// int32; tris: (T_padded, 12) f32, 16-byte aligned; tri_order:
// (T_padded,) int32; origins, dirs: (R, 3) f32.  steps and tests may both
// be null (no counts).
extern "C" {

int bvh_closest_launch(const void* nodes, const void* leaf_start,
                       const void* tris, const void* tri_order,
                       const void* origins, const void* dirs, int n_rays,
                       long long limit, void* hit, void* t, void* id, void* u,
                       void* v, void* steps, void* tests, void* stream) {
  if (n_rays > 0) {
    bvh_closest_kernel<<<blocks_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)nodes, (const int*)leaf_start, (const float4*)tris,
        (const int*)tri_order, (const float*)origins, (const float*)dirs, n_rays,
        limit, (bool*)hit, (float*)t, (int*)id, (float*)u, (float*)v,
        (int*)steps, (int*)tests);
  }
  return (int)cudaGetLastError();
}

int bvh_any_launch(const void* nodes, const void* leaf_start, const void* tris,
                   const void* tri_order, const void* origins, const void* dirs,
                   const void* tmax, const void* excl, int n_rays,
                   long long limit, void* occluded, void* steps, void* tests,
                   void* stream) {
  if (n_rays > 0) {
    bvh_any_kernel<<<blocks_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)nodes, (const int*)leaf_start, (const float4*)tris,
        (const int*)tri_order, (const float*)origins, (const float*)dirs,
        (const float*)tmax, (const int*)excl, n_rays, limit, (bool*)occluded,
        (int*)steps, (int*)tests);
  }
  return (int)cudaGetLastError();
}

const char* bvh_traverse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
