// Moller-Trumbore ray-triangle test shared by the dense (intersect_dense.cu)
// and cluster (intersect_cluster.cu) kernels.
//
// The operand order is the JAX package's _mt_core (ops/intersect_pallas.py)
// and the port's plain torch version (ops/intersect_cuda.py::_mt_core).
// Every file including this header is built with -fmad=false, so each
// product and sum rounds on its own as torch's eager ops round them and the
// kernels equal their plain versions bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mt {

constexpr int kLanes = 128;     // rays per row (a cluster kernel's block)
constexpr int kAttrK = 32;      // attribute row width (ops/intersect_cuda.py ATTR_K)
constexpr float kBig = 3.0e38f;
constexpr float kFltEps = 1.1920928955078125e-07f;  // FLT_EPSILON

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Lane i of a planar (3, B0, 128) origin/direction pair; plane = B0 * 128.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ o3,
                                        const float* __restrict__ d3,
                                        size_t plane, size_t i) {
  return Ray{o3[i], o3[plane + i], o3[2 * plane + i],
             d3[i], d3[plane + i], d3[2 * plane + i]};
}

// One triangle's nine fields v0|e1|e2.
struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// The test up to u: p = cross(d, e2), a, the parallel test, f, s and u.
struct Front {
  float px, py, pz, f, sx, sy, sz, u;
  bool nonpar;
};

// kFrcp takes f = __frcp_rn(nonpar ? a : 1), the same correctly rounded bits
// as 1.0f / (nonpar ? a : 1), which nvcc compiles as the reciprocal of a
// selected afterwards, so that a == 0 takes the division's slow path
// (intersect_dense.cu); the cluster kernels keep the division.
template <bool kFrcp = false>
__device__ __forceinline__ Front mt_front(const Ray& r, const Tri& tri) {
  Front h;
  // p = cross(d, e2)
  h.px = r.dy * tri.e2z - r.dz * tri.e2y;
  h.py = r.dz * tri.e2x - r.dx * tri.e2z;
  h.pz = r.dx * tri.e2y - r.dy * tri.e2x;
  const float a = tri.e1x * h.px + tri.e1y * h.py + tri.e1z * h.pz;
  h.nonpar = fabsf(a) >= kFltEps;
  h.f = kFrcp ? __frcp_rn(h.nonpar ? a : 1.0f) : 1.0f / (h.nonpar ? a : 1.0f);
  h.sx = r.ox - tri.v0x;
  h.sy = r.oy - tri.v0y;
  h.sz = r.oz - tri.v0z;
  h.u = h.f * (h.sx * h.px + h.sy * h.py + h.sz * h.pz);
  return h;
}

// Whether u could still accept: the part of the acceptance test that
// mt_front's outputs decide.
__device__ __forceinline__ bool mt_u_ok(const Front& h) {
  return h.nonpar && h.u >= 0.0f && h.u <= 1.0f;
}

// The rest of the test after mt_front: q = cross(s, e1), v, t and the
// acceptance test.
__device__ __forceinline__ bool mt_back(const Ray& r, const Tri& tri,
                                        const Front& h, float& t, float& v) {
  const float qx = h.sy * tri.e1z - h.sz * tri.e1y;
  const float qy = h.sz * tri.e1x - h.sx * tri.e1z;
  const float qz = h.sx * tri.e1y - h.sy * tri.e1x;
  v = h.f * (r.dx * qx + r.dy * qy + r.dz * qz);
  t = h.f * (tri.e2x * qx + tri.e2y * qy + tri.e2z * qz);
  return mt_u_ok(h) && v >= 0.0f && h.u + v <= 1.0f && t >= 0.0f;
}

// The test on a triangle held in registers: mt_front, then mt_back.
__device__ __forceinline__ bool mt_test(const Ray& r, const Tri& tri,
                                        float& t, float& u, float& v) {
  const Front h = mt_front(r, tri);
  u = h.u;
  return mt_back(r, tri, h, t, v);
}

// One triangle from three 16-byte rows v0|e1|e2 (w unused): the dense
// kernels' padded table, three vector loads a triangle.
__device__ __forceinline__ Tri tri_from_rows(const float4* rows) {
  const float4 a = rows[0], b = rows[1], c = rows[2];
  return Tri{a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z};
}

// The winner's 32 attributes from the original-order (T, 32) table, written
// planar (32, B0, 128); zeros for a miss.  One 128-byte row load per thread
// (float4), coalesced planar stores across the row.
__device__ __forceinline__ void store_attrs(const float* __restrict__ attrs,
                                            bool hit, int id, size_t plane,
                                            size_t i,
                                            float* __restrict__ attr_out) {
  const float4* row_attrs =
      reinterpret_cast<const float4*>(attrs + (size_t)id * kAttrK);
#pragma unroll
  for (int q = 0; q < kAttrK / 4; ++q) {
    const float4 a = hit ? row_attrs[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    attr_out[(4 * q + 0) * plane + i] = a.x;
    attr_out[(4 * q + 1) * plane + i] = a.y;
    attr_out[(4 * q + 2) * plane + i] = a.z;
    attr_out[(4 * q + 3) * plane + i] = a.w;
  }
}

}  // namespace mt
