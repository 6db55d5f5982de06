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

constexpr int kLanes = 128;     // rays per row = threads per block
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

// The test on a triangle held in registers.
__device__ __forceinline__ bool mt_test(const Ray& r, const Tri& tri,
                                        float& t, float& u, float& v) {
  const float v0x = tri.v0x, v0y = tri.v0y, v0z = tri.v0z;
  const float e1x = tri.e1x, e1y = tri.e1y, e1z = tri.e1z;
  const float e2x = tri.e2x, e2y = tri.e2y, e2z = tri.e2z;
  // p = cross(d, e2)
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float a = e1x * px + e1y * py + e1z * pz;
  const bool nonpar = fabsf(a) >= kFltEps;
  const float f = 1.0f / (nonpar ? a : 1.0f);
  const float sx = r.ox - v0x;
  const float sy = r.oy - v0y;
  const float sz = r.oz - v0z;
  u = f * (sx * px + sy * py + sz * pz);
  // q = cross(s, e1)
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  t = f * (e2x * qx + e2y * qy + e2z * qz);
  return nonpar && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         t >= 0.0f;
}

// The test on a triangle whose nine fields lie `stride` floats apart in
// memory (the dense kernels' (T, 9) rows: 1).
__device__ __forceinline__ bool mt_hit(const Ray& r, const float* tri,
                                       int stride, float& t, float& u,
                                       float& v) {
  return mt_test(r,
                 Tri{tri[0 * stride], tri[1 * stride], tri[2 * stride],
                     tri[3 * stride], tri[4 * stride], tri[5 * stride],
                     tri[6 * stride], tri[7 * stride], tri[8 * stride]},
                 t, u, v);
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
