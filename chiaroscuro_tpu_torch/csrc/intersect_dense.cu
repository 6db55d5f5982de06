// Dense ray-triangle intersection kernels for Hopper (sm_90a).
//
// K1 closest_dense replaces chiaroscuro_tpu/ops/intersect_pallas.py::_closest_kernel
// and K2 any_dense replaces ::_any_kernel.  Both compute what the TPU kernels
// compute: Moller-Trumbore of every ray against every triangle, with the
// reference's epsilon and acceptance tests (_mt_core), the lowest id winning
// a tie in t, and sentinel outputs for rows the caller marks dead.
//
// Layout.  Rays arrive planar, (3, B0, 128) component-major, as everywhere in
// the port.  One block of 128 threads owns one 128-lane row, one thread per
// ray, so every load and store of a planar field is one coalesced 512-byte
// row.  A row whose `live` flag is 0 writes the sentinels (t = BIG, id = 0,
// u = v = 0, attributes 0; occluded = false) and returns: the TPU kernels'
// 8-row tile skip at row granularity.  Triangles (T, 9) = v0|e1|e2 are
// staged through shared memory kTile at a time, loaded cooperatively, and
// every thread reads the same triangle at once (a shared-memory broadcast).
// The running best lives in registers.
//
// K1 scans ids in ascending order with a strict `t < best` update, which is
// the lowest-id tie-break.  After the sweep each thread loads its winner's
// 32 attributes by direct index from the row-major (T, 32) table (one
// 128-byte row, where the TPU used a one-hot MXU matmul) and writes the
// planar (32, B0, 128) output, coalesced across the row.
// K2 runs the same sweep and stops at the first blocker; the block leaves
// the triangle loop once every ray of its row is occluded.
//
// What bounds it on an H100.  Per (ray, triangle) pair the test is ~40 FP32
// operations on shared-memory operands.  At Cornell's 36 triangles a launch
// does ~1 MFLOP per row and is bound by launch overhead and by K1's output
// stores (36 floats per ray, 85 MB for a 768x768 wavefront); nothing here
// is worth optimizing before the integrator around it.  At the 4,096
// triangles the dense path admits it is FP32-bound: the design keeps the
// triangle in shared memory and the ray and running best in registers, so
// the inner loop issues arithmetic only.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC.  -fmad=false keeps every product
// and sum rounded on its own, as torch's eager ops round them, and the
// operand order in mt_core.cuh is _mt_core's, so the kernels equal their plain torch
// versions (ops/intersect_cuda.py) bit for bit.  Contracting to FMA is
// later work that will have to bound id flips at near-ties.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt_core.cuh"

namespace {

using mt::kBig;
using mt::kLanes;
using mt::load_ray;
using mt::Ray;

constexpr int kTile = 256;      // triangles staged in shared memory per pass
constexpr int kTriStride = 9;   // v0 | e1 | e2

// Cooperative copy of triangles [base, base + n) into shared memory.
__device__ __forceinline__ void stage_tile(float* tile,
                                           const float* __restrict__ tris,
                                           int base, int n) {
  const float* src = tris + (size_t)base * kTriStride;
  for (int k = threadIdx.x; k < n * kTriStride; k += kLanes) tile[k] = src[k];
}

__global__ void __launch_bounds__(kLanes)
closest_dense_kernel(const int32_t* __restrict__ live,
                     const float* __restrict__ o3,
                     const float* __restrict__ d3,
                     const float* __restrict__ tris,
                     const float* __restrict__ attrs,
                     int n_rows, int n_tris,
                     float* __restrict__ t_out, int32_t* __restrict__ id_out,
                     float* __restrict__ u_out, float* __restrict__ v_out,
                     float* __restrict__ attr_out) {
  __shared__ float tile[kTile * kTriStride];
  const int row = blockIdx.x;
  const size_t plane = (size_t)n_rows * kLanes;
  const size_t i = (size_t)row * kLanes + threadIdx.x;

  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = 0;
  if (live[row] != 0) {  // uniform across the block
    const Ray r = load_ray(o3, d3, plane, i);
    for (int base = 0; base < n_tris; base += kTile) {
      const int n = min(kTile, n_tris - base);
      stage_tile(tile, tris, base, n);
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        float t, u, v;
        if (mt::mt_hit(r, &tile[j * kTriStride], 1, t, u, v) && t < best_t) {
          best_t = t;
          best_u = u;
          best_v = v;
          best_id = base + j;
        }
      }
      __syncthreads();
    }
  }
  t_out[i] = best_t;
  id_out[i] = best_id;
  u_out[i] = best_u;
  v_out[i] = best_v;

  mt::store_attrs(attrs, best_t < kBig, best_id, plane, i, attr_out);
}

__global__ void __launch_bounds__(kLanes)
any_dense_kernel(const int32_t* __restrict__ live,
                 const float* __restrict__ o3,
                 const float* __restrict__ d3,
                 const float* __restrict__ tmax,
                 const int32_t* __restrict__ excl,
                 const float* __restrict__ tris,
                 int n_rows, int n_tris,
                 uint8_t* __restrict__ occ_out) {
  __shared__ float tile[kTile * kTriStride];
  const int row = blockIdx.x;
  const size_t plane = (size_t)n_rows * kLanes;
  const size_t i = (size_t)row * kLanes + threadIdx.x;

  bool occ = false;
  if (live[row] != 0) {  // uniform across the block
    const Ray r = load_ray(o3, d3, plane, i);
    const float tm = tmax[i];
    const int ex = excl[i];
    for (int base = 0; base < n_tris; base += kTile) {
      const int n = min(kTile, n_tris - base);
      stage_tile(tile, tris, base, n);
      __syncthreads();
      for (int j = 0; j < n && !occ; ++j) {
        float t, u, v;
        occ = mt::mt_hit(r, &tile[j * kTriStride], 1, t, u, v) && t < tm &&
              base + j != ex;
      }
      // Barrier before the next tile overwrites shared memory; the whole
      // row leaves once every ray in it is occluded.
      if (__syncthreads_and(occ)) break;
    }
  }
  occ_out[i] = occ ? 1 : 0;
}

}  // namespace

// Plain C entry points, bound with ctypes.  Each launches on `stream`,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
extern "C" {

int closest_dense_launch(const void* live, const void* o3, const void* d3,
                         const void* tris, const void* attrs, int n_rows,
                         int n_tris, void* t_out, void* id_out, void* u_out,
                         void* v_out, void* attr_out, void* stream) {
  if (n_rows > 0) {
    closest_dense_kernel<<<n_rows, kLanes, 0, (cudaStream_t)stream>>>(
        (const int32_t*)live, (const float*)o3, (const float*)d3,
        (const float*)tris, (const float*)attrs, n_rows, n_tris,
        (float*)t_out, (int32_t*)id_out, (float*)u_out, (float*)v_out,
        (float*)attr_out);
  }
  return (int)cudaGetLastError();
}

int any_dense_launch(const void* live, const void* o3, const void* d3,
                     const void* tmax, const void* excl, const void* tris,
                     int n_rows, int n_tris, void* occ_out, void* stream) {
  if (n_rows > 0) {
    any_dense_kernel<<<n_rows, kLanes, 0, (cudaStream_t)stream>>>(
        (const int32_t*)live, (const float*)o3, (const float*)d3,
        (const float*)tmax, (const int32_t*)excl, (const float*)tris, n_rows,
        n_tris, (uint8_t*)occ_out);
  }
  return (int)cudaGetLastError();
}

const char* intersect_dense_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
