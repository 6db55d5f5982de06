// X1, the row-hit cull, for Hopper (sm_90a).
//
// Replaces tools/tpu_cull_experiments.py::_cull_kernel (launched by
// _cull_rowhit_call), the Pallas cull that the JAX package measured and
// kept out of its hot path.  For every 128-ray row b and every packed box j
// it writes out[b, j] = 1.0 where any lane of the row passes the slab test
// against box j, else 0.0:
//
//   inv = clamped 1/d per axis, computed here from d (_cull_kernel :68-76)
//   t0, t1 = (bmin - o) * inv, (bmax - o) * inv          per axis x, y, z
//   near = max over axes of min(t0, t1), far = min over axes of max(t0, t1)
//   hit = far >= near and far >= 0 [and near <= tmax]
//
// Boxes are the packed (KB, 8) rows [bmin xyz | bmax xyz | pad pad] of
// pack_cull_boxes, KB a multiple of 128; padded rows hold inverted boxes
// (BIG, -BIG), which min/max turn back into the infinite box, so padded
// columns read 1.0 in every row, as on the TPU (callers slice [:, :K]).
// There is no entry distance and no list: that is the cull K3's work.
//
// Design.  One block of 128 threads per row, one thread per lane, holding
// the lane's origin, its clamped reciprocals and (kTmax) its limit in
// registers.  The boxes pass through shared memory 128 at a time (4 KB,
// two float4 loads a thread); every thread reads the same box at once (a
// broadcast).  Per box, the warp's any-lane answer is one __any_sync; each
// warp packs 32 answers into one word, the four warps' words are combined
// after the chunk, and thread t writes the chunk's output column t: one
// coalesced run of 128 floats per chunk.  Two barriers per chunk: one
// before the boxes are read, one before the words are combined (the next
// chunk's words are written only after its first barrier).
//
// What bounds it on an H100.  ~26 FP32 operations per (lane, box) pair (28
// with tmax), one vote per warp and box, and 4 bytes written per (row,
// box): at the 1280x720 atrium's primary wavefront (B0 = 7,200, KB =
// 3,840) 9.0e10 operations against 133 MB, so operations bound it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC.  The slab test has no multiply-add
// to contract and the reciprocal is an IEEE division, so the 0/1 output
// equals the plain torch version (tools/cull_experiments.py) exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;
constexpr int kChunk = 128;       // boxes per pass through shared memory
constexpr int kBoxW = 8;          // floats per packed box row
constexpr float kHugeInv = 1.0e30f;

// Clamped 1/d, sign kept, as _cull_kernel computes it: finite for
// axis-parallel rays, so no 0 * inf appears in the slab test.
__device__ __forceinline__ float clamped_inv(float d) {
  const float mag = fabsf(d);
  const float capped =
      mag * kHugeInv >= 1.0f ? 1.0f / (mag != 0.0f ? d : 1.0f) : kHugeInv;
  return d < 0.0f ? -fabsf(capped) : fabsf(capped);
}

template <bool kTmax>
__device__ __forceinline__ bool slab_hit(const float* b, float ox, float oy,
                                         float oz, float ix, float iy,
                                         float iz, float tm) {
  float t0 = (b[0] - ox) * ix;
  float t1 = (b[3] - ox) * ix;
  float near = fminf(t0, t1);
  float far = fmaxf(t0, t1);
  t0 = (b[1] - oy) * iy;
  t1 = (b[4] - oy) * iy;
  near = fmaxf(near, fminf(t0, t1));
  far = fminf(far, fmaxf(t0, t1));
  t0 = (b[2] - oz) * iz;
  t1 = (b[5] - oz) * iz;
  near = fmaxf(near, fminf(t0, t1));
  far = fminf(far, fmaxf(t0, t1));
  bool hit = (far >= near) & (far >= 0.0f);
  if (kTmax) hit = hit & (near <= tm);
  return hit;
}

template <bool kTmax>
__global__ void __launch_bounds__(kLanes)
    cull_rowhit_kernel(const float* __restrict__ o3,
                       const float* __restrict__ d3,
                       const float* __restrict__ tmax,
                       const float* __restrict__ boxes, int n_rows,
                       int n_boxes, float* __restrict__ out) {
  __shared__ float4 box4[kChunk * kBoxW / 4];
  __shared__ uint32_t words[kWarps][kChunk / 32];
  const float* box = reinterpret_cast<const float*>(box4);

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const size_t plane = (size_t)n_rows * kLanes;
  const size_t lane = (size_t)blockIdx.x * kLanes + t;
  const float ox = o3[lane], oy = o3[plane + lane], oz = o3[2 * plane + lane];
  const float ix = clamped_inv(d3[lane]);
  const float iy = clamped_inv(d3[plane + lane]);
  const float iz = clamped_inv(d3[2 * plane + lane]);
  const float tm = kTmax ? tmax[lane] : 0.0f;
  float* out_row = out + (size_t)blockIdx.x * n_boxes;

  for (int base = 0; base < n_boxes; base += kChunk) {
    const float4* src =
        reinterpret_cast<const float4*>(boxes + (size_t)base * kBoxW);
    box4[t] = src[t];
    box4[t + kLanes] = src[t + kLanes];
    __syncthreads();
#pragma unroll 1
    for (int g = 0; g < kChunk / 32; ++g) {
      uint32_t bits = 0;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const bool hit = slab_hit<kTmax>(box + (g * 32 + j) * kBoxW, ox, oy,
                                         oz, ix, iy, iz, tm);
        bits |= (uint32_t)__any_sync(0xffffffffu, hit) << j;
      }
      if ((t & 31) == 0) words[warp][g] = bits;
    }
    __syncthreads();
    const int g = t >> 5;
    const uint32_t any = words[0][g] | words[1][g] | words[2][g] | words[3][g];
    out_row[base + t] = (any >> (t & 31)) & 1u ? 1.0f : 0.0f;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes.  The launch runs on `stream`,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
// tmax may be null (no limit); n_boxes must be a multiple of 128 and boxes
// 16-byte aligned (the wrapper checks both).
extern "C" {

int cull_rowhit_launch(const void* o3, const void* d3, const void* tmax,
                       const void* boxes, int n_rows, int n_boxes, void* out,
                       void* stream) {
  if (n_rows > 0 && n_boxes > 0) {
    if (tmax != nullptr) {
      cull_rowhit_kernel<true><<<n_rows, kLanes, 0, (cudaStream_t)stream>>>(
          (const float*)o3, (const float*)d3, (const float*)tmax,
          (const float*)boxes, n_rows, n_boxes, (float*)out);
    } else {
      cull_rowhit_kernel<false><<<n_rows, kLanes, 0, (cudaStream_t)stream>>>(
          (const float*)o3, (const float*)d3, nullptr, (const float*)boxes,
          n_rows, n_boxes, (float*)out);
    }
  }
  return (int)cudaGetLastError();
}

const char* cull_rowhit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
