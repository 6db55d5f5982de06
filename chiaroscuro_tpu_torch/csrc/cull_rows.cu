// K3, the cluster cull's sweep, for Hopper (sm_90a).
//
// Replaces the per-lane slab sweep of chiaroscuro_tpu/ops/cluster_pallas.py::
// _cull_rows (:310, _rowhit_scan(with_near=True) :120, an XLA pass on the
// TPU).  For every 128-ray row b and cluster box k < K:
//
//   inv = clamped 1/d per axis, computed here from d (_safe_inv :107)
//   near = max over axes of the entry plane's t, far = min of the exit's
//   hit = far >= near and far >= 0 [and near <= tmax]
//   entry = min over the hitting lanes of max(near, 0), +0.0 for a zero
//
// and writes key[b, k] = hit ? min(entry, BIG) : BIG (the sort key of
// ops/cluster_cuda.py::_order_hits), count[b] = the row's hit boxes and,
// where asked, hit[b, k].  The stable sort and the lists stay torch ops, as
// they are lax.sort outside any kernel in the JAX package.
//
// Exactly the plain version (ops/cluster_cuda.py::_rowhit_scan):
// - Sign-chosen planes.  With the box's axis planes ordered lo <= hi, the
//   rounded fl(lo - o) * inv and fl(hi - o) * inv are ordered by the sign of
//   inv (rounding is monotone; inv is never 0 after the clamp), so the
//   plain version's min(t0, t1) is the entry plane's t and max the exit's.
//   Each box is staged per axis as [lo, hi, hi, lo]; a lane whose inv is
//   negative reads the pair at offset 2, so one 8-byte load gives it (entry,
//   exit) and the six per-axis min/max go.  The staging orders each axis
//   pair, so even an inverted box gives the plain version's answer.
// - far >= max(near, 0) is (far >= near and far >= 0): one compare.
// - The entry's bit pattern.  max(near, 0) + 0.0 is +0.0 for either zero
//   (a lane whose origin lies on a box plane has near = -0.0), and for
//   non-negative floats the unsigned bit patterns order as the values, so
//   a warp's entry is one __reduce_min_sync over hit ? bits : 0xffffffff;
//   all ones (a NaN pattern, above every non-negative float) means no lane
//   hit.  The four warps' words are combined after each chunk.
// - No multiply-add is contracted (-fmad=false) and the reciprocal is an
//   IEEE division, so every value is the plain version's to the bit.
//
// Design.  One block of 128 threads per row, one thread per lane, holding
// the lane's origin, clamped reciprocals, plane offsets and (kTmax) limit in
// registers.  Boxes come in chunks of 64: the next chunk's raw bmin/bmax
// rows are copied with cp.async (16 bytes a thread) while this chunk's slab
// tests run; after the wait, one thread per box stages it as above (boxes
// past K become the empty box, [+inf, -inf], which no lane hits).  Per box,
// every thread reads the same 48 bytes (two addresses a warp, apart in
// banks), and the warp's answer is one redux.sync; lane 0 stores it.  After
// the next barrier thread t combines column t of the four warps and writes
// a coalesced run of 64 keys.  Two barriers a chunk.
//
// What bounds it on an H100.  21 FP32 operations per (lane, box) pair (22
// with tmax): 6 sub and 6 mul, 4 for near and far, max(near, 0), the
// compare, the +0.0, the select and the lane minimum.  At the 1280x720
// atrium's primary wavefront (B0 = 7,200, K = 3,760) that is 7.3e10
// operations against 108 MB of keys written, so operations bound it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;
constexpr int kChunk = 64;             // boxes per pass through shared memory
constexpr int kRawFloats = kChunk * 3;  // one chunk of bmin (or of bmax)
constexpr int kPieces = kRawFloats / 4;  // its 16-byte copies
constexpr float kHugeInv = 1.0e30f;
constexpr float kBig = 3.0e38f;
constexpr uint32_t kMiss = 0xffffffffu;

// Clamped 1/d, sign kept (_safe_inv): finite for axis-parallel rays, so no
// 0 * inf appears in the slab test; never 0.
__device__ __forceinline__ float clamped_inv(float d) {
  const float mag = fabsf(d);
  const float capped =
      mag * kHugeInv >= 1.0f ? 1.0f / (mag != 0.0f ? d : 1.0f) : kHugeInv;
  return d < 0.0f ? -fabsf(capped) : fabsf(capped);
}

// Start copying chunk `base` (n boxes) of bmin and bmax into raw[0..1]:
// one 16-byte cp.async per thread, the chunk's tail zero-filled.  Commits a
// group on every thread.
__device__ __forceinline__ void stage_raw(float* raw, const float* bmin,
                                          const float* bmax, int base, int n) {
  const int t = threadIdx.x;
  const int which = t / kPieces;          // 0: bmin, 1: bmax
  const int piece = t - which * kPieces;
  const int left = n * 12 - piece * 16;   // bytes of the chunk from this piece
  if (which < 2 && left > 0) {
    const float* src = (which ? bmax : bmin) + (size_t)base * 3 + piece * 4;
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(
        raw + which * kRawFloats + piece * 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(left < 16 ? left : 16)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Box t of a landed raw chunk (n boxes) into its slab rows: per axis
// [lo, hi, hi, lo] with lo <= hi; past n the empty box.
__device__ __forceinline__ void stage_slab(float4* slab, const float* raw,
                                           int t, int n) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float lo = INFINITY, hi = -INFINITY;
    if (t < n) {
      const float mn = raw[t * 3 + a], mx = raw[kRawFloats + t * 3 + a];
      const bool swap = mn > mx;
      lo = swap ? mx : mn;
      hi = swap ? mn : mx;
    }
    slab[t * 3 + a] = make_float4(lo, hi, hi, lo);
  }
}

// Column t of the chunk at `base`: the four warps' words combined into the
// key, the hit flag and the running count.
__device__ __forceinline__ void write_column(
    uint32_t (*words)[kChunk], int t, int base, int n_boxes,
    float* __restrict__ key_row, uint8_t* __restrict__ hit_row,
    uint32_t& count) {
  const int k = base + t;
  if (k >= n_boxes) return;
  const uint32_t u =
      min(min(words[0][t], words[1][t]), min(words[2][t], words[3][t]));
  const bool hit = u != kMiss;
  key_row[k] = __uint_as_float(min(u, __float_as_uint(kBig)));
  if (hit_row != nullptr) hit_row[k] = hit;
  count += hit;
}

template <bool kTmax>
__global__ void __launch_bounds__(kLanes, 16)
    cull_rows_kernel(const float* __restrict__ o3,
                     const float* __restrict__ d3,
                     const float* __restrict__ tmax,
                     const float* __restrict__ bmin,
                     const float* __restrict__ bmax, int n_rows, int n_boxes,
                     float* __restrict__ key, int32_t* __restrict__ count,
                     uint8_t* __restrict__ hit) {
  __shared__ __align__(16) float raw[2][2 * kRawFloats];
  __shared__ __align__(16) float4 slab4[kChunk * 3];
  __shared__ uint32_t words[kWarps][kChunk];
  __shared__ uint32_t warp_count[kWarps];
  const float2* slab = reinterpret_cast<const float2*>(slab4);

  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const size_t plane = (size_t)n_rows * kLanes;
  const size_t ray = (size_t)blockIdx.x * kLanes + t;
  const float ox = o3[ray], oy = o3[plane + ray], oz = o3[2 * plane + ray];
  const float ix = clamped_inv(d3[ray]);
  const float iy = clamped_inv(d3[plane + ray]);
  const float iz = clamped_inv(d3[2 * plane + ray]);
  const float tm = kTmax ? tmax[ray] : 0.0f;
  // float2 index of the (entry, exit) pair of axis a in box 0.
  const int sx = ix < 0.0f ? 1 : 0;
  const int sy = iy < 0.0f ? 3 : 2;
  const int sz = iz < 0.0f ? 5 : 4;
  float* key_row = key + (size_t)blockIdx.x * n_boxes;
  uint8_t* hit_row = hit == nullptr ? nullptr : hit + (size_t)blockIdx.x * n_boxes;
  uint32_t n_hit = 0;

  const int n_chunks = (n_boxes + kChunk - 1) / kChunk;
  stage_raw(raw[0], bmin, bmax, 0, min(kChunk, n_boxes));
  for (int c = 0; c < n_chunks; ++c) {
    const int base = c * kChunk;
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; chunk c - 1's tests and words done
    if (t < kChunk) {
      if (c > 0)
        write_column(words, t, base - kChunk, n_boxes, key_row, hit_row, n_hit);
      stage_slab(slab4, raw[c & 1], t, min(kChunk, n_boxes - base));
    }
    if (c + 1 < n_chunks)
      stage_raw(raw[(c + 1) & 1], bmin, bmax, base + kChunk,
                min(kChunk, n_boxes - base - kChunk));
    __syncthreads();  // the slab rows are staged
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float2 px = slab[j * 6 + sx];
      const float2 py = slab[j * 6 + sy];
      const float2 pz = slab[j * 6 + sz];
      const float near =
          fmaxf(fmaxf((px.x - ox) * ix, (py.x - oy) * iy), (pz.x - oz) * iz);
      const float far =
          fminf(fminf((px.y - ox) * ix, (py.y - oy) * iy), (pz.y - oz) * iz);
      const float entry = fmaxf(near, 0.0f);
      bool lane_hit = far >= entry;
      if (kTmax) lane_hit = lane_hit & (near <= tm);
      const uint32_t bits =
          lane_hit ? __float_as_uint(__fadd_rn(entry, 0.0f)) : kMiss;
      const uint32_t m = __reduce_min_sync(0xffffffffu, bits);
      if (lane == 0) words[warp][j] = m;
    }
  }
  __syncthreads();
  if (t < kChunk)
    write_column(words, t, (n_chunks - 1) * kChunk, n_boxes, key_row, hit_row,
                 n_hit);
  n_hit = __reduce_add_sync(0xffffffffu, n_hit);
  if (lane == 0) warp_count[warp] = n_hit;
  __syncthreads();
  if (t == 0)
    count[blockIdx.x] =
        (int32_t)(warp_count[0] + warp_count[1] + warp_count[2] + warp_count[3]);
}

}  // namespace

// Plain C entry points, bound with ctypes.  The launch runs on `stream`,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
// tmax and hit may be null (no limit; no hit mask); bmin and bmax are (K, 3)
// f32, contiguous and 16-byte aligned (the wrapper checks it).
extern "C" {

int cull_rows_launch(const void* o3, const void* d3, const void* tmax,
                     const void* bmin, const void* bmax, int n_rows,
                     int n_boxes, void* key, void* count, void* hit,
                     void* stream) {
  if (n_rows > 0 && n_boxes > 0) {
    if (tmax != nullptr) {
      cull_rows_kernel<true><<<n_rows, kLanes, 0, (cudaStream_t)stream>>>(
          (const float*)o3, (const float*)d3, (const float*)tmax,
          (const float*)bmin, (const float*)bmax, n_rows, n_boxes,
          (float*)key, (int32_t*)count, (uint8_t*)hit);
    } else {
      cull_rows_kernel<false><<<n_rows, kLanes, 0, (cudaStream_t)stream>>>(
          (const float*)o3, (const float*)d3, nullptr, (const float*)bmin,
          (const float*)bmax, n_rows, n_boxes, (float*)key, (int32_t*)count,
          (uint8_t*)hit);
    }
  }
  return (int)cudaGetLastError();
}

const char* cull_rows_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
