// K3b, the conservative beam cull's sweep, for Hopper (sm_90a).
//
// Replaces chiaroscuro_tpu/ops/cluster_pallas.py::_rowhit_beam (:226, an XLA
// pass on the TPU, taken by _cull_rows_beam :294 where beam=True).  Where
// K3 (csrc/cull_rows.cu) tests every lane of a 128-ray row against every
// box, K3b bounds the row once and tests the bounds by interval
// arithmetic.  For every row b and cluster box k < K:
//
//   per axis a: O_lo, O_hi, D_lo, D_hi = the row's lane min/max of origin
//     and direction; the axis is "definite" where D_lo > 0 or D_hi < 0
//     (a row whose directions span 0 on an axis learns nothing from it)
//   q_lo, q_hi = min/max of 1 / D_lo and 1 / D_hi
//   for each plane p of the box on the axis, [p - O_hi, p - O_lo] x
//     [q_lo, q_hi] by the min and max of the four endpoint products
//   near_lo = max over definite axes of the min over both planes, from
//     -BIG; far_hi = min over definite axes of the max, from BIG
//   hit = far_hi >= near_lo and far_hi >= 0 [and near_lo <= the row's
//     largest tmax]
//
// and writes key[b, k] = hit ? max(near_lo, 0) + 0.0 : BIG and count[b] =
// the row's hit boxes: cull_sweep's contract, so the stable sort and the
// lists (ops/cluster_cuda.py::_order_hits) serve both culls.  The hit mask
// is a superset of K3's and the entry a lower bound on every lane's, up to
// the rounding of the arithmetic above (the JAX package's own test allows
// 1e-5 on the entry); the visits stay exact either way.
//
// Exactly the plain version (ops/cluster_cuda.py::cull_beam_sweep_plain,
// _rowhit_beam op for op):
// - min and max propagate NaN (min.NaN / max.NaN), as torch.minimum and
//   jnp.minimum do, where fminf would drop it: a denormal direction bound
//   makes 1/D infinite and 0 x inf a NaN, which must then miss.
// - A non-definite axis is skipped (a branch uniform over the warp): the
//   plain version's max(near_lo, -BIG) and min(far_hi, BIG) there leave any
//   value or NaN unchanged, since near_lo >= -BIG and far_hi <= BIG.
// - No multiply-add is contracted (-fmad=false), 1/D is an IEEE division,
//   and the entry's + 0.0 turns -0.0 into +0.0, as K3's does (the card's
//   radix sort orders -0.0 before +0.0).
//
// Design.  A block of 8 warps takes 8 rows, one a warp.  Each warp reads
// its row's 6 x 128 origin and direction components (four coalesced loads
// a component) and reduces the 12 bounds (13 with tmax) with butterfly
// shuffles, so every lane holds the row's constants.  The block then
// sweeps the boxes in tiles of kTile staged in shared memory (K is 23,436
// at the 3M atrium: the boxes do not fit at once); in a tile each lane
// takes every 32nd box, so a warp's 32 keys go out as one 128-byte store.
//
// What bounds it on an H100.  Per (row, box) 28 FP32 operations a definite
// axis (4 sub, 8 mul, 16 min/max) and 5 after them (6 with tmax), so up to
// 89 (90); and the (B0, K) keys, 4 bytes a pair, written once: at the 3M
// atrium (B0 = 7,200, K = 23,436) 675 MB, 0.20 ms at 3.35 TB/s, against at
// most 1.5e10 operations, 0.45 ms at 33.5 T op/s.  Operations bound it
// where rows have definite axes; chip_smoke.py counts the operations this
// run's rows need.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 8;               // rows (warps) a block
constexpr int kThreads = kRows * 32;
constexpr int kTile = 1024;            // boxes staged in shared memory at once
constexpr float kBig = 3.0e38f;

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

// The row's lane min and max of one component (plane `c` of a planar
// (3, n_rows, 128) tensor), in every lane of the warp.
__device__ __forceinline__ void row_bounds(const float* __restrict__ x,
                                           int lane, float& lo, float& hi) {
  lo = x[lane];
  hi = lo;
#pragma unroll
  for (int i = 1; i < kLanes / 32; ++i) {
    const float v = x[lane + 32 * i];
    lo = min_nan(lo, v);
    hi = max_nan(hi, v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// The interval [p - o_hi, p - o_lo] x [q_lo, q_hi]: (min, max) of the four
// endpoint products, in _rowhit_beam's order.
__device__ __forceinline__ float2 t_interval(float p, float o_lo, float o_hi,
                                             float q_lo, float q_hi) {
  const float p_lo = p - o_hi, p_hi = p - o_lo;
  const float t1 = p_lo * q_lo, t2 = p_lo * q_hi;
  const float t3 = p_hi * q_lo, t4 = p_hi * q_hi;
  return make_float2(min_nan(min_nan(t1, t2), min_nan(t3, t4)),
                     max_nan(max_nan(t1, t2), max_nan(t3, t4)));
}

template <bool kTmax>
__global__ void __launch_bounds__(kThreads)
    cull_beam_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
                     const float* __restrict__ tmax,
                     const float* __restrict__ bmin,
                     const float* __restrict__ bmax, int n_rows, int n_boxes,
                     float* __restrict__ key, int32_t* __restrict__ count) {
  __shared__ float lo_s[3][kTile];
  __shared__ float hi_s[3][kTile];

  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int row = blockIdx.x * kRows + warp;
  const bool live = row < n_rows;      // a warp past the last row only stages
  const size_t plane = (size_t)n_rows * kLanes;
  const size_t base = (size_t)row * kLanes;

  bool definite[3];
  float o_lo[3], o_hi[3], q_lo[3], q_hi[3];
  float t_row = 0.0f;
  if (live) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float d_lo, d_hi;
      row_bounds(o3 + a * plane + base, lane, o_lo[a], o_hi[a]);
      row_bounds(d3 + a * plane + base, lane, d_lo, d_hi);
      definite[a] = d_lo > 0.0f || d_hi < 0.0f;
      const float i_lo = 1.0f / (definite[a] ? d_lo : 1.0f);
      const float i_hi = 1.0f / (definite[a] ? d_hi : 1.0f);
      q_lo[a] = min_nan(i_lo, i_hi);
      q_hi[a] = max_nan(i_lo, i_hi);
    }
    if (kTmax) {
      float unused;
      row_bounds(tmax + base, lane, unused, t_row);
    }
  }

  float* key_row = key + (size_t)(live ? row : 0) * n_boxes;
  uint32_t n_hit = 0;
  for (int tile = 0; tile < n_boxes; tile += kTile) {
    const int n = min(kTile, n_boxes - tile);
    __syncthreads();  // the previous tile's boxes are no longer read
    for (int i = t; i < n * 3; i += kThreads) {
      lo_s[i % 3][i / 3] = bmin[(size_t)tile * 3 + i];
      hi_s[i % 3][i / 3] = bmax[(size_t)tile * 3 + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = lane; j < n; j += 32) {
      float near_lo = -kBig, far_hi = kBig;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        if (!definite[a]) continue;
        const float2 tn = t_interval(lo_s[a][j], o_lo[a], o_hi[a], q_lo[a], q_hi[a]);
        const float2 tf = t_interval(hi_s[a][j], o_lo[a], o_hi[a], q_lo[a], q_hi[a]);
        near_lo = max_nan(near_lo, min_nan(tn.x, tf.x));
        far_hi = min_nan(far_hi, max_nan(tn.y, tf.y));
      }
      bool hit = far_hi >= near_lo && far_hi >= 0.0f;
      if (kTmax) hit = hit && near_lo <= t_row;
      key_row[tile + j] = hit ? __fadd_rn(fmaxf(near_lo, 0.0f), 0.0f) : kBig;
      n_hit += hit;
    }
  }
  if (live) {
    n_hit = __reduce_add_sync(0xffffffffu, n_hit);
    if (lane == 0) count[row] = (int32_t)n_hit;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes.  The launch runs on `stream`,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
// tmax may be null (no limit); o3, d3 are (3, n_rows, 128), tmax
// (n_rows, 128), bmin and bmax (K, 3) f32, contiguous (the wrapper checks
// it); key is (n_rows, K) f32 and count (n_rows,) int32.
extern "C" {

int cull_beam_launch(const void* o3, const void* d3, const void* tmax,
                     const void* bmin, const void* bmax, int n_rows,
                     int n_boxes, void* key, void* count, void* stream) {
  if (n_rows > 0 && n_boxes > 0) {
    const int blocks = (n_rows + kRows - 1) / kRows;
    if (tmax != nullptr) {
      cull_beam_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const float*)o3, (const float*)d3, (const float*)tmax,
          (const float*)bmin, (const float*)bmax, n_rows, n_boxes,
          (float*)key, (int32_t*)count);
    } else {
      cull_beam_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const float*)o3, (const float*)d3, nullptr, (const float*)bmin,
          (const float*)bmax, n_rows, n_boxes, (float*)key, (int32_t*)count);
    }
  }
  return (int)cudaGetLastError();
}

const char* cull_beam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
