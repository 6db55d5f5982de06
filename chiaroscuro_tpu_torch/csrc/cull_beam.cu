// K3b, the conservative beam cull, for Hopper (sm_90a): sweep and lists
// in one kernel.
//
// Replaces chiaroscuro_tpu/ops/cluster_pallas.py::_cull_rows_beam (:294,
// XLA on the TPU, taken where beam=True): its sweep _rowhit_beam (:226) and
// its stable sort of the row's (key, id) pairs, _order_hits (:178).  Where
// K3 (csrc/cull_rows.cu) tests every lane of a 128-ray row against every
// box, K3b bounds the row once and tests the bounds by interval arithmetic.
// For every row b and cluster box k < K:
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
//   key = hit ? max(near_lo, 0) + 0.0 : BIG
//
// and then the row's lists from its keys and hit count, as _order_hits
// makes them (csrc/row_select.cuh): meta (B0, 2) [trip, overflow], ids and
// nears (B0, Le), cutoff (B0, 1).  The hit mask is a superset of K3's and
// the entry a lower bound on every lane's, up to the rounding of the
// arithmetic above (the JAX package's own test allows 1e-5 on the entry);
// the visits stay exact either way.
//
// Exactly the plain version (ops/cluster_cuda.py::cull_beam_plain: the
// sweep _rowhit_beam op for op, then the stable sort):
// - min and max propagate NaN (min.NaN / max.NaN), as torch.minimum and
//   jnp.minimum do, where fminf would drop it: a denormal direction bound
//   makes 1/D infinite and 0 x inf a NaN, which must then miss.
// - A non-definite axis is skipped (a branch uniform over the block): the
//   plain version's max(near_lo, -BIG) and min(far_hi, BIG) there leave any
//   value or NaN unchanged, since near_lo >= -BIG and far_hi <= BIG.
// - No multiply-add is contracted (-fmad=false), 1/D is an IEEE division,
//   and the key's + 0.0 turns -0.0 into +0.0, as K3's does.  A hit needs
//   near_lo <= far_hi <= BIG, so every key lies in [+0.0, BIG]: the order
//   that row_select.cuh relies on.
//
// Design.  One block a row: 512 threads where the row's keys allow two
// blocks an SM (the 3M atrium), 256 where they allow four (481k: more rows
// in flight hide the selection's barriers).  Seven warps reduce the row's
// 6 x 128 origin and direction components (and tmax) with butterfly
// shuffles into 13 bounds in shared memory, and every thread derives the
// row's constants from them.  The block then sweeps the boxes, thread t
// taking boxes t, t + 256 (or 512), ... (read from global memory, L1 and
// L2: the 24 K bytes of boxes are read by every row), and writes each key to
// shared memory (K x 4 bytes: 15 KB at the 481k atrium, 94 KB at the 3M
// one, two rows an SM) while it counts the hits, the zero keys and the
// BIG ones.  row_select::write_lists then picks the Le + 1 smallest pairs
// and writes the lists once.  No (B0, K) tensor is written.
//
// What bounds it on an H100.  Per (row, box) 28 FP32 operations a definite
// axis (4 sub, 8 mul, 16 min/max) and 5 after them (6 with tmax), so up to
// 89 (90), against the rays and boxes read once and the lists written once
// (B0 x (12 + 8 Le) bytes: 88.6 MB at B0 = 7,200 and Le = 1,536): at the
// 3M atrium (K = 23,436) at most 1.5e10 operations, 0.45 ms at 33.5 T op/s,
// against ~0.03 ms of bytes, so operations bound it; chip_smoke.py counts
// the operations this run's rows need.  The selection's integer work is
// not counted.
//
// The sweep-only kernel below (cull_beam_sweep_launch) is the two-step
// cull this kernel replaced, which wrote the (B0, K) keys for a stable
// torch.sort: chip_smoke.py times it beside this one; nothing else calls it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_select.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kHead = 256;             // bytes of block scalars before the scratch
constexpr float kBig = 3.0e38f;

// The sweep-only kernel's shape.
constexpr int kRows = 8;               // rows (warps) a block
constexpr int kSweepThreads = kRows * 32;
constexpr int kTile = 1024;            // boxes staged in shared memory at once

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

// The row's lane min and max of one component (128 floats at x), in every
// lane of the warp.
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

// A row's constants, from its 13 bounds: [o_lo, o_hi] x 3, [d_lo, d_hi]
// x 3, then [tmax_lo, tmax_hi].
struct RowBeam {
  bool definite[3];
  float o_lo[3], o_hi[3], q_lo[3], q_hi[3];
  float t_row;

  __device__ __forceinline__ explicit RowBeam(const float* b) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o_lo[a] = b[2 * a];
      o_hi[a] = b[2 * a + 1];
      const float d_lo = b[6 + 2 * a], d_hi = b[7 + 2 * a];
      definite[a] = d_lo > 0.0f || d_hi < 0.0f;
      const float i_lo = 1.0f / (definite[a] ? d_lo : 1.0f);
      const float i_hi = 1.0f / (definite[a] ? d_hi : 1.0f);
      q_lo[a] = min_nan(i_lo, i_hi);
      q_hi[a] = max_nan(i_lo, i_hi);
    }
    t_row = b[13];
  }

  // Box (lo, hi) -> its key: max(near_lo, 0) + 0.0 where hit, else BIG.
  // lo(a) and hi(a) give the box's planes on axis a; only definite axes
  // read them.
  template <bool kTmax, class Lo, class Hi>
  __device__ __forceinline__ float key(Lo lo, Hi hi, bool& hit) const {
    float near_lo = -kBig, far_hi = kBig;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (!definite[a]) continue;
      const float2 tn = t_interval(lo(a), o_lo[a], o_hi[a], q_lo[a], q_hi[a]);
      const float2 tf = t_interval(hi(a), o_lo[a], o_hi[a], q_lo[a], q_hi[a]);
      near_lo = max_nan(near_lo, min_nan(tn.x, tf.x));
      far_hi = min_nan(far_hi, max_nan(tn.y, tf.y));
    }
    hit = far_hi >= near_lo && far_hi >= 0.0f;
    if (kTmax) hit = hit && near_lo <= t_row;
    return hit ? __fadd_rn(fmaxf(near_lo, 0.0f), 0.0f) : kBig;
  }
};

// Block scalars at the start of the dynamic shared memory.
struct Shared {
  row_select::Header sel;
  uint32_t count;                      // the row's hit boxes
  float bounds[14];                    // RowBeam's 13 (and one spare)
};
static_assert(sizeof(Shared) <= kHead, "block scalars outgrow their room");

// One row a block of kThreads: 512 where the row's keys allow two blocks an
// SM (K = 23,436), 256 where they allow four or more (K = 3,760).
template <bool kTmax, int kThreads>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
    cull_beam_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
                     const float* __restrict__ tmax, const float* __restrict__ bmin,
                     const float* __restrict__ bmax, int n_rows, int n_boxes, int le,
                     int scratch_bytes, int32_t* __restrict__ meta,
                     int32_t* __restrict__ ids, float* __restrict__ nears,
                     float* __restrict__ cutoff) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared* s = reinterpret_cast<Shared*>(smem);
  uint32_t* scratch = reinterpret_cast<uint32_t*>(smem + kHead);
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem + kHead + scratch_bytes);

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int row = blockIdx.x;
  const size_t plane = (size_t)n_rows * kLanes, base = (size_t)row * kLanes;

  if (t == 0) {
    s->sel.n_big = s->sel.n_zero = s->sel.n_sel = 0;
    s->count = 0;
    if (!kTmax) s->bounds[12] = s->bounds[13] = 0.0f;
  }
  if (warp < (kTmax ? 7 : 6)) {
    const float* x = warp < 3 ? o3 + warp * plane : warp < 6 ? d3 + (warp - 3) * plane : tmax;
    float lo, hi;
    row_bounds(x + base, lane, lo, hi);
    if (lane == 0) {
      s->bounds[2 * warp] = lo;
      s->bounds[2 * warp + 1] = hi;
    }
  }
  __syncthreads();
  const RowBeam beam(s->bounds);

  uint32_t n_hit = 0;
  row_select::Tally tally;
  for (int j = t; j < n_boxes; j += kThreads) {
    const float* lo = bmin + 3 * (size_t)j;
    const float* hi = bmax + 3 * (size_t)j;
    bool hit;
    const uint32_t v = __float_as_uint(beam.key<kTmax>([&](int a) { return __ldg(lo + a); },
                                                       [&](int a) { return __ldg(hi + a); }, hit));
    keys[j] = v;
    n_hit += hit;
    row_select::tally_key(v, tally);
  }
  n_hit = __reduce_add_sync(0xffffffffu, n_hit);
  if (lane == 0 && n_hit) atomicAdd(&s->count, n_hit);
  row_select::add_tally(&s->sel, tally, lane);
  __syncthreads();

  row_select::write_lists<kThreads>(keys, n_boxes, le, s->count, scratch, &s->sel,
                                    ids + (size_t)row * le, nears + (size_t)row * le,
                                    meta + 2 * (size_t)row, cutoff + row);
}

// The two-step cull's sweep: the (B0, K) keys and counts, 8 rows a block
// sharing each staged tile of boxes, one warp a row.
template <bool kTmax>
__global__ void __launch_bounds__(kSweepThreads)
    cull_beam_sweep_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
                           const float* __restrict__ tmax, const float* __restrict__ bmin,
                           const float* __restrict__ bmax, int n_rows, int n_boxes,
                           float* __restrict__ key, int32_t* __restrict__ count) {
  __shared__ float lo_s[3][kTile];
  __shared__ float hi_s[3][kTile];
  __shared__ float bounds_s[kRows][14];

  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int row = blockIdx.x * kRows + warp;
  const bool live = row < n_rows;      // a warp past the last row only stages
  const size_t plane = (size_t)n_rows * kLanes;
  const size_t base = (size_t)row * kLanes;
  if (live) {
    for (int c = 0; c < (kTmax ? 7 : 6); ++c) {
      const float* x = c < 3 ? o3 + c * plane : c < 6 ? d3 + (c - 3) * plane : tmax;
      float lo, hi;
      row_bounds(x + base, lane, lo, hi);
      bounds_s[warp][2 * c] = lo;
      bounds_s[warp][2 * c + 1] = hi;
    }
    if (!kTmax) bounds_s[warp][13] = 0.0f;
  }
  __syncwarp();
  const RowBeam beam(bounds_s[warp]);

  float* key_row = key + (size_t)(live ? row : 0) * n_boxes;
  uint32_t n_hit = 0;
  for (int tile = 0; tile < n_boxes; tile += kTile) {
    const int n = min(kTile, n_boxes - tile);
    __syncthreads();  // the previous tile's boxes are no longer read
    for (int i = t; i < n * 3; i += kSweepThreads) {
      lo_s[i % 3][i / 3] = bmin[(size_t)tile * 3 + i];
      hi_s[i % 3][i / 3] = bmax[(size_t)tile * 3 + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = lane; j < n; j += 32) {
      bool hit;
      key_row[tile + j] = beam.key<kTmax>([&](int a) { return lo_s[a][j]; },
                                          [&](int a) { return hi_s[a][j]; }, hit);
      n_hit += hit;
    }
  }
  if (live) {
    n_hit = __reduce_add_sync(0xffffffffu, n_hit);
    if (lane == 0) count[row] = (int32_t)n_hit;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes.  A launch runs on `stream`,
// allocates nothing, does not synchronise, and returns a CUDA error code.
// tmax may be null (no limit); o3, d3 are (3, n_rows, 128), tmax
// (n_rows, 128), bmin and bmax (K, 3) f32, contiguous (the wrapper checks
// it).
extern "C" {

// Dynamic shared memory of a cull_beam_launch block: the block scalars,
// the select's scratch and the row's K keys.
int cull_beam_smem_bytes(int n_boxes, int le) {
  return kHead + (int)row_select::scratch_bytes(n_boxes, le) + 4 * n_boxes;
}

// The most dynamic shared memory a block of the current device may take.
int cull_beam_smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  return bytes;
}

// The lists: meta (n_rows, 2) int32, ids and nears (n_rows, le) int32 and
// f32, cutoff (n_rows, 1) f32; 1 <= le <= n_boxes.
int cull_beam_launch(const void* o3, const void* d3, const void* tmax, const void* bmin,
                     const void* bmax, int n_rows, int n_boxes, int le, void* meta,
                     void* ids, void* nears, void* cutoff, void* stream) {
  if (n_rows > 0 && n_boxes > 0) {
    if (le < 1 || le > n_boxes) return (int)cudaErrorInvalidValue;
    const int scratch = (int)row_select::scratch_bytes(n_boxes, le);
    const int bytes = cull_beam_smem_bytes(n_boxes, le);
    int dev = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err != cudaSuccess) return (int)err;
    // Four blocks of 256 where the keys leave room for them (each block
    // also holds 1 KB the card reserves), else two of 512.
    const bool narrow = 4 * (bytes + 1024) <= per_sm;
    void (*kernel)(const float*, const float*, const float*, const float*, const float*, int,
                   int, int, int, int32_t*, int32_t*, float*, float*) =
        tmax != nullptr ? (narrow ? cull_beam_kernel<true, 256> : cull_beam_kernel<true, 512>)
                        : (narrow ? cull_beam_kernel<false, 256> : cull_beam_kernel<false, 512>);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<n_rows, narrow ? 256 : 512, bytes, (cudaStream_t)stream>>>(
        (const float*)o3, (const float*)d3, (const float*)tmax, (const float*)bmin,
        (const float*)bmax, n_rows, n_boxes, le, scratch, (int32_t*)meta, (int32_t*)ids,
        (float*)nears, (float*)cutoff);
  }
  return (int)cudaGetLastError();
}

// The two-step cull's sweep: key (n_rows, K) f32 and count (n_rows,) int32.
int cull_beam_sweep_launch(const void* o3, const void* d3, const void* tmax,
                           const void* bmin, const void* bmax, int n_rows, int n_boxes,
                           void* key, void* count, void* stream) {
  if (n_rows > 0 && n_boxes > 0) {
    const int blocks = (n_rows + kRows - 1) / kRows;
    const auto kernel = tmax != nullptr ? &cull_beam_sweep_kernel<true>
                                        : &cull_beam_sweep_kernel<false>;
    kernel<<<blocks, kSweepThreads, 0, (cudaStream_t)stream>>>(
        (const float*)o3, (const float*)d3, (const float*)tmax, (const float*)bmin,
        (const float*)bmax, n_rows, n_boxes, (float*)key, (int32_t*)count);
  }
  return (int)cudaGetLastError();
}

const char* cull_beam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
