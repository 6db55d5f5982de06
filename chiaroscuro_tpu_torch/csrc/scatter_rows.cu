// The closest hit's backward row fetch, for Hopper (sm_90a): a sort-by-id
// segmented row sum,
//
//   out[id, w] = sum over the lanes l with tid[l] == id of ct[w, l],
//
// into a zeroed (T, W) table, from a planar (W, N) cotangent.
//
// Replaces no Pallas kernel.  The JAX package leaves this scatter-add to
// XLA: it is the VJP of the gathers `mat[:, tid]` of the cluster backward
// (cluster_pallas.py:1180) and of the dense backward above 2,048 triangles
// (intersect_pallas.py:464).  The port left it to ATen (the backward of
// `mat.T[tid]`, `index_put_(accumulate=True)`), whose kernel sorts the ids
// and then walks each id's lanes serially, one thread a column; every miss
// and every dead row of the wavefront keeps id 0, so one segment holds most
// of the lanes and 32 threads walked it one lane at a time: on an H100,
// 205-230 ms a call for the 262k inverse-rendering step's bounce
// wavefronts (921,600 lanes x 32 columns, 79-96% of them at id 0), 2.4 ms
// for its primary one (no id over 6,343 lanes).
//
// What bounds it on an H100.  Bytes the sum needs: the cotangent read once
// (N x W x 4: 118.0 MB at N = 921,600, W = 32), the int32 ids read once
// (N x 4: 3.7 MB) and the table written once (T x W x 4: 33.5 MB at
// T = 261,396), 155.1 MB, 46.3 us at 3.35 TB/s.  This implementation moves
// ~310 MB more of its own: the table zeroed first (33.5 MB), the staged
// transpose's write and read of the cotangent (235.9 MB), the sort's keys
// and int64 permutation written and read back by the first level (N x 28
// bytes, 25.8 MB) and the first level's slots written and read (14.7 MB).
//
// Design.  The ids are sorted (stably, as int32) by the caller with a
// library sort: ~0.9M keys.  Then:
//
// 1. scatter_rows_transpose_kernel copies the planar cotangent into rows,
//    (N, W), through shared memory: each block reads a 64-lane tile of 32
//    columns along the lanes and writes it back along the rows, both
//    coalesced.  Without it every lane of the sum would cost W scattered
//    4-byte loads (one 32-byte sector each, W sectors a lane); with it a
//    lane's row is W x 4 contiguous bytes (128 at W = 32: whole sectors),
//    read once, by one warp, in one transaction.
// 2. scatter_rows_sum_kernel sums runs of equal ids.  Work is cut into
//    fixed chunks of kChunk = 32 items (sorted positions at the first
//    level), one warp a chunk, one lane a column (W > 32 takes several
//    column groups, blockIdx.y).  The warp loads its 32 rows at once (32
//    registers a lane) and walks them in order: a run of equal ids is a
//    piece, summed from 0.0f in item order.  A piece whose id has no item
//    before or after the chunk is its whole segment and is stored in the
//    table directly; a piece whose segment crosses the chunk's left edge
//    goes to the chunk's slot 2c, one that crosses only its right edge to
//    slot 2c + 1 (a chunk emits at most these two).  The slots, in chunk
//    order, are the next level's items, each carrying its id and whether
//    its segment has items before it and after it; an unused slot has id
//    -1 and is skipped.  The same kernel sums the next level in chunks of
//    32 slots, and so on, until one chunk holds the level (n <= 32), where
//    no piece can cross.  N = 921,600 takes five levels (921,600, 57,600,
//    3,600, 226, 16 items).
//
// Skew.  No warp walks more than 32 items at any level, however long a
// segment is: the id-0 segment of a wavefront of misses (60% of the lanes
// and more) is summed as a tree of 32-wide pieces over the levels, at the
// same cost as any other lanes.
//
// Order and determinism.  No atomics: every table row is written by the
// one warp that completes its segment, every slot by its chunk's warp.
// Each piece sums its items in order from 0.0f, and a segment that crosses
// chunks is the sum of its pieces in chunk order at the next level, and so
// on: a fixed tree, so two runs give bitwise-equal tables.  The plain torch
// version (ops/scatter_cuda.py::scatter_rows_sum_plain) repeats the levels
// and the order, so the kernel equals it bitwise (-fmad=false; there is
// nothing to contract).  A segment inside one chunk is summed in lane order
// from 0.0f, as ATen's serial CPU index_put_ sums it; one that crosses
// chunks differs from it by the association of its sum.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kChunk = 32;        // items a warp sums: one a lane, walked in order
constexpr int kCols = 32;         // columns a warp (a column group) takes
constexpr int kWarps = 8;         // warps (chunks) a block of the sum
constexpr int kTileLanes = 64;    // lanes a block of the transpose takes
constexpr int kTransposeThreads = 256;

__global__ void __launch_bounds__(kTransposeThreads)
scatter_rows_transpose_kernel(const float* __restrict__ ct, long long n,
                              int width, float* __restrict__ rows) {
  // One pad column: the reads of the second loop (w varying fastest) fall
  // in distinct banks.
  __shared__ float tile[kCols][kTileLanes + 1];
  const long long l0 = (long long)blockIdx.x * kTileLanes;
  const int w0 = blockIdx.y * kCols;
  const int nl = (int)(n - l0 < kTileLanes ? n - l0 : kTileLanes);
  const int nw = width - w0 < kCols ? width - w0 : kCols;
  for (int i = threadIdx.x; i < nw * kTileLanes; i += kTransposeThreads) {
    const int w = i / kTileLanes, l = i % kTileLanes;
    if (l < nl) tile[w][l] = ct[(long long)(w0 + w) * n + l0 + l];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nl * nw; i += kTransposeThreads) {
    const int l = i / nw, w = i % nw;
    rows[(l0 + l) * width + w0 + w] = tile[w][l];
  }
}

// A finished piece of the segment `id`: stored in the table if it is the
// whole segment, else in the chunk's slot for the next level.
__device__ __forceinline__ void close_piece(
    int id, int left, int right, float acc, long long chunk, int lane, int w,
    bool col, int width, float* __restrict__ out,
    int32_t* __restrict__ keys_out, int32_t* __restrict__ flags_out,
    float* __restrict__ vals_out) {
  if (!left && !right) {
    if (col) out[(long long)id * width + w] = acc;
    return;
  }
  const long long slot = 2 * chunk + (left ? 0 : 1);
  if (col) vals_out[slot * width + w] = acc;
  if (blockIdx.y == 0 && lane == 0) {
    keys_out[slot] = id;
    flags_out[slot] = left | (right << 1);
  }
}

// One level of the sum over n items.  First level (kFirst): the items are
// the sorted ids `keys`, their rows `vals[perm[i]]` and their flags read
// from the neighbouring ids.  Later levels: the previous level's slots,
// `keys` (-1: unused), `flags` (bit 0: items of the segment lie before,
// bit 1: after) and rows `vals[i]`.  keys_out, flags_out and vals_out hold
// two slots a chunk; the last level (n <= kChunk) passes null: nothing
// crosses there.
template <bool kFirst>
__global__ void __launch_bounds__(kWarps * 32)
scatter_rows_sum_kernel(const int32_t* __restrict__ keys,
                        const int64_t* __restrict__ perm,
                        const int32_t* __restrict__ flags,
                        const float* __restrict__ vals, long long n,
                        int width, float* __restrict__ out,
                        int32_t* __restrict__ keys_out,
                        int32_t* __restrict__ flags_out,
                        float* __restrict__ vals_out) {
  const int lane = threadIdx.x & 31;
  const long long chunk = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long i0 = chunk * kChunk;
  if (i0 >= n) return;                        // the whole warp
  const long long i = i0 + lane;
  const bool in = i < n;
  const int key = in ? keys[i] : -1;
  int flag;
  long long src;
  if (kFirst) {
    int prev = __shfl_up_sync(kAll, key, 1);
    int next = __shfl_down_sync(kAll, key, 1);
    if (lane == 0) prev = i0 > 0 ? keys[i0 - 1] : -2;
    if (lane == 31) next = i0 + kChunk < n ? keys[i0 + kChunk] : -2;
    flag = in ? (int)(prev == key) | ((int)(next == key) << 1) : 0;
    src = in ? perm[i] : 0;
  } else {
    flag = in ? flags[i] : 0;
    src = i;
  }
  const int w = blockIdx.y * kCols + lane;
  const bool col = w < width;

  // Every row of the chunk in flight at once: the loads do not wait for
  // the sums.
  float v[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int kj = __shfl_sync(kAll, key, j);
    const long long sj = __shfl_sync(kAll, src, j);
    v[j] = (col && kj >= 0) ? vals[sj * width + w] : 0.0f;
  }

  if (keys_out != nullptr && blockIdx.y == 0 && lane == 0) {
    keys_out[2 * chunk] = -1;
    keys_out[2 * chunk + 1] = -1;
  }
  float acc = 0.0f;
  int cur = -1, left = 0, right = 0;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int kj = __shfl_sync(kAll, key, j);
    const int fj = __shfl_sync(kAll, flag, j);
    if (kj < 0) continue;                     // unused slot or past n
    if (kj != cur) {
      if (cur >= 0)
        close_piece(cur, left, right, acc, chunk, lane, w, col, width, out,
                    keys_out, flags_out, vals_out);
      cur = kj;
      left = fj & 1;
      acc = 0.0f;
    }
    right = fj >> 1;
    acc += v[j];
  }
  if (cur >= 0)
    close_piece(cur, left, right, acc, chunk, lane, w, col, width, out,
                keys_out, flags_out, vals_out);
}

}  // namespace

extern "C" {

int scatter_rows_transpose_launch(const void* ct, long long n, int width,
                                  void* rows, void* stream) {
  if (n > 0 && width > 0) {
    const dim3 grid((unsigned)((n + kTileLanes - 1) / kTileLanes),
                    (unsigned)((width + kCols - 1) / kCols));
    scatter_rows_transpose_kernel<<<grid, kTransposeThreads, 0,
                                    (cudaStream_t)stream>>>(
        (const float*)ct, n, width, (float*)rows);
  }
  return (int)cudaGetLastError();
}

int scatter_rows_sum_launch(int first, const void* keys, const void* perm,
                            const void* flags, const void* vals, long long n,
                            int width, void* out, void* keys_out,
                            void* flags_out, void* vals_out, void* stream) {
  if (n > 0 && width > 0) {
    const long long chunks = (n + kChunk - 1) / kChunk;
    const dim3 grid((unsigned)((chunks + kWarps - 1) / kWarps),
                    (unsigned)((width + kCols - 1) / kCols));
    if (first) {
      scatter_rows_sum_kernel<true><<<grid, kWarps * 32, 0,
                                      (cudaStream_t)stream>>>(
          (const int32_t*)keys, (const int64_t*)perm, nullptr,
          (const float*)vals, n, width, (float*)out, (int32_t*)keys_out,
          (int32_t*)flags_out, (float*)vals_out);
    } else {
      scatter_rows_sum_kernel<false><<<grid, kWarps * 32, 0,
                                       (cudaStream_t)stream>>>(
          (const int32_t*)keys, nullptr, (const int32_t*)flags,
          (const float*)vals, n, width, (float*)out, (int32_t*)keys_out,
          (int32_t*)flags_out, (float*)vals_out);
    }
  }
  return (int)cudaGetLastError();
}

// The items a chunk sums: the plain version (ops/scatter_cuda.py CHUNK)
// must cut its levels the same way, and checks this at build time.
int scatter_rows_chunk(void) { return kChunk; }

const char* scatter_rows_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
