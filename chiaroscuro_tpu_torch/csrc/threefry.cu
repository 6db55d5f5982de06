// The sample streams' Threefry-2x32 (20 rounds, the Random123 generator),
// for Hopper (sm_90a): two kernels, one a call site of sampling/prng.py.
//
//   threefry_bounce_kernel: the (7, *B) planar uniforms of one path vertex,
//     prng.bounce_uniforms_plain: blocks (bounce, blk), blk = 0..3, under
//     each lane's key (k0, k1), dims interleaved (block 0 word 0, block 0
//     word 1, block 1 word 0, ...), the last word dropped.
//   threefry_raygen_kernel: a sample's key and its anti-aliasing jitter,
//     prng.raygen_streams_plain: (k0, k1) = block (pixel, sample) under the
//     key (0, seed), then (jx, jy) = block (kJitterTag, 0) under (k0, k1).
//
// Replaces no Pallas kernel.  The JAX package leaves the generator to XLA,
// which fuses each call site's rounds into one loop over uint32 words.  The
// port evaluated it with ATen's operators, and torch has no uint32
// arithmetic: each word lived in an int64 tensor, and every add and shift
// of a round was masked back to 32 bits as an operator of its own.  One
// block took ~170 full-width int64 passes; a bounce evaluates four blocks
// a lane over the whole wavefront.  Here a thread keeps a lane's words in
// 32-bit registers through every round.
//
// What bounds it on an H100.  Bytes: the bounce kernel reads a lane's two
// int64 words and writes seven floats, 16 + 28 = 44 bytes a lane (26.0 MB
// at Cornell's 589,824 lanes, 7.7 us at 3.35 TB/s); the raygen kernel
// reads 8 (pixel) + 8 (a per-lane sample) bytes and writes 16 + 8, 40
// bytes a lane.  Integer work: a block is 2 + 5 x 3 key-schedule adds and
// 20 rounds of an add, a rotate (one funnel shift) and an xor, 77
// operations; a bounce lane's four blocks, the key's parity word and the
// seven conversions are 324 (raygen's two blocks, their parity words and
// two conversions, 162), 191 M at 589,824 lanes: 11.4 us at the INT32
// rate (132 SMs x 64 lanes x 1.98 GHz).  That count is not a floor for
// this code: ptxas issues part of the adds as IMAD, which the FMA pipe
// executes beside the INT32 pipe.  chip_smoke.py reads the compiled
// instruction mix and bounds each pipe, and the issue rate, by what it
// holds.  The bytes and either integer bound are of one size, and far
// below the int64 chain's ~12.8 KB of device traffic a lane.
//
// Design.  One thread a lane, 256 threads a block, no shared memory.  The
// four blocks of a lane are independent chains, which the unrolled rounds
// interleave.  Each of the seven outputs is a plane of the (7, *B) tensor,
// so a warp's stores of one dim are 128 contiguous bytes.  The keys are
// read as int64 and cut to their low 32 bits, which is what the plain
// version's `& 0xFFFFFFFF` does; k0 and k1 are written back as int64
// holding uint32 values, as the plain version leaves them, so the
// integrator's compaction permutes them unchanged.
//
// The sample index comes through a pointer with a stride of 0 (a 0-dim
// tensor) or 1 (one a lane), or as a word argument where the caller has a
// Python int: a pass captured as a CUDA graph reads the index from device
// memory at every replay, so a later pass's first sample, written into
// the same tensor, is the one drawn.
//
// Exactness.  Integer arithmetic modulo 2^32, then each uniform as the
// float with exponent 0 and the word's top 23 bits as mantissa, minus 1.0f
// (exact): the kernels equal the plain version bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBounceDims = 7;        // prng.N_BOUNCE_DIMS
constexpr int kBounceBlocks = (kBounceDims + 1) / 2;
constexpr uint32_t kJitterTag = 0x51A77E12u;   // prng._JITTER_TAG
constexpr uint32_t kParity = 0x1BD11BDAu;

// One Threefry-2x32 block of 20 rounds: key (k0, k1), counter (c0, c1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& x0, uint32_t& x1) {
  constexpr int kRot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  x0 = c0 + ks[0];
  x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, kRot[(i & 1) * 4 + j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// A word's top 23 bits as a float in [0, 1): prng.uniform_from_bits.
__device__ __forceinline__ float uniform(uint32_t bits) {
  return __uint_as_float(0x3F800000u | (bits >> 9)) - 1.0f;
}

__global__ void __launch_bounds__(kThreads)
    threefry_bounce_kernel(const int64_t* __restrict__ k0,
                           const int64_t* __restrict__ k1, long long n,
                           uint32_t bounce, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t a = (uint32_t)k0[i], b = (uint32_t)k1[i];
  uint32_t w[2 * kBounceBlocks];
#pragma unroll
  for (int blk = 0; blk < kBounceBlocks; ++blk) {
    threefry2x32(a, b, bounce, (uint32_t)blk, w[2 * blk], w[2 * blk + 1]);
  }
#pragma unroll
  for (int d = 0; d < kBounceDims; ++d) out[d * n + i] = uniform(w[d]);
}

__global__ void __launch_bounds__(kThreads)
    threefry_raygen_kernel(uint32_t seed, const int64_t* __restrict__ pixel,
                           const int64_t* __restrict__ sample,
                           long long sample_stride, uint32_t sample_word,
                           long long n, int64_t* __restrict__ k0,
                           int64_t* __restrict__ k1, float* __restrict__ jx,
                           float* __restrict__ jy) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t s =
      sample != nullptr ? (uint32_t)sample[i * sample_stride] : sample_word;
  uint32_t a, b, x, y;
  threefry2x32(0u, seed, (uint32_t)pixel[i], s, a, b);
  threefry2x32(a, b, kJitterTag, 0u, x, y);
  k0[i] = (int64_t)a;
  k1[i] = (int64_t)b;
  jx[i] = uniform(x);
  jy[i] = uniform(y);
}

unsigned grid_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points, bound with ctypes.  Each launch runs on `stream`,
// allocates nothing, does not synchronise, and returns cudaGetLastError();
// n = 0 launches nothing.  Keys, pixels and samples are int64, contiguous,
// n of them (a sample with stride 0: one); out is (dims, n) f32,
// contiguous, and a dims other than the kernel's 7 launches nothing and
// returns cudaErrorInvalidValue.
extern "C" {

int threefry_bounce_launch(const void* k0, const void* k1, long long n,
                           unsigned bounce, int dims, void* out, void* stream) {
  if (dims != kBounceDims) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    threefry_bounce_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)k0, (const int64_t*)k1, n, bounce, (float*)out);
  }
  return (int)cudaGetLastError();
}

int threefry_raygen_launch(unsigned seed, const void* pixel, const void* sample,
                           long long sample_stride, unsigned sample_word,
                           long long n, void* k0, void* k1, void* jx, void* jy,
                           void* stream) {
  if (n > 0) {
    threefry_raygen_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        seed, (const int64_t*)pixel, (const int64_t*)sample, sample_stride,
        sample_word, n, (int64_t*)k0, (int64_t*)k1, (float*)jx, (float*)jy);
  }
  return (int)cudaGetLastError();
}

const char* threefry_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
