// A row's cull lists, selected by one block from the row's keys in shared
// memory: no (rows, K) key matrix and no device-wide sort.  K3b
// (csrc/cull_beam.cu) takes it; K3 (csrc/cull_rows.cu) writes the same keys
// and could take it too.
//
// The keys.  Key k of a row is a float in [+0.0, BIG] (BIG = 3.0e38, bits
// kBig): the entry of box k where the row hits it, BIG where not.  No key
// is -0.0 or NaN, so the keys' uint32 bits order as the floats do, and
// (bits << 32) | k orders the (key, id) pairs as a stable sort of the keys
// does (torch.sort(stable=True), lax.sort(is_stable=True)).
//
// The lists (ops/cluster_cuda.py::_order_hits, the plain version): with
// N = min(Le + 1, n) the row's N smallest pairs in that order; ids and
// nears hold the first Le of them, excl is pair Le's key where n > Le and
// BIG where not; meta = [min(count, Le), count > Le] and cutoff = excl
// where count > Le, else +inf (count: the row's hit boxes).  A row with
// fewer than Le keys below BIG is padded by the lowest-numbered boxes
// whose key is BIG, in id order, with nears = BIG, as the stable sort pads.
//
// How.
// 1. A radix select of pair N - 1 over the keys' 31 bits, 11 bits a digit
//    (30..20, 19..9, 8..0): a digit takes a pass over the keys that match
//    the prefix so far into a 2,048-bin histogram in shared memory, and a
//    block-wide scan.  Zero and BIG keys, which a row holds by the hundreds
//    or thousands (boxes around its origins, boxes it misses), are tallied
//    by the caller in registers as it writes the keys (tally_key), not by
//    atomics, and their values are known: the select stops where pair
//    N - 1 falls among them, or as soon as the keys up to its bin fit the
//    sort (the list is then their first N).  A row with fewer than N keys
//    below BIG (most rows that do not overflow) needs no pass at all, and
//    most others one.
// 2. The pairs below the threshold (or, where every key of the bin is
//    taken, the bin too) are gathered into shared memory as 64-bit
//    (bits << 32) | id, in any order (a warp-aggregated counter), and
//    sorted: up to kRankMax of them by rank (each pair counts the pairs
//    below it: no barrier), more by a bitonic sort whose stages within a
//    warp's 64 pairs take no block barrier.
// 3. Where only some keys equal to the threshold are taken (the BIG keys
//    that pad a short row; tied entries), the first of them in id order
//    follow the sorted pairs, by an ordered scan of the keys.
// Nothing of size n leaves shared memory; the lists are written once.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace row_select {

constexpr uint32_t kBig = 0x7F61B1E6u;   // bits of BIG = 3.0e38f
constexpr int kBins = 2048;              // 11-bit digits
constexpr uint32_t kNone = 0xFFFFFFFFu;
constexpr uint32_t kRankMax = 256;       // pairs sorted by rank; more, bitonic

// Block-shared scalars of the selection.  n_big, n_zero and n_sel start
// at 0 (the caller zeroes them before its first barrier).
struct Header {
  uint32_t n_big, n_zero;         // keys equal to BIG and to +0.0
  uint32_t n_sel;                 // pairs gathered for the sort
  uint32_t bin, before, in_bin;   // find_bin's answer
  uint32_t excl;                  // key bits of pair Le, where it was sorted
  uint32_t warp_sum[32];
};

__host__ __device__ inline uint32_t pow2_at_least(uint32_t n) {
  uint32_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Bytes of shared scratch that the histogram and the sort share: the
// histogram's counters, or the pairs the sort holds (at most N, padded to
// a power of two), whichever is larger.
__host__ __device__ inline uint32_t scratch_bytes(int n, int le) {
  const uint32_t take = (uint32_t)(le + 1 < n ? le + 1 : n);
  const uint32_t sort = pow2_at_least(take) * 8u;
  return sort > kBins * 4u ? sort : kBins * 4u;
}

__device__ __forceinline__ uint32_t lanes_below(int lane) { return (1u << lane) - 1u; }

// Lanes with `active` add one to hist[d]; a run of neighbouring lanes with
// one digit (coherent boxes give coherent keys) adds in one atomic.  Every
// lane of the warp calls it.
__device__ __forceinline__ void hist_add(uint32_t* hist, uint32_t d, bool active, int lane) {
  const uint32_t k = active ? d : kNone;
  const uint32_t prev = __shfl_up_sync(0xffffffffu, k, 1);
  const uint32_t starts = __ballot_sync(0xffffffffu, lane == 0 || prev != k);
  if (active && (lane == 0 || prev != k)) {
    const uint32_t later = lane == 31 ? 0u : starts & (0xFFFFFFFFu << (lane + 1));
    const int end = later ? __ffs(later) - 1 : 32;
    atomicAdd(&hist[d], (uint32_t)(end - lane));
  }
}

struct Tally {
  uint32_t big = 0, zero = 0;
};

// The caller's tally of the key bits v it writes.
__device__ __forceinline__ void tally_key(uint32_t v, Tally& tally) {
  tally.big += v == kBig;
  tally.zero += v == 0u;
}

// After the caller's last tally_key, by every lane: the warp's tallies
// into the header.  A barrier follows before select.
__device__ __forceinline__ void add_tally(Header* h, const Tally& tally, int lane) {
  const uint32_t big = __reduce_add_sync(0xffffffffu, tally.big);
  const uint32_t zero = __reduce_add_sync(0xffffffffu, tally.zero);
  if (lane == 0 && big) atomicAdd(&h->n_big, big);
  if (lane == 0 && zero) atomicAdd(&h->n_zero, zero);
}

// The bin that holds rank r (0-based) of the histogram's counts: h->bin,
// the counts before it (h->before) and its own (h->in_bin).  Block-wide,
// with a barrier on each side of the header's use.
template <int kThreads>
__device__ void find_bin(const uint32_t* hist, uint32_t r, Header* h) {
  static_assert(kBins % kThreads == 0 && kThreads % 32 == 0 && kThreads <= 1024, "block size");
  constexpr int kPer = kBins / kThreads;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t c[kPer], s = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    c[i] = hist[t * kPer + i];
    s += c[i];
  }
  uint32_t incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) h->warp_sum[warp] = incl;
  __syncthreads();
  uint32_t before = incl - s;
  for (int w = 0; w < warp; ++w) before += h->warp_sum[w];
  if (before <= r && r < before + s) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (r < before + c[i]) {
        h->bin = t * kPer + i;
        h->before = before;
        h->in_bin = c[i];
        break;
      }
      before += c[i];
    }
  }
  __syncthreads();
}

// The pairs gathered: those whose key k has (k >> shift) < prefix (`below`
// of them), then those with (k >> shift) == prefix: all of them where
// `all` (at least N pairs, and no more than the sort holds: the first N of
// them in order are the list), else (shift 0, prefix the threshold key)
// none, and the first rank + 1 in id order follow the sorted ones.
struct Threshold {
  uint32_t prefix, below, rank;
  int shift;
  bool all;
};

// Select pair r (0-based) of the n keys in (key, id) order, or a prefix
// whose keys number at most `cap` and hold it; h holds the tallies
// (tally_key, add_tally, a barrier after them), hist is scratch for the
// histogram.  The same answer in every thread.
template <int kThreads>
__device__ Threshold select(const uint32_t* keys, int n, uint32_t r, uint32_t cap, uint32_t* hist,
                            Header* h) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const uint32_t n_big = h->n_big, n_zero = h->n_zero;
  Threshold th;
  th.prefix = 0;        // no digit yet: every key (bits < 2^31) has prefix 0
  th.shift = 31;
  th.below = 0;
  uint32_t in_bin = (uint32_t)n;
  while (true) {
    // A bin's smallest keys are its zeros and its largest its BIG keys.
    if (th.prefix == 0u && r < n_zero) {
      th.shift = 0;
      in_bin = n_zero;
      break;
    }
    if (th.prefix == (kBig >> th.shift) && r >= in_bin - n_big) {
      th.below += in_bin - n_big;
      r -= in_bin - n_big;
      th.prefix = kBig;
      th.shift = 0;
      in_bin = n_big;
      break;
    }
    // Stop where the pairs up to this bin fit the sort: the list is their
    // first N.
    if (in_bin == r + 1 || th.below + in_bin <= cap || th.shift == 0) break;
    const int next = th.shift == 31 ? 20 : th.shift == 20 ? 9 : 0;
    for (int i = t; i < kBins; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int j0 = warp * 32; j0 < n; j0 += kThreads) {
      const int j = j0 + lane;
      const uint32_t v = j < n ? keys[j] : 0u;
      const bool in = j < n && (v >> th.shift) == th.prefix && v != 0u && v != kBig;
      hist_add(hist, (v >> next) & (kBins - 1), in, lane);
    }
    if (t == 0 && th.prefix == 0u) atomicAdd(&hist[0], n_zero);
    if (t == 0 && th.prefix == (kBig >> th.shift))
      atomicAdd(&hist[(kBig >> next) & (kBins - 1)], n_big);
    __syncthreads();
    find_bin<kThreads>(hist, r, h);
    th.prefix = (th.prefix << (th.shift - next)) | h->bin;
    th.below += h->before;
    r -= h->before;
    in_bin = h->in_bin;
    th.shift = next;
  }
  th.rank = r;
  th.all = in_bin == r + 1 || th.below + in_bin <= cap;
  return th;
}

// Gather the pairs taken below the threshold (all of its bin where
// th.all) into `pairs`; returns their count.  Ends with a barrier.
template <int kThreads>
__device__ uint32_t gather(const uint32_t* keys, int n, const Threshold& th, uint64_t* pairs,
                           Header* h) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int j0 = warp * 32; j0 < n; j0 += kThreads) {
    const int j = j0 + lane;
    const uint32_t v = j < n ? keys[j] : kNone;
    const bool take = j < n && (th.all ? (v >> th.shift) <= th.prefix : v < th.prefix);
    const uint32_t mask = __ballot_sync(0xffffffffu, take);
    uint32_t slot = 0;
    if (lane == 0 && mask) slot = atomicAdd(&h->n_sel, (uint32_t)__popc(mask));
    slot = __shfl_sync(0xffffffffu, slot, 0);
    if (take) pairs[slot + __popc(mask & lanes_below(lane))] = ((uint64_t)v << 32) | (uint32_t)j;
  }
  __syncthreads();
  return h->n_sel;
}

// Pair `pair` at list position pos: ids and nears below le, the key bits
// of pair le into h->excl.
__device__ __forceinline__ void emit(uint32_t pos, uint64_t pair, int le, int32_t* ids,
                                     float* nears, Header* h) {
  if (pos < (uint32_t)le) {
    ids[pos] = (int32_t)(uint32_t)pair;
    nears[pos] = __uint_as_float((uint32_t)(pair >> 32));
  } else if (pos == (uint32_t)le) {
    h->excl = (uint32_t)(pair >> 32);
  }
}

// Sort pairs[0, n) ascending (bitonic, padded to a power of two with the
// largest pair).  Thread t takes the compare-exchanges i = t, t + kThreads,
// ...; at a distance j <= 32 those of one warp stay in its own 64-pair
// runs, so only a stage at a larger distance, or next to one, takes a
// block barrier.  Ends with a barrier.
template <int kThreads>
__device__ void bitonic_sort(uint64_t* pairs, uint32_t n) {
  const uint32_t p = pow2_at_least(n);
  for (uint32_t i = n + threadIdx.x; i < p; i += kThreads) pairs[i] = ~0ull;
  __syncthreads();
  for (uint32_t k = 2; k <= p; k <<= 1) {
    for (uint32_t j = k >> 1; j > 0; j >>= 1) {
      for (uint32_t i = threadIdx.x; i < p / 2; i += kThreads) {
        const uint32_t lo = ((i & ~(j - 1)) << 1) | (i & (j - 1)), hi = lo + j;
        const uint64_t a = pairs[lo], b = pairs[hi];
        if ((a > b) == ((lo & k) == 0)) {
          pairs[lo] = b;
          pairs[hi] = a;
        }
      }
      // The next stage's distance: j / 2, or k after j = 1.
      if (j > 32 || (j == 1 && k > 32)) {
        __syncthreads();
      } else {
        __syncwarp();
      }
    }
  }
  __syncthreads();
}

// Emit pairs[0, n) in order at positions 0, 1, ...: by rank (each pair
// counts the pairs below it; keys are unique) up to kRankMax pairs, else
// after a bitonic sort.  Ends with a barrier.
template <int kThreads>
__device__ void sort_and_emit(uint64_t* pairs, uint32_t n, int le, int32_t* ids, float* nears,
                              Header* h) {
  if (n <= kRankMax) {
    for (uint32_t e = threadIdx.x; e < n; e += kThreads) {
      const uint64_t c = pairs[e];
      uint32_t rank = 0;
      for (uint32_t i = 0; i < n; ++i) rank += pairs[i] < c;
      emit(rank, c, le, ids, nears, h);
    }
  } else {
    bitonic_sort<kThreads>(pairs, n);
    for (uint32_t i = threadIdx.x; i < n; i += kThreads) emit(i, pairs[i], le, ids, nears, h);
  }
  __syncthreads();
}

// The first th.rank + 1 keys equal to th.prefix, in id order, at list
// positions th.below + their rank (those below le).  Block-wide.
template <int kThreads>
__device__ void take_ties(const uint32_t* keys, int n, const Threshold& th, int le,
                          int32_t* ids, float* nears, Header* h) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const uint32_t want = th.rank + 1;
  uint32_t taken = 0;
  for (int j0 = 0; j0 < n && taken < want; j0 += kThreads) {
    const int j = j0 + t;
    const bool tie = j < n && keys[j] == th.prefix;
    const uint32_t mask = __ballot_sync(0xffffffffu, tie);
    if (lane == 0) h->warp_sum[warp] = __popc(mask);
    __syncthreads();
    uint32_t before = taken, total = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      const uint32_t c = h->warp_sum[w];
      before += w < warp ? c : 0u;
      total += c;
    }
    const uint32_t rank = before + __popc(mask & lanes_below(lane));
    if (tie && rank < want && th.below + rank < (uint32_t)le) {
      ids[th.below + rank] = j;
      nears[th.below + rank] = __uint_as_float(th.prefix);
    }
    taken += total;
    __syncthreads();
  }
}

// The row's lists from its n keys in shared memory (tally_key over every
// key, add_tally and a barrier done), count its hit boxes, 1 <= le <= n:
// ids and nears (le each), meta (2) and cutoff (1) of the row in global
// memory.  scratch: scratch_bytes(n, le) bytes of shared memory.
// Block-wide.
template <int kThreads>
__device__ void write_lists(const uint32_t* keys, int n, int le, uint32_t count,
                            uint32_t* scratch, Header* h, int32_t* ids, float* nears,
                            int32_t* meta, float* cutoff) {
  const uint32_t take = (uint32_t)(le + 1 < n ? le + 1 : n);
  const Threshold th = select<kThreads>(keys, n, take - 1, scratch_bytes(n, le) / 8, scratch, h);
  uint64_t* pairs = reinterpret_cast<uint64_t*>(scratch);   // the histogram is spent
  const uint32_t n_pairs = gather<kThreads>(keys, n, th, pairs, h);
  sort_and_emit<kThreads>(pairs, n_pairs, le, ids, nears, h);
  if (!th.all) take_ties<kThreads>(keys, n, th, le, ids, nears, h);
  if (threadIdx.x == 0) {
    const uint32_t excl = n <= le ? kBig : th.all ? h->excl : th.prefix;
    const bool over = count > (uint32_t)le;
    meta[0] = over ? le : (int32_t)count;
    meta[1] = over;
    cutoff[0] = over ? __uint_as_float(excl) : INFINITY;
  }
}

}  // namespace row_select
