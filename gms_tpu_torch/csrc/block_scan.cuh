// Block-wide exclusive scans and totals, the root-offset scan, a tile's
// prefix by decoupled look-back, and the bit walks of the work-stack kernels
// (kclique_stack.cu, bk_stack.cu, star_stack.cu; kc_expand.cu looks back).
#pragma once

#include <cuda_runtime.h>

// Exclusive scan of one value per thread over the block, tile after tile:
// returns this thread's offset within the running total *carry, which it
// advances by the tile's sum. Every thread of the block must call it.
template <typename T>
__device__ T block_scan(T n, T* carry) {
  __shared__ T warp_tot[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = n;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T y = lane < (int)(blockDim.x >> 5) ? warp_tot[lane] : T(0);
    for (int o = 1; o < 32; o <<= 1) {
      const T z = __shfl_up_sync(0xffffffffu, y, o);
      if (lane >= o) y += z;
    }
    warp_tot[lane] = y;  // inclusive over warps
  }
  __syncthreads();
  const T excl = *carry + (warp > 0 ? warp_tot[warp - 1] : T(0)) + x - n;
  __syncthreads();
  if (threadIdx.x == blockDim.x - 1) *carry = excl + n;
  __syncthreads();
  return excl;
}

// Block-wide sum of one value per thread, returned to every thread. Every
// thread of the block must call it.
template <typename T>
__device__ T block_total(T n) {
  __shared__ T carry;
  if (threadIdx.x == 0) carry = T(0);
  __syncthreads();
  block_scan(n, &carry);
  const T total = carry;
  __syncthreads();
  return total;
}

// A tile's status word in a decoupled look-back (a single-pass scan over
// tiles handed out in order by a ticket, so that every tile before a
// running one has started): 0 until published, then a flag in the top two
// bits and a count below.
constexpr unsigned long long kLookAggregate = 1ull << 62;
constexpr unsigned long long kLookPrefix = 2ull << 62;
constexpr unsigned long long kLookValue = kLookAggregate - 1;

// Warp-wide: the exclusive prefix of tile t > 0, every lane. Reads the
// status words of the tiles before it, 32 at a time, waiting on any not yet
// published, and adds counts back to the first inclusive prefix. The caller
// publishes t's count before it and t's inclusive prefix after it.
__device__ __forceinline__ long long warp_look_back(
    volatile unsigned long long* status, long long t, int lane) {
  long long excl = 0;
  for (long long j = t - 1;; j -= 32) {
    const long long at = j - lane;
    unsigned long long s = kLookPrefix;  // before tile 0: a prefix of 0
    if (at >= 0) s = status[at];
    while (__any_sync(0xffffffffu, s < kLookAggregate))
      if (s < kLookAggregate) s = status[at];
    const unsigned pre = __ballot_sync(0xffffffffu, s >= kLookPrefix);
    const int stop = pre ? __ffs(pre) - 1 : 31;  // the nearest prefix
    long long v = lane <= stop ? (long long)(s & kLookValue) : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    excl += __shfl_sync(0xffffffffu, v, 0);
    if (pre) return excl;
  }
}

// Block-wide: the exclusive prefix of tile t, whose own count is agg, over
// the status words of the tiles before it (zeroed before the launch). Warp
// 0 publishes t's count, looks back (warp_look_back) and publishes t's
// inclusive prefix. Every thread calls it.
__device__ long long tile_prefix(volatile unsigned long long* status,
                                 long long t, long long agg) {
  __shared__ long long prefix;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    long long excl = 0;
    if (t > 0) {
      if (lane == 0) status[t] = kLookAggregate | (unsigned long long)agg;
      excl = warp_look_back(status, t, lane);
    }
    if (lane == 0) {
      status[t] = kLookPrefix | (unsigned long long)(excl + agg);
      prefix = excl;
    }
  }
  __syncthreads();
  const long long p = prefix;
  __syncthreads();
  return p;
}

// One block: roff[0..c) := exclusive offsets of the roots' item counts,
// roff[c] = the items in all; *next = 0 (the item counter of the persistent
// warps that follow).
__global__ void root_offsets_kernel(long long c, long long* roff,
                                    unsigned long long* next) {
  __shared__ long long carry;
  if (threadIdx.x == 0) {
    carry = 0;
    *next = 0ull;
  }
  __syncthreads();
  for (long long base = 0; base < c; base += blockDim.x) {
    const long long b = base + threadIdx.x;
    const long long n = b < c ? roff[b] : 0;
    const long long off = block_scan(n, &carry);
    if (b < c) roff[b] = off;
  }
  if (threadIdx.x == 0) roff[c] = carry;
}

// Root of item t: the last b with roff[b] <= t (roff ascending, c >= 1).
__device__ __forceinline__ long long item_root(const long long* roff,
                                               long long c,
                                               unsigned long long t) {
  long long lo = 0, hi = c;
  while (hi - lo > 1) {
    const long long mid = (lo + hi) >> 1;
    if ((unsigned long long)roff[mid] <= t) lo = mid; else hi = mid;
  }
  return lo;
}

// The nth set bit of S (n < |S|); every lane computes it.
__device__ __forceinline__ int nth_bit(const unsigned* S, int ww, int n) {
  for (int w = 0; w < ww; ++w) {
    unsigned x = S[w];
    const int p = __popc(x);
    if (n < p) {
      for (; n > 0; --n) x &= x - 1;
      return 32 * w + __ffs(x) - 1;
    }
    n -= p;
  }
  return 32 * ww;
}

// First set bit >= pos among S's ww words, or 32*ww; every lane of the warp
// calls it and gets the same answer.
__device__ __forceinline__ int next_bit(const unsigned* S, int ww, int pos,
                                        int lane) {
  for (int wb = pos >> 5; wb < ww; wb += 32) {
    const int w = wb + lane;
    unsigned x = w < ww ? S[w] : 0u;
    if (w == (pos >> 5)) x &= 0xffffffffu << (pos & 31);
    const unsigned hit = __ballot_sync(0xffffffffu, x != 0u);
    if (hit) {
      const int f = __ffs(hit) - 1;
      const unsigned xf = __shfl_sync(0xffffffffu, x, f);
      return 32 * (wb + f) + __ffs(xf) - 1;
    }
  }
  return 32 * ww;
}
