// A root's padded row looked up by value, and one warp's walk of another
// row against it: the inner loop of build_local_adj (local_adj.cu, K4),
// hub_cover_bits (bk_cover.cu, K8) and member_pack (ring_member.cu, K39),
// which OR the slots found into bits (warp_row_bits), of build_local_univ
// (star_univ.cu, K11), which ORs them into two buffers, the second only
// where a per-slot test holds (warp_row_bits_if), and of
// tier_intersect_owned (tier_intersect.cu, K40), which counts them
// (warp_row_count). All three walk by warp_row_walk.
//
// Rows are strictly ascending with a SENTINEL tail (the padded layout), so a
// root's live slots are a prefix [0, L) of its row. A block loads the root's
// first min(W, D) slots once into shared memory and, in the same pass, into
// an open-addressed table (value -> slot, at least 4W entries up to W = 1024
// and 2W above, multiplicative hash, linear probing: one or two probes an
// element, in place of log2(W) for a binary search). Above W = 8192 the table
// would not fit; there the block binary-searches the slots in shared memory.
// A warp then walks a row kUnroll 32-slot chunks at a time (coalesced, the
// chunks' loads in flight together), looks each element up, and stops once
// an element passes the root's last live value (which also stops it at its
// first SENTINEL), ORing the slot bits it finds into its word buffers in
// shared memory (a shared atomicOr a hit) or counting them.
#pragma once

#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr int kUnroll = 4;           // 32-slot chunks of a row in flight
constexpr int kMaxHashW = 8192;      // the largest W the table serves
constexpr int kQuarterW = 1024;      // up to here the table is <= 1/4 full
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long clip_row(long long v, long long n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

__device__ __forceinline__ unsigned hash_of(int x, int shift) {
  return ((unsigned)x * 0x9E3779B1u) >> shift;
}

// The table's entries for W slots (a power of two, at least 64).
inline int slot_table_cap(int W) {
  int cap = 64;
  while (cap < (W <= kQuarterW ? 4 : 2) * W) cap <<= 1;
  return cap;
}

// The root's live slots, looked up: a hash table (kHash) or the sorted
// slots themselves.
template <bool kHash>
struct Slots {
  int2* table;       // kHash: [mask + 1] (value, slot), empty = SENTINEL
  int* sorted;       // r_nbr[0, n)
  int mask, shift, n;

  __device__ __forceinline__ int find(int x) const {
    if (kHash) {
      unsigned h = hash_of(x, shift);
      while (true) {
        const int2 e = table[h];
        if (e.x == x) return e.y;
        if (e.x == GMS_SENTINEL) return -1;
        h = (h + 1) & mask;
      }
    } else {
      int lo = 0, hi = n;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sorted[mid] < x) lo = mid + 1; else hi = mid;
      }
      return lo < n && sorted[lo] == x ? lo : -1;
    }
  }
};

// Block-wide (every thread calls it; it synchronises): r_nbr[0, W) = the
// root's slots root_row[0, wmax), SENTINEL beyond, and with kHash each live
// slot in `table` (table_cap entries). Returns the slots with n = L, the
// number of live slots; r_nbr and the table are complete for every thread.
// With kPrefix the block reads only the live prefix: it stops after the
// first blockDim-slot round that holds a SENTINEL, and r_nbr is written only
// that far (K40 stages a short row of a wide table so).
template <bool kHash, bool kPrefix = false>
__device__ __forceinline__ Slots<kHash> load_slots(const int* root_row,
                                                   int wmax, int W,
                                                   int2* table, int table_cap,
                                                   int* r_nbr) {
  Slots<kHash> slots;
  if (kHash) {
    slots.table = table;
    slots.mask = table_cap - 1;
    slots.shift = 32 - __ffs(table_cap) + 1;
    for (int h = threadIdx.x; h < table_cap; h += blockDim.x)
      table[h] = make_int2(GMS_SENTINEL, 0);
    __syncthreads();
  }
  int live = 0;
  for (int base = 0; base < W; base += blockDim.x) {
    const int j = base + threadIdx.x;
    const int x = j < wmax ? root_row[j] : GMS_SENTINEL;
    if (j < W) r_nbr[j] = x;
    if (kHash && x != GMS_SENTINEL) {
      unsigned h = hash_of(x, slots.shift);
      while (atomicCAS(&table[h].x, GMS_SENTINEL, x) != GMS_SENTINEL)
        h = (h + 1) & slots.mask;
      table[h].y = j;
    }
    live += __syncthreads_count(x != GMS_SENTINEL);
    if (kPrefix && live < base + (int)blockDim.x) break;
  }
  slots.sorted = r_nbr;
  slots.n = live;
  return slots;
}

// For one warp: calls hit(j), in the lane that finds it, for each element
// of `row` (d slots) that `slots` holds, j = slots.find(x) >= 0 (slots: a
// Slots, or any set whose find(x) is >= 0 for a member, none above `last`).
// d is the row's live length or more, so that no load reaches past the
// row's data; kUnroll chunks of 32 load at a time, and the warp stops after
// the chunk where an element passes `last`. Every lane calls it with the
// same row.
template <class Lookup, class Hit>
__device__ __forceinline__ void warp_row_walk(const int* row, int d, int last,
                                              const Lookup& slots, int lane,
                                              Hit hit) {
  for (int base = 0; base < d; base += 32 * kUnroll) {
    int x[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int s = base + 32 * k + lane;
      x[k] = s < d ? row[s] : GMS_SENTINEL;
    }
    bool past = false;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (x[k] <= last) {
        const int j = slots.find(x[k]);
        if (j >= 0) hit(j);
      }
      past |= x[k] > last;
    }
    if (__any_sync(kFull, past)) break;
  }
}

// For one warp: bits[0, ww) = the bitset of the root's live slots (`slots`,
// n >= 1, the last of them `last`) whose value lies in `row` (d slots).
// bits is the warp's own buffer in shared memory, complete for every lane on
// return; every lane calls it with the same row.
template <bool kHash>
__device__ __forceinline__ void warp_row_bits(const int* row, int d,
                                              int last,
                                              const Slots<kHash>& slots,
                                              int lane, unsigned* bits,
                                              int ww) {
  for (int w = lane; w < ww; w += 32) bits[w] = 0u;
  __syncwarp();
  warp_row_walk(row, d, last, slots, lane, [&](int j) {
    atomicOr(bits + (j >> 5), 1u << (j & 31));
  });
  __syncwarp();
}

// warp_row_bits into two buffers: each slot found in bits, and in bits2 too
// where keep(j) holds.
template <bool kHash, class Keep>
__device__ __forceinline__ void warp_row_bits_if(const int* row, int d,
                                                 int last,
                                                 const Slots<kHash>& slots,
                                                 int lane, unsigned* bits,
                                                 unsigned* bits2, int ww,
                                                 Keep keep) {
  for (int w = lane; w < ww; w += 32) bits[w] = bits2[w] = 0u;
  __syncwarp();
  warp_row_walk(row, d, last, slots, lane, [&](int j) {
    const unsigned bit = 1u << (j & 31);
    atomicOr(bits + (j >> 5), bit);
    if (keep(j)) atomicOr(bits2 + (j >> 5), bit);
  });
  __syncwarp();
}

// For one warp: this lane's share of |{x in row[0, d) : x in slots}|, the
// walk of warp_row_walk with hits counted; the caller sums the lanes'
// shares.
template <class Lookup>
__device__ __forceinline__ int warp_row_count(const int* row, int d, int last,
                                              const Lookup& slots, int lane) {
  int hits = 0;
  warp_row_walk(row, d, last, slots, lane, [&](int) { ++hits; });
  return hits;
}

// Block-wide: n words at `out` set to zero, 16 bytes a store where `out` is
// 16-byte aligned and n a multiple of 4.
__device__ __forceinline__ void zero_words(unsigned* out, long long n) {
  if ((reinterpret_cast<size_t>(out) & 15) == 0 && (n & 3) == 0) {
    uint4* out4 = reinterpret_cast<uint4*>(out);
    for (long long k = threadIdx.x; k < (n >> 2); k += blockDim.x)
      out4[k] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (long long k = threadIdx.x; k < n; k += blockDim.x) out[k] = 0u;
  }
}

}  // namespace
