// Membership of a padded row's elements among a root's slots, by binary
// search: the inner loop of member_pack (ring_member.cu, K39).
// build_local_adj (local_adj.cu, K4), hub_cover_bits (bk_cover.cu, K8) and
// build_local_univ (star_univ.cu, K11) look their slots up in a hash table
// (slot_table.cuh). clip_index is every kernel's clip-mode gather.
#pragma once

#include <cuda_runtime.h>

#include "block_sum.cuh"

// v clipped to [0, n-1] (n >= 1): gms_tpu's clip-mode gathers.
__device__ __forceinline__ long long clip_index(long long v, long long n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

// For one warp: calls hit(j), in the lane that finds it, for every slot j of
// q whose value lies in `row`. q holds W slots in shared memory and `row` d
// slots, each strictly ascending with a SENTINEL tail (the padded layout).
// The warp reads the row 32 slots at a time, coalesced, up to its first
// SENTINEL, and each lane binary-searches its element among q. Every lane
// of the warp calls it with the same row.
template <class Hit>
__device__ __forceinline__ void for_each_slot_in_row(const int* row, int d,
                                                     const int* q, int W,
                                                     int lane, Hit hit) {
  for (int base = 0; base < d; base += 32) {
    const int s = base + lane;
    const int x = s < d ? row[s] : GMS_SENTINEL;
    if (x != GMS_SENTINEL) {
      int lo = 0, hi = W;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (q[mid] < x) lo = mid + 1; else hi = mid;
      }
      if (lo < W && q[lo] == x) hit(lo);
    }
    if (__any_sync(0xffffffffu, x == GMS_SENTINEL)) break;
  }
}

// For one warp: bits[0, ww) = the bitset of the slots of q (W = 32*ww of
// them) whose value lies in `row`; all zero when row is null. bits is the
// warp's own buffer in shared memory, complete for every lane on return.
__device__ __forceinline__ void warp_slot_bits(const int* row, int d,
                                               const int* q, int W, int lane,
                                               unsigned* bits, int ww) {
  for (int w = lane; w < ww; w += 32) bits[w] = 0u;
  __syncwarp();
  if (row != nullptr)
    for_each_slot_in_row(row, d, q, W, lane, [&](int j) {
      atomicOr(bits + (j >> 5), 1u << (j & 31));
    });
  __syncwarp();
}
