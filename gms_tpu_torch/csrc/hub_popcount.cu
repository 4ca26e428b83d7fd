// K2 and_popcount: Σ over hub groups g, slots k of popcount(A[g,k,:W] & B[g,:W])
// for the wide (hub-bitmap) edges of the triangle-count plan.
//
// Replaces two device programs of gms_tpu/algorithms/triangle_count.py:
//   * count_hub_groups_mat (:359) — stream mode: b_mat[G, W] holds each
//     group's head row, a_mat[G, K, W] its K partner rows, pre-gathered;
//   * count_hub_groups (:239)     — gather mode: rows[*, :W] of the hub bitmap
//     table (row stride HW), addressed through b_ids[G] and nbrs[G, K].
// Guard slots point at the all-zero last row of the table and add 0. Bit
// words arrive as int32 tensors holding gms_tpu's uint32 bits and are read
// here as unsigned. gms_tpu's `salt` (a guard against its platform memoizing
// repeated runs) has no purpose under CUDA and is dropped.
//
// Design: one block per group. The block walks the group's words with
// neighbouring threads on neighbouring words; a thread loads its head-row word
// once and reuses it across the K partner rows (for W >= block size), or, for
// narrow W, the block covers blockDim/W partner rows at once with each thread
// pinned to one column, so no lane idles when W < 32. __popc per word; an int64
// sum per block, one atomicAdd per block.
//
// Bound on an H100 (3.35 TB/s): stream mode must read the W words of every
// head row and partner slot that is not a guard (guard slots are all zero and
// add nothing), 4*W bytes each; the reads are sequential, fully coalesced
// streams. Gather mode must read each distinct referenced non-guard row prefix
// once plus the index arrays; it reads rows in the group's order and leans on
// L2 for rows that repeat across groups.

#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

// Sum of popcount(a_k & b) over the K rows of one group; a_k = arow(k).
template <typename RowOf>
__device__ __forceinline__ long long group_popcount(const unsigned* brow,
                                                    RowOf arow, int K, int W) {
  long long acc = 0;
  const int t = threadIdx.x;
  if (W >= (int)blockDim.x) {
    for (int w = t; w < W; w += blockDim.x) {
      const unsigned bw = brow[w];
      for (int k = 0; k < K; ++k) acc += __popc(arow(k)[w] & bw);
    }
  } else {
    const int per_pass = blockDim.x / W;  // partner rows covered at once
    if (t < per_pass * W) {
      const int w = t % W;
      const unsigned bw = brow[w];
      for (int k = t / W; k < K; k += per_pass) acc += __popc(arow(k)[w] & bw);
    }
  }
  return acc;
}

__global__ void stream_kernel(const unsigned* __restrict__ b,
                              const unsigned* __restrict__ a, int K, int W,
                              unsigned long long* out) {
  const long long g = blockIdx.x;
  const unsigned* brow = b + g * W;
  const unsigned* abase = a + g * K * (long long)W;
  const long long acc = group_popcount(
      brow, [&](int k) { return abase + (long long)k * W; }, K, W);
  block_sum_add(acc, out);
}

__global__ void gather_kernel(const unsigned* __restrict__ rows, long long hw,
                              const int* __restrict__ b_ids,
                              const int* __restrict__ nbrs, int K, int W,
                              unsigned long long* out) {
  const long long g = blockIdx.x;
  const unsigned* brow = rows + (long long)b_ids[g] * hw;
  const int* slots = nbrs + g * K;
  const long long acc = group_popcount(
      brow, [&](int k) { return rows + (long long)slots[k] * hw; }, K, W);
  block_sum_add(acc, out);
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int hub_popcount_stream(const void* b, const void* a, long long G,
                                   int K, int W, void* out, void* stream) {
  if (G > 0 && K > 0 && W > 0) {
    stream_kernel<<<(unsigned)G, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)b, (const unsigned*)a, K, W, (unsigned long long*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int hub_popcount_gather(const void* rows, long long hw,
                                   const void* b_ids, const void* nbrs,
                                   long long G, int K, int W, void* out,
                                   void* stream) {
  if (G > 0 && K > 0 && W > 0) {
    gather_kernel<<<(unsigned)G, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)rows, hw, (const int*)b_ids, (const int*)nbrs, K, W,
        (unsigned long long*)out);
  }
  return (int)cudaGetLastError();
}
