// Color picks over a used-color bitmask in shared memory, shared by the
// coloring kernels (K22 color_jp, K23 color_spec, K24's one-shot round).
//
// One warp owns one row (vertex) and `cw` 32-bit words of shared memory.
// `mask_clear` zeroes them, `mask_mark` sets the bit of a color when it lies
// below `limit` (gms_tpu's _pick_tiered ignores colors at or above 32*cw, its
// one-shot round colors outside the palette), and `kth_free` returns the
// k-th (0-based) color below `limit` whose bit is clear — gms_tpu's
// _pick_tiered word scan with _select_bit, 32 words a step — or -1 when
// fewer than k+1 are free. `free_count` counts the clear bits below `limit`.
// A row wide enough to take a whole block (K23's and K24's rows above 1,024
// entries) marks one mask for the block; `block_free_count` and
// `block_kth_free` count and select in it block-wide.

#pragma once

#include <cuda_runtime.h>

namespace color {

constexpr int kSentinel = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// bits of word `wi` that lie below `limit`
__device__ __forceinline__ unsigned limit_bits(int wi, int limit) {
  const int lo = wi * 32;
  if (lo + 32 <= limit) return kFull;
  if (lo >= limit) return 0u;
  return (1u << (limit - lo)) - 1u;
}

__device__ __forceinline__ void mask_clear(unsigned* mask, int cw, int lane) {
  for (int i = lane; i < cw; i += 32) mask[i] = 0u;
  __syncwarp();
}

__device__ __forceinline__ void mask_mark(unsigned* mask, int c, int limit) {
  if (c >= 0 && c < limit) atomicOr(mask + (c >> 5), 1u << (c & 31));
}

// position of the r-th (0-based) set bit of `w` (r < popcount(w))
__device__ __forceinline__ int select_bit(unsigned w, int r) {
  for (int i = 0; i < r; ++i) w &= w - 1u;
  return __ffs(w) - 1;
}

__device__ __forceinline__ int free_count(const unsigned* mask, int cw,
                                          int limit, int lane) {
  int c = 0;
  for (int wi = lane; wi < cw; wi += 32)
    c += __popc(~mask[wi] & limit_bits(wi, limit));
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
  return c;
}

// All lanes call it and all get the same answer. The caller has marked the
// mask and passed a __syncwarp().
__device__ __forceinline__ int kth_free(const unsigned* mask, int cw,
                                        int limit, int k, int lane) {
  int rem = k;
  for (int base = 0; base < cw; base += 32) {
    const int wi = base + lane;
    const unsigned fr = wi < cw ? ~mask[wi] & limit_bits(wi, limit) : 0u;
    const int c = __popc(fr);
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const int excl = incl - c;
    const unsigned hit = __ballot_sync(kFull, excl <= rem && rem < incl);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const int pick = wi * 32 + select_bit(fr, rem - excl);
      return __shfl_sync(kFull, pick, src);
    }
    rem -= __shfl_sync(kFull, incl, 31);
  }
  return -1;
}

// free_count for a block's mask (block-wide; every thread calls it after
// the marks and a barrier, and gets the count).
__device__ __forceinline__ int block_free_count(const unsigned* mask, int cw,
                                                int limit) {
  __shared__ int total;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  int c = 0;
  for (int wi = threadIdx.x; wi < cw; wi += blockDim.x)
    c += __popc(~mask[wi] & limit_bits(wi, limit));
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(&total, c);
  __syncthreads();
  const int t = total;
  __syncthreads();   // total is free for the next row
  return t;
}

// The k-th free color below `limit` of a block's mask (block-wide; k
// block-uniform, the marks done before a barrier), 0 when none.
__device__ __forceinline__ int block_kth_free(const unsigned* mask, int cw,
                                              int limit, int k) {
  __shared__ int pick;
  if (threadIdx.x < 32) {
    const int p = kth_free(mask, cw, limit, k, threadIdx.x);
    if (threadIdx.x == 0) pick = p;
  }
  __syncthreads();
  const int p = pick;
  __syncthreads();   // pick and the mask are free for the next row
  return p < 0 ? 0 : p;
}

// Dynamic shared memory of a launch with `wpb` warps of `cw` words each;
// raises the kernel's limit above the default 48 KB when it needs to.
template <typename Kernel>
__host__ inline int prepare_smem(Kernel kernel, int cw, int* wpb) {
  const long long per_warp = 4LL * cw;
  const long long budget = 48 * 1024;
  long long w = per_warp > 0 ? budget / per_warp : 8;
  if (w > 8) w = 8;
  if (w < 1) w = 1;
  *wpb = (int)w;
  const long long bytes = w * per_warp;
  if (bytes > budget) {
    if (bytes > 227 * 1024) return -1;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes) != cudaSuccess)
      return -1;
  }
  return (int)bytes;
}

}  // namespace color
