// A root's local rows in a warp's registers, for the register walks of the
// searches at W = 32*WW <= 128 (bk_walk.cuh: K9, K36; kclique_stack.cu: K6):
// lane l holds rows l + 32k, k < WW, at most 16 words; a row reaches every
// lane by WW __shfl_sync from its lane. Warp-uniform bitsets of WW words
// sit in registers too; their bits are walked with __ffs.
#pragma once

#include <cuda_runtime.h>

// Lowest set bit of s, or -1.
template <int WW>
__device__ __forceinline__ int first_bit(const unsigned (&s)[WW]) {
#pragma unroll
  for (int k = 0; k < WW; ++k)
    if (s[k]) return 32 * k + __ffs(s[k]) - 1;
  return -1;
}

template <int WW>
__device__ __forceinline__ bool any_bit(const unsigned (&s)[WW]) {
  unsigned o = 0u;
#pragma unroll
  for (int k = 0; k < WW; ++k) o |= s[k];
  return o != 0u;
}

template <int WW>
__device__ __forceinline__ void clear_bit(unsigned (&s)[WW], int v) {
#pragma unroll
  for (int k = 0; k < WW; ++k)
    if (k == (v >> 5)) s[k] &= ~(1u << (v & 31));
}

template <int WW>
__device__ __forceinline__ int popc_bits(const unsigned (&s)[WW]) {
  int p = 0;
#pragma unroll
  for (int k = 0; k < WW; ++k) p += __popc(s[k]);
  return p;
}

// The nth set bit of s (n < |s|).
template <int WW>
__device__ __forceinline__ int reg_nth_bit(const unsigned (&s)[WW], int n) {
#pragma unroll
  for (int k = 0; k < WW; ++k) {
    unsigned x = s[k];
    const int p = __popc(x);
    if (n < p) {
      for (; n > 0; --n) x &= x - 1u;
      return 32 * k + __ffs(x) - 1;
    }
    n -= p;
  }
  return 32 * WW;
}

// A root's rows in registers: lane l holds rows l + 32k, k < WW.
template <int WW>
struct RegRows {
  unsigned r[WW][WW];

  __device__ __forceinline__ void load(const unsigned* __restrict__ A,
                                       int lane) {
#pragma unroll
    for (int k = 0; k < WW; ++k)
#pragma unroll
      for (int x = 0; x < WW; ++x)
        r[k][x] = __ldg(A + (32 * k + lane) * WW + x);
  }

  // row v, in every lane
  __device__ __forceinline__ void row(int v, unsigned (&out)[WW]) const {
    const int k = v >> 5, src = v & 31;
#pragma unroll
    for (int x = 0; x < WW; ++x) {
      unsigned w = r[0][x];
#pragma unroll
      for (int j = 1; j < WW; ++j)
        if (k == j) w = r[j][x];
      out[x] = __shfl_sync(0xffffffffu, w, src);
    }
  }
};
