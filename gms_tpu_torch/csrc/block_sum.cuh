// Exact block-wide sum of a per-thread int64 into one int64 output.
//
// Every thread of the block must call block_sum_add (it synchronises). The
// block's sum goes to *out with one 64-bit integer atomicAdd; integer atomics
// are order-free, so the total is bit-identical to a sequential sum.
// add_block_sum and block_read are the device counts of the cooperative
// dispatch kernels (color_jp.cu, color_spec.cu).
#pragma once

#include <cuda_runtime.h>

#define GMS_SENTINEL 0x7fffffff

__device__ __forceinline__ void block_sum_add(long long v,
                                              unsigned long long* out) {
  __shared__ long long warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    v = lane < nwarps ? warp_sums[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0 && v != 0) atomicAdd(out, static_cast<unsigned long long>(v));
  }
}

// A value read by thread 0 after a grid barrier, shared with the block.
__device__ __forceinline__ long long block_read(const long long* p) {
  __shared__ long long value;
  if (threadIdx.x == 0) value = *reinterpret_cast<const volatile long long*>(p);
  __syncthreads();
  const long long v = value;
  __syncthreads();
  return v;
}

// Adds the block's sum of v to *out; every thread calls it, and calls may
// follow each other.
__device__ __forceinline__ void add_block_sum(long long v, long long* out) {
  __syncthreads();
  block_sum_add(v, reinterpret_cast<unsigned long long*>(out));
}
