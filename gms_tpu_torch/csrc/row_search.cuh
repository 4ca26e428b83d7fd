// The clip-mode gather index of gms_tpu's `jnp.take(..., mode="clip")`,
// shared by the kernels that gather a row by an id that may lie outside the
// table (bk_init.cu, kbit_decode.cu, pair_scores.cu, row_decode.cuh,
// vf2_feasible.cu). A root's slots looked up by value, and a warp's walk of
// a row against them, are slot_table.cuh's (K4, K8, K11, K39, K40).
#pragma once

#include <cuda_runtime.h>

#include "block_sum.cuh"

// v clipped to [0, n-1] (n >= 1): gms_tpu's clip-mode gathers.
__device__ __forceinline__ long long clip_index(long long v, long long n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}
