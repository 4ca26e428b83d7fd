// The seven vertex-similarity metrics' finish, shared by K18 and K19
// (pair_scores.cu) and K21 (tile_scores.cu). It is gms_tpu's
// _finish_metric (gms_tpu/algorithms/similarity.py:70-92) and the metric
// tail of all_pairs_scores (:133-153), the reference's quirks intact:
// Jaccard is c / (|A| + |B| + c) and 1.0 for two empty sets; overlap 0/0 is
// NaN; AA's weight 1/ln(deg w) is +inf at deg w = 1.
//
// c, ca, cb are exact integers held as float32, s the AA/RA weighted sum.
// Each operation is one IEEE round-to-nearest operation in gms_tpu's order
// (the denominator (ca + cb) + c): the intrinsics keep nvcc from contracting
// or reordering them, so the five count metrics equal gms_tpu bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// the order of gms_tpu's METRICS tuple
enum GmsMetric {
  kJaccard = 0,
  kOverlap = 1,
  kAdamicAdar = 2,
  kResource = 3,
  kCommonNeighbors = 4,
  kTotalNeighbors = 5,
  kPreferentialAttachment = 6,
};

__host__ __device__ __forceinline__ bool metric_weighted(int metric) {
  return metric == kAdamicAdar || metric == kResource;
}

// AA's 1/ln(d) (+inf at d = 1) or RA's 1/d for a common neighbour of degree d
__device__ __forceinline__ float metric_weight(int metric, int d) {
  const float f = (float)d;
  return metric == kAdamicAdar ? __fdiv_rn(1.0f, logf(f)) : __fdiv_rn(1.0f, f);
}

__device__ __forceinline__ float metric_finish(int metric, float c, float ca,
                                               float cb, float s) {
  switch (metric) {
    case kJaccard:
      return (ca == 0.0f && cb == 0.0f)
                 ? 1.0f
                 : __fdiv_rn(c, __fadd_rn(__fadd_rn(ca, cb), c));
    case kOverlap:
      return __fdiv_rn(c, fminf(ca, cb));
    case kCommonNeighbors:
      return c;
    case kTotalNeighbors:
      return __fsub_rn(__fadd_rn(ca, cb), c);
    case kPreferentialAttachment:
      return __fmul_rn(ca, cb);
    default:  // kAdamicAdar, kResource
      return s;
  }
}
