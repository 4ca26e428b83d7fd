// K34 bc_forward and bc_backward: Brandes' betweenness centrality over a
// batch of B sources, the steps of gms_tpu/algorithms/gapbs.py
// `_bc_one_source` (:337) vmapped by `_bc_batched` (:375), over CSR rows
// read to their degree. State rows b of dist int32[B, n] (INF = int32 max
// where unreached), sigma and delta float32[B, n]; source s_b starts at
// dist 0, sigma 1.
//   bc_forward(it)  — for each (b, v) with dist == INF: s = the sum of
//                     sigma[b, w] over the row's w with dist[b, w] == it;
//                     if s > 0, dist = it + 1 and sigma = s (gms_tpu's
//                     `new = (dist == INF) & (s > 0)`).
//   bc_backward(it) — for each (b, v) with dist == it: delta = the sum over
//                     the row's successors w (dist[b, w] == it + 1, sigma > 0)
//                     of sigma[b, v] / max(sigma[b, w], 1e-30) *
//                     (1 + delta[b, w]); for it > 0 the value is also added
//                     to total[v] (float32[n]): row b's delta is final at
//                     this step, and the source, the only vertex at depth 0,
//                     keeps gms_tpu's `delta.at[source].set(0)` by not being
//                     added. The batch sum thus lands on the device.
// Both steps are in place, which is safe: forward writes only INF rows and
// reads rows at depth it; backward writes rows at depth it and reads rows at
// depth it + 1. The caller runs gms_tpu's max_depth steps each way.
// sigma and delta stay float32, as in gms_tpu. A row's sum accumulates in
// float64 and rounds once to float32, so it does not hang on the warp's
// order (the terms are float32 values, as gms_tpu's). total's sum is a race
// of float32 atomics and XLA sums gms_tpu's rows in float32, so the result
// matches gms_tpu to rounding (rtol 1e-4), not bit for bit.
//
// A warp a (source, vertex) pair. Bound on an H100: bytes — per step the
// state words of the pairs and, for the rows that scan (INF rows forward,
// depth-it rows backward), the row and the neighbours' state words.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInf = 0x7fffffff;

__global__ void bc_forward_kernel(const long long* __restrict__ indptr,
                                  const int* __restrict__ indices,
                                  long long n, long long B,
                                  int* __restrict__ dist,
                                  float* __restrict__ sigma, int it) {
  const long long p = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= B * n) return;
  if (dist[p] != kInf) return;
  const long long b = p / n, v = p - b * n;
  const int* drow = dist + b * n;
  const float* srow = sigma + b * n;
  double s = 0.0;
  for (long long j = indptr[v] + lane; j < indptr[v + 1]; j += 32) {
    const int w = indices[j];
    if (drow[w] == it) s = __dadd_rn(s, (double)srow[w]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    s = __dadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  }
  if (lane == 0 && s > 0.0) {
    dist[p] = it + 1;
    sigma[p] = __double2float_rn(s);
  }
}

__global__ void bc_backward_kernel(const long long* __restrict__ indptr,
                                   const int* __restrict__ indices,
                                   long long n, long long B,
                                   const int* __restrict__ dist,
                                   const float* __restrict__ sigma,
                                   float* __restrict__ delta, int it,
                                   float* __restrict__ total) {
  const long long p = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= B * n) return;
  if (dist[p] != it) return;
  const long long b = p / n, v = p - b * n;
  const int* drow = dist + b * n;
  const float* srow = sigma + b * n;
  const float* trow = delta + b * n;
  const float sv = sigma[p];
  double sum = 0.0;
  for (long long j = indptr[v] + lane; j < indptr[v + 1]; j += 32) {
    const int w = indices[j];
    const float sw = srow[w];
    if (drow[w] == it + 1 && sw > 0.0f) {
      const float q = __fdiv_rn(sv, fmaxf(sw, 1e-30f));
      sum = __dadd_rn(sum,
                      (double)__fmul_rn(q, __fadd_rn(1.0f, trow[w])));
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    sum = __dadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
  }
  if (lane == 0) {
    const float acc = __double2float_rn(sum);
    delta[p] = acc;
    if (it > 0 && acc != 0.0f) atomicAdd(total + v, acc);
  }
}

inline unsigned warps_blocks(long long pairs) {
  return (unsigned)((32 * pairs + kThreads - 1) / kThreads);
}

}  // namespace

// dist: int32[B, n]; sigma: float32[B, n].
extern "C" int bc_forward(const void* indptr, const void* indices,
                          long long n, long long B, void* dist, void* sigma,
                          int it, void* stream) {
  if (n > 0 && B > 0) {
    bc_forward_kernel<<<warps_blocks(B * n), kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const long long*)indptr, (const int*)indices, n, B, (int*)dist,
        (float*)sigma, it);
  }
  return (int)cudaGetLastError();
}

// delta: float32[B, n]; total: float32[n], added to.
extern "C" int bc_backward(const void* indptr, const void* indices,
                           long long n, long long B, const void* dist,
                           const void* sigma, void* delta, int it,
                           void* total, void* stream) {
  if (n > 0 && B > 0) {
    bc_backward_kernel<<<warps_blocks(B * n), kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const long long*)indptr, (const int*)indices, n, B,
        (const int*)dist, (const float*)sigma, (float*)delta, it,
        (float*)total);
  }
  return (int)cudaGetLastError();
}
