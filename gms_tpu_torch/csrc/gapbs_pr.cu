// K32 pr_pull: one PageRank pull iteration of gms_tpu/algorithms/gapbs.py
// `_pagerank` (:216, GAPBS PageRankPull), over CSR rows read to their degree:
//   out[v] = base + damp * sum over w in row v of pr[w] / max(deg[w], 1)
// for v < n, with float32 state. The caller rounds base once, as gms_tpu's
// weak-typed float64 (1 - damp) meeting float32 n: base = f32(1 - damp) /
// f32(n); damp is f32(damp). The quotient pr[w] / max(deg[w], 1) is IEEE
// float32 division per neighbour, bit for bit gms_tpu's `contrib`. The row's
// sum accumulates in float64 (lanes stride the row, then a shuffle tree) and
// rounds once to float32, so it does not hang on the order of the sum: a row
// of 25,196 entries summed in float32 drifts by about 1e-5 relative from one
// order to another. The product and the final sum round separately (no fused
// multiply-add). XLA sums gms_tpu's rows in float32, so the result matches
// gms_tpu to rounding (rtol 1e-5), not bit for bit.
//
// A warp a vertex. Bound on an H100: bytes — indptr and the indices once,
// pr and deg of each distinct neighbour, out written.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void pr_pull_kernel(const long long* __restrict__ indptr,
                               const int* __restrict__ indices, long long n,
                               const int* __restrict__ deg,
                               const float* __restrict__ pr, float base,
                               float damp, float* __restrict__ out) {
  const long long v = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (v >= n) return;
  double s = 0.0;
  for (long long j = indptr[v] + lane; j < indptr[v + 1]; j += 32) {
    const int w = indices[j];
    const int d = deg[w];
    s = __dadd_rn(s, (double)__fdiv_rn(pr[w], (float)(d > 1 ? d : 1)));
  }
  for (int o = 16; o > 0; o >>= 1) {
    s = __dadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  }
  if (lane == 0) {
    out[v] = __fadd_rn(base, __fmul_rn(damp, __double2float_rn(s)));
  }
}

}  // namespace

// deg: int32[n] out-degrees; pr, out: float32[n].
extern "C" int pr_pull(const void* indptr, const void* indices, long long n,
                       const void* deg, const void* pr, float base, float damp,
                       void* out, void* stream) {
  if (n > 0) {
    pr_pull_kernel<<<(unsigned)((32 * n + kThreads - 1) / kThreads), kThreads,
                     0, (cudaStream_t)stream>>>(
        (const long long*)indptr, (const int*)indices, n, (const int*)deg,
        (const float*)pr, base, damp, (float*)out);
  }
  return (int)cudaGetLastError();
}
