// K33 cc_step and sssp_step: one synchronous (Jacobi) min step over CSR rows
// read to their degree, with a changed flag — the loop bodies of
// gms_tpu/algorithms/gapbs.py `_cc` (:245, min-label propagation) and
// `_sssp` (:275, Bellman-Ford):
//   cc_step:   nxt[v] = min(cur[v], min over w in row v of cur[w])   int32
//   sssp_step: nxt[v] = min(cur[v], min over slots j of row v of
//                           cur[indices[j]] + weight[j])             int64
// with weight[j] = 1 when `weights` is null. Each reads only `cur` and writes
// a fresh `nxt` (double buffering), so the wrapper's loop takes gms_tpu's
// round count; both fixpoints are unique, so the results are exact either
// way. SSSP's unreached value big = int64 max / 4 leaves room for any int32
// weight. `changed` (int32[1], zeroed by the caller) is set when any value
// moved: a round reads back 4 bytes.
//
// A warp a vertex, a shuffle tree for the row's min. Bound on an H100:
// bytes — indptr, indices (and weights) once, cur of each distinct
// neighbour and of v, nxt written.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void cc_step_kernel(const long long* __restrict__ indptr,
                               const int* __restrict__ indices, long long n,
                               const int* __restrict__ cur,
                               int* __restrict__ nxt,
                               int* __restrict__ changed) {
  const long long v = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (v >= n) return;
  const int own = cur[v];
  int m = own;
  for (long long j = indptr[v] + lane; j < indptr[v + 1]; j += 32) {
    const int c = cur[indices[j]];
    m = c < m ? c : m;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const int t = __shfl_xor_sync(0xffffffffu, m, o);
    m = t < m ? t : m;
  }
  if (lane == 0) {
    nxt[v] = m;
    if (m != own) *changed = 1;
  }
}

__global__ void sssp_step_kernel(const long long* __restrict__ indptr,
                                 const int* __restrict__ indices,
                                 const int* __restrict__ weights, long long n,
                                 const long long* __restrict__ cur,
                                 long long* __restrict__ nxt,
                                 int* __restrict__ changed) {
  const long long v = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (v >= n) return;
  const long long own = cur[v];
  long long m = own;
  for (long long j = indptr[v] + lane; j < indptr[v + 1]; j += 32) {
    const long long c = cur[indices[j]] + (weights ? weights[j] : 1);
    m = c < m ? c : m;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const long long t = __shfl_xor_sync(0xffffffffu, m, o);
    m = t < m ? t : m;
  }
  if (lane == 0) {
    nxt[v] = m;
    if (m != own) *changed = 1;
  }
}

inline unsigned warps_blocks(long long n) {
  return (unsigned)((32 * n + kThreads - 1) / kThreads);
}

}  // namespace

// cur, nxt: int32[n]; changed: int32[1], zeroed by the caller.
extern "C" int cc_step(const void* indptr, const void* indices, long long n,
                       const void* cur, void* nxt, void* changed,
                       void* stream) {
  if (n > 0) {
    cc_step_kernel<<<warps_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)indptr, (const int*)indices, n, (const int*)cur,
        (int*)nxt, (int*)changed);
  }
  return (int)cudaGetLastError();
}

// weights: int32[E] or null (unit); cur, nxt: int64[n]; changed: int32[1].
extern "C" int sssp_step(const void* indptr, const void* indices,
                         const void* weights, long long n, const void* cur,
                         void* nxt, void* changed, void* stream) {
  if (n > 0) {
    sssp_step_kernel<<<warps_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)indptr, (const int*)indices, (const int*)weights, n,
        (const long long*)cur, (long long*)nxt, (int*)changed);
  }
  return (int)cudaGetLastError();
}
