// K17 adg_round: one round of the approximate degeneracy ordering (ADG), in
// place on the device state deg (int64[n]), alive and peel (bool[n]).
//
// Replaces the body of the lax.while_loop in adg_ordering_rank_device
// (gms_tpu/preprocessing/degeneracy.py:178, the round at :215-250) except
// its ranking of the peeled vertices by (deg, id), which the wrapper does
// with one torch.sort of the peeled vertices' composite keys (gms_tpu's
// jnp.argsort inside the same program). Three kernels on the stream:
//   1. stats: over the alive vertices, Σ deg, min deg and their count
//      (int64 atomics, order-free);
//   2. mask: the boundary in float64 as gms_tpu's device version computes it
//      — avg: ((1 + eps) * Σ deg) / n_alive; min: (2 + eps) * min deg; or
//      the `bound` the wrapper drew for the sampled boundaries — and
//      peel = alive & (deg <= bound). gms_tpu's guard (peel the alive
//      vertices of minimum degree when nothing peels) needs no second pass:
//      something peels exactly when min deg <= bound, else the threshold is
//      min deg itself;
//   3. pull: a warp per alive vertex that stays walks its CSR row and
//      subtracts its peeled neighbours from deg; alive &= ~peel.
// The pull reads the CSR (indptr, indices), where gms_tpu gathers padded
// rows of the undirected graph: at RMAT-18 those would be 262,144 x 25,216
// int32 (26.4 GB) against the CSR's 30 MB.
//
// Bound on an H100 (3.35 TB/s): bytes — deg and alive read and written, peel
// written, and the indptr entries and CSR rows of the vertices the pull walks.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;

__global__ void init_stats(long long* stats) {
  stats[0] = 0;          // Σ deg over the alive vertices
  stats[1] = LLONG_MAX;  // min deg over the alive vertices
  stats[2] = 0;          // alive vertices
}

__global__ void stats_kernel(const long long* __restrict__ deg,
                             const unsigned char* __restrict__ alive,
                             long long n, long long* stats) {
  long long sum = 0, mn = LLONG_MAX, cnt = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (alive[i]) {
      const long long d = deg[i];
      sum += d;
      mn = d < mn ? d : mn;
      ++cnt;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, o);
    cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    const long long m = __shfl_down_sync(0xffffffffu, mn, o);
    mn = m < mn ? m : mn;
  }
  if ((threadIdx.x & 31) == 0 && cnt) {
    atomicAdd((unsigned long long*)stats, (unsigned long long)sum);
    atomicMin(stats + 1, mn);
    atomicAdd((unsigned long long*)(stats + 2), (unsigned long long)cnt);
  }
}

__global__ void mask_kernel(const long long* __restrict__ deg,
                            const unsigned char* __restrict__ alive,
                            unsigned char* __restrict__ peel, long long n,
                            const long long* __restrict__ stats, int mode,
                            double eps, double bound) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long mn = stats[1];
  double b = bound;
  if (mode == 0) b = (1.0 + eps) * (double)stats[0] / (double)stats[2];
  if (mode == 1) b = (2.0 + eps) * (double)mn;
  const double thr = (double)mn <= b ? b : (double)mn;
  peel[i] = alive[i] && (double)deg[i] <= thr;
}

__global__ void pull_kernel(const long long* __restrict__ indptr,
                            const int* __restrict__ indices, long long n,
                            long long* __restrict__ deg,
                            unsigned char* __restrict__ alive,
                            const unsigned char* __restrict__ peel) {
  const long long v = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (v >= n || !alive[v]) return;  // the whole warp
  if (peel[v]) {
    if (lane == 0) alive[v] = 0;
    return;
  }
  int c = 0;
  for (long long j = indptr[v] + lane; j < indptr[v + 1]; j += 32)
    c += peel[indices[j]];
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if (lane == 0) deg[v] -= c;
}

}  // namespace

// mode: 0 avg, 1 min, 2 the given `bound` (sampled boundaries).
extern "C" int adg_round(const void* indptr, const void* indices, long long n,
                         void* deg, void* alive, void* peel, void* stats,
                         int mode, double eps, double bound, void* stream) {
  if (n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    long long blocks = (n + kThreads - 1) / kThreads;
    init_stats<<<1, 1, 0, s>>>((long long*)stats);
    stats_kernel<<<(unsigned)(blocks < 1024 ? blocks : 1024), kThreads, 0,
                   s>>>((const long long*)deg, (const unsigned char*)alive, n,
                        (long long*)stats);
    mask_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const long long*)deg, (const unsigned char*)alive,
        (unsigned char*)peel, n, (const long long*)stats, mode, eps, bound);
    pull_kernel<<<(unsigned)((32 * n + kThreads - 1) / kThreads), kThreads,
                  0, s>>>((const long long*)indptr, (const int*)indices, n,
                          (long long*)deg, (unsigned char*)alive,
                          (const unsigned char*)peel);
  }
  return (int)cudaGetLastError();
}
