// K29 bfs_pull and K30 frontier_ids + bfs_push: the BFS levels of
// gms_tpu/algorithms/gapbs.py `_bfs_dense` (:85) and `_bfs_dopt` (:108),
// over CSR rows (indptr int64[n + 1], indices int32[E]) read to each row's
// degree, where gms_tpu reads padded rows int32[V_pad, D_pad] whole.
//
// dist int32[n] holds the hop distances, INF (int32 max) where unreached;
// level `it`'s frontier is the vertices with dist == it.
//   bfs_pull      — the bottom-up step: a warp a vertex with dist == INF
//                   scans its row 32 entries at a time until a neighbour
//                   has dist == it, then sets dist = it + 1. In place, which
//                   is safe: the only writes are it + 1 != it, so no reader
//                   mistakes a vertex reached this level for the frontier.
//                   Blocks sum the vertices reached into count (int64[1],
//                   zeroed by the caller), the next level's frontier size.
//   frontier_ids  — compacts the vertices with dist == it into ids (any
//                   order: the push is an idempotent scatter-min) and their
//                   number into count, one atomicAdd a warp (warp_append).
//   bfs_push      — the top-down step over `fcount` frontier ids: a warp a
//                   frontier row; each neighbour still INF is claimed with
//                   atomicCAS(INF -> it + 1), and the lanes that win append
//                   it to next_ids (one atomicAdd a warp and 32 entries)
//                   and count it in next_count. The claimed
//                   vertices are exactly gms_tpu's scatter-min(it + 1)
//                   discoveries, so the next frontier needs no compaction.
// Bound on an H100: bytes — for the pull, indptr, each unreached row read to
// the entry that decides it, the dist words of the distinct neighbours read
// and dist written; for the push, the frontier's rows and their neighbours'
// dist words, the ids read and written.

#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kInf = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__global__ void bfs_pull_kernel(const long long* __restrict__ indptr,
                                const int* __restrict__ indices, long long n,
                                int* __restrict__ dist, int it,
                                unsigned long long* __restrict__ count) {
  const long long v = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  long long reached = 0;
  if (v < n && dist[v] == kInf) {
    const long long e = indptr[v + 1];
    for (long long base = indptr[v]; base < e; base += 32) {
      const long long j = base + lane;
      const bool hit = j < e && dist[indices[j]] == it;
      if (__any_sync(kFull, hit)) {
        if (lane == 0) {
          dist[v] = it + 1;
          reached = 1;
        }
        break;
      }
    }
  }
  block_sum_add(reached, count);
}

// Appends `v` to out (when `take`) with one atomicAdd on count a warp: the
// leader reserves the warp's slots, each lane writes at its rank. Every lane
// of the warp must call it.
__device__ __forceinline__ void warp_append(bool take, int v, int* out,
                                            unsigned long long* count) {
  const unsigned mask = __ballot_sync(kFull, take);
  if (mask == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  unsigned long long base = 0;
  if (lane == leader) base = atomicAdd(count, (unsigned long long)__popc(mask));
  base = __shfl_sync(kFull, base, leader);
  if (take) out[base + __popc(mask & ((1u << lane) - 1u))] = v;
}

__global__ void frontier_ids_kernel(const int* __restrict__ dist, long long n,
                                    int it, int* __restrict__ ids,
                                    unsigned long long* __restrict__ count) {
  const long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  warp_append(v < n && dist[v] == it, (int)v, ids, count);
}

__global__ void bfs_push_kernel(const long long* __restrict__ indptr,
                                const int* __restrict__ indices,
                                const int* __restrict__ ids, long long fcount,
                                int* __restrict__ dist, int it,
                                int* __restrict__ next_ids,
                                unsigned long long* __restrict__ next_count) {
  const long long f = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (f >= fcount) return;
  const int v = ids[f];
  const long long e = indptr[v + 1];
  for (long long base = indptr[v]; base < e; base += 32) {
    const long long j = base + lane;
    const int w = j < e ? indices[j] : 0;
    const bool won = j < e && dist[w] == kInf &&
                     atomicCAS(dist + w, kInf, it + 1) == kInf;
    warp_append(won, w, next_ids, next_count);
  }
}

inline unsigned blocks_for(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

// count: int64[1], zeroed by the caller.
extern "C" int bfs_pull(const void* indptr, const void* indices, long long n,
                        void* dist, int it, void* count, void* stream) {
  if (n > 0) {
    bfs_pull_kernel<<<blocks_for(32 * n), kThreads, 0,
                      (cudaStream_t)stream>>>(
        (const long long*)indptr, (const int*)indices, n, (int*)dist, it,
        (unsigned long long*)count);
  }
  return (int)cudaGetLastError();
}

// ids: int32[n]; count: int64[1], zeroed by the caller.
extern "C" int frontier_ids(const void* dist, long long n, int it, void* ids,
                            void* count, void* stream) {
  if (n > 0) {
    frontier_ids_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)dist, n, it, (int*)ids, (unsigned long long*)count);
  }
  return (int)cudaGetLastError();
}

// ids: the fcount frontier vertices; next_ids: int32[n]; next_count:
// int64[1], zeroed by the caller.
extern "C" int bfs_push(const void* indptr, const void* indices,
                        const void* ids, long long fcount, void* dist, int it,
                        void* next_ids, void* next_count, void* stream) {
  if (fcount > 0) {
    bfs_push_kernel<<<blocks_for(32 * fcount), kThreads, 0,
                      (cudaStream_t)stream>>>(
        (const long long*)indptr, (const int*)indices, (const int*)ids,
        fcount, (int*)dist, it, (int*)next_ids,
        (unsigned long long*)next_count);
  }
  return (int)cudaGetLastError();
}
