// K31 bfs_kbit_pull: the pull BFS level of gms_tpu/algorithms/gapbs.py
// `_bfs_kbit` (:185), computed from the k-bit packed words every level
// (the Log(Graph) compute-from-compressed experiment): the rows are never
// materialized.
//
// packed uint32[V_pad, W] holds row v's neighbours at k bits each, lane
// j < deg[v] decoded by kbit_lane (kbit_lane.cuh, K28's arithmetic). As
// bfs_pull (K29): a warp a vertex v < n with dist == INF decodes its lanes
// 32 at a time until a neighbour has dist == it, then sets it + 1 in place
// (safe, the writes are it + 1 != it); blocks sum the vertices reached into
// count (int64[1], zeroed by the caller). Bound on an H100: bytes — deg, each
// unreached row's words up to the lane that decides it, the dist words of
// the distinct neighbours read and dist written.

#include <cuda_runtime.h>

#include "block_sum.cuh"
#include "kbit_lane.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kInf = 0x7fffffff;

__global__ void bfs_kbit_pull_kernel(const unsigned* __restrict__ packed,
                                     int W, const int* __restrict__ deg,
                                     long long n, int k,
                                     int* __restrict__ dist, int it,
                                     unsigned long long* __restrict__ count) {
  const long long v = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  long long reached = 0;
  if (v < n && dist[v] == kInf) {
    const unsigned* row = packed + v * W;
    const int d = deg[v];
    for (int base = 0; base < d; base += 32) {
      const int j = base + lane;
      int w = -1;
      if (j < d) w = kbit_lane(row, W, j, k);
      const bool hit = w >= 0 && w < n && dist[w] == it;
      if (__any_sync(0xffffffffu, hit)) {
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

}  // namespace

// packed: uint32[>= n, W]; deg: int32[>= n]; dist: int32[n].
extern "C" int bfs_kbit_pull(const void* packed, int W, const void* deg,
                             long long n, int k, void* dist, int it,
                             void* count, void* stream) {
  if (n > 0) {
    bfs_kbit_pull_kernel<<<(unsigned)((32 * n + kThreads - 1) / kThreads),
                           kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)packed, W, (const int*)deg, n, k, (int*)dist, it,
        (unsigned long long*)count);
  }
  return (int)cudaGetLastError();
}
