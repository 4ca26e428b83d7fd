// K17 adg_round: one round of the approximate degeneracy ordering (ADG), in
// place on the device state deg (int64[n]), alive and peel (bool[n]).
//
// Replaces the body of the lax.while_loop in adg_ordering_rank_device
// (gms_tpu/preprocessing/degeneracy.py:178, the round at :215-250) except
// its ranking of the peeled vertices by (deg, id), which the wrapper does
// with one torch.sort of the peeled vertices' composite keys (gms_tpu's
// jnp.argsort inside the same program). One cooperative launch a round
// (cudaLaunchCooperativeKernel, every block resident, the grid from the
// occupancy calculator), three phases between two grid barriers:
//   1. stats: over the alive vertices, Σ deg, min deg and their count, a
//      block's partials to scratch (int64, order-free); block 0 zeroes the
//      item count;
//   2. mask: every block sums the partials and computes the boundary in
//      float64 as gms_tpu's device version does — avg: ((1 + eps) * Σ deg)
//      / n_alive; min: (2 + eps) * min deg; or the `bound` the wrapper drew
//      for the sampled boundaries — and peel = alive & (deg <= thr), thr =
//      the boundary, or min deg itself when the boundary is below it
//      (gms_tpu's guard: the alive vertices of minimum degree peel when
//      nothing else does). A vertex that stays with a row of more than
//      kThreadRow entries appends its row's pieces of at most kPiece
//      entries to a work list (a block scan, one atomicAdd a block);
//   3. pull: a warp a piece counts its peeled entries and subtracts them
//      from deg (atomically where the row has several pieces: integer adds,
//      order-free and exact); then a thread a vertex clears alive for the
//      peeled ones and walks a staying row of at most kThreadRow entries
//      itself.
// peel is complete before any pull reads it, and the pull reads no deg or
// alive of another vertex, so no state is double-buffered. A dead vertex
// costs one alive byte a phase; the largest row (25,196 entries at RMAT-18)
// is 50 pieces across 50 warps, not one warp's walk.
// The pull reads the CSR (indptr, indices), where gms_tpu gathers padded
// rows of the undirected graph: at RMAT-18 those would be 262,144 x 25,216
// int32 (26.4 GB) against the CSR's 30 MB.
//
// Bound on an H100 (3.35 TB/s): bytes — deg and alive read and written, peel
// written, and the indptr entries and CSR rows of the vertices the pull walks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>

#include "block_scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 3;
constexpr int kThreadRow = 16;  // a staying row this short: its own thread
constexpr int kPiece = 512;     // longer rows: pieces of this many, a warp each

__device__ __forceinline__ void warp_stats(long long& sum, long long& mn,
                                           long long& cnt) {
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, o);
    cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    const long long m = __shfl_down_sync(0xffffffffu, mn, o);
    mn = m < mn ? m : mn;
  }
}

// The block's (Σ, min, count) of its threads' values, to thread 0.
__device__ void block_stats(long long& sum, long long& mn, long long& cnt) {
  __shared__ long long red[3][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_stats(sum, mn, cnt);
  if (lane == 0) {
    red[0][warp] = sum;
    red[1][warp] = mn;
    red[2][warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      sum += red[0][w];
      mn = red[1][w] < mn ? red[1][w] : mn;
      cnt += red[2][w];
    }
  }
  __syncthreads();
}

// scratch (int64): [0] the item count, [1, 1 + 3 gridDim) the blocks'
// partials, then the items, (vertex << 32) | piece, at most n + E / 512 + 1.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    adg_round_kernel(const long long* __restrict__ indptr,
                     const int* __restrict__ indices, long long n,
                     long long* deg, unsigned char* alive,
                     unsigned char* peel, long long* scratch, int mode,
                     double eps, double bound) {
  cg::grid_group grid = cg::this_grid();
  unsigned long long* count = (unsigned long long*)scratch;
  long long* partial = scratch + 1;
  unsigned long long* items =
      (unsigned long long*)(scratch + 1 + 3 * (long long)gridDim.x);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = blockIdx.x * (long long)kThreads + threadIdx.x;
  __shared__ double thr_s;
  __shared__ long long carry;
  __shared__ unsigned long long base_s;

  // 1. stats
  long long sum = 0, mn = LLONG_MAX, cnt = 0;
  for (long long v = first; v < n; v += stride) {
    if (alive[v]) {
      const long long d = deg[v];
      sum += d;
      mn = d < mn ? d : mn;
      ++cnt;
    }
  }
  block_stats(sum, mn, cnt);
  if (threadIdx.x == 0) {
    partial[3 * blockIdx.x] = sum;
    partial[3 * blockIdx.x + 1] = mn;
    partial[3 * blockIdx.x + 2] = cnt;
    if (blockIdx.x == 0) *count = 0ull;
  }
  grid.sync();

  // 2. the boundary (every block the same), the mask, the work list
  sum = 0, mn = LLONG_MAX, cnt = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    sum += __ldcg(partial + 3 * b);
    const long long m = __ldcg(partial + 3 * b + 1);
    mn = m < mn ? m : mn;
    cnt += __ldcg(partial + 3 * b + 2);
  }
  block_stats(sum, mn, cnt);
  if (threadIdx.x == 0) {
    double b = bound;
    if (mode == 0) b = (1.0 + eps) * (double)sum / (double)cnt;
    if (mode == 1) b = (2.0 + eps) * (double)mn;
    thr_s = (double)mn <= b ? b : (double)mn;
  }
  __syncthreads();
  const double thr = thr_s;
  for (long long vb = blockIdx.x * (long long)kThreads; vb < n; vb += stride) {
    const long long v = vb + threadIdx.x;
    long long pieces = 0;
    if (v < n) {
      const bool live = alive[v];
      const bool p = live && (double)deg[v] <= thr;
      peel[v] = p;
      if (live && !p) {
        const long long len = indptr[v + 1] - indptr[v];
        if (len > kThreadRow) pieces = (len + kPiece - 1) / kPiece;
      }
    }
    if (threadIdx.x == 0) carry = 0;
    __syncthreads();
    const long long off = block_scan(pieces, &carry);
    if (threadIdx.x == 0)
      base_s = carry ? atomicAdd(count, (unsigned long long)carry) : 0ull;
    __syncthreads();
    for (long long q = 0; q < pieces; ++q)
      items[base_s + off + q] = ((unsigned long long)v << 32) | q;
  }
  grid.sync();

  // 3. pull: the pieces a warp each, then the short rows a thread each
  const int lane = threadIdx.x & 31;
  const long long n_items = (long long)__ldcg((const long long*)count);
  for (long long it = first >> 5; it < n_items; it += stride >> 5) {
    const unsigned long long x = __ldcg((const long long*)items + it);
    const long long v = (long long)(x >> 32);
    const long long a = indptr[v], e = indptr[v + 1];
    const long long s = a + (long long)(x & 0xffffffffull) * kPiece;
    const long long end = s + kPiece < e ? s + kPiece : e;
    int c = 0;
#pragma unroll 4
    for (long long j = s + lane; j < end; j += 32) c += peel[indices[j]];
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
    if (lane == 0 && c) {
      if (e - a <= kPiece)
        deg[v] -= c;
      else
        atomicAdd((unsigned long long*)(deg + v),
                  (unsigned long long)(-(long long)c));
    }
  }
  for (long long v = first; v < n; v += stride) {
    if (!alive[v]) continue;
    if (peel[v]) {
      alive[v] = 0;
      continue;
    }
    const long long a = indptr[v], e = indptr[v + 1];
    if (e - a > kThreadRow) continue;
    int c = 0;
#pragma unroll 4
    for (long long j = a; j < e; ++j) c += peel[indices[j]];
    if (c) deg[v] -= c;
  }
}

}  // namespace

// mode: 0 avg, 1 min, 2 the given `bound` (sampled boundaries). scratch:
// int64[1 + 3 max_blocks + n + E / 512 + 1] (see adg_round_kernel); the grid
// is at most max_blocks. Returns cudaErrorCooperativeLaunchTooLarge when no
// block fits.
extern "C" int adg_round(const void* indptr, const void* indices, long long n,
                         void* deg, void* alive, void* peel, void* scratch,
                         int max_blocks, int mode, double eps, double bound,
                         void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  static int grid_of[64];  // resident blocks in all, by device
  int device = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return (int)e;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (grid_of[device] == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, adg_round_kernel, kThreads, 0)) != cudaSuccess)
      return (int)e;
    if (per_sm > kBlocksPerSm) per_sm = kBlocksPerSm;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    grid_of[device] = per_sm * sms;
  }
  const int blocks = grid_of[device] < max_blocks ? grid_of[device]
                                                  : max_blocks;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  const long long* ip = (const long long*)indptr;
  const int* ix = (const int*)indices;
  long long* d = (long long*)deg;
  unsigned char* al = (unsigned char*)alive;
  unsigned char* pe = (unsigned char*)peel;
  long long* sc = (long long*)scratch;
  void* args[] = {&ip, &ix, &n, &d, &al, &pe, &sc, &mode, &eps, &bound};
  e = cudaLaunchCooperativeKernel((const void*)adg_round_kernel, dim3(blocks),
                                  dim3(kThreads), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
