// K37 expand_level: one breadth-wise expansion of k-clique items, the
// surviving children compacted in (item, i) order into `cap` rows.
//
// Replaces gms_tpu/algorithms/k_clique.py:161 expand_level. For item n with
// bitset S[n] (ww words) and r = clip(R[n], 0, C-1), every set bit i of
// S[n] gives the child S[n] & adj[r, i]; it survives iff its popcount is at
// least `need`. The survivors, in (item, i) order, fill S_out[0..) with
// R_out = R[n], up to `cap` rows; rows beyond the survivors stay as the
// caller zeroed them. stats[0] = the survivors (all of them, also beyond
// cap), stats[1] = the sum of their popcounts.
//
// gms_tpu materialises every child in a dense [N, W, WW] tensor and
// compacts with one argsort. Here no child is stored before its row of
// S_out: three passes over tiles of kTile items,
//   count_kernel, a block a tile, a warp an item, a lane a bit of S[n]:
//     each lane ANDs its child and counts it; per item the survivors
//     (counts[n]), per tile their sum, added to stats with one 64-bit
//     atomicAdd a tile (order-free, so exact);
//   scan_tiles_kernel, one block: the tiles' sums scanned (block_scan.cuh);
//   write_kernel, a block a tile: the tile's counts scanned from its
//     offset into shared memory, then each warp forms its item's children
//     again and writes each survivor at its offset plus its rank among the
//     item's survivors (a ballot, in bit order).
//
// Bound on an H100: the larger of bytes over 3.35 TB/s (S and R read once,
// each adj row the items need read once, the survivors' rows of S_out and
// R_out written once) and word operations (ww AND+popcounts for each set
// bit of S) at 16 a clock per SM. The children are formed twice, and a
// lane's adj row is a dependent, uncoalesced ww-word load.

#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;  // items per tile
constexpr int kScanThreads = 1024;

__device__ __forceinline__ long long clip_root(int r, long long c) {
  return r < 0 ? 0 : (r >= c ? c - 1 : r);
}

// popcount of S_n & adj_r[i] over ww words
__device__ __forceinline__ int child_count(const unsigned* Sn,
                                           const unsigned* Ai, int ww) {
  int pc = 0;
  for (int x = 0; x < ww; ++x) pc += __popc(Sn[x] & __ldg(Ai + x));
  return pc;
}

__global__ void count_kernel(const unsigned* __restrict__ S,
                             const int* __restrict__ R, long long n_items,
                             const unsigned* __restrict__ adj, long long c,
                             int ww, int need, int* __restrict__ counts,
                             long long* __restrict__ tile_sums,
                             unsigned long long* __restrict__ stats) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = 32 * ww;
  const long long first = (long long)blockIdx.x * kTile;
  long long kept = 0, pcs = 0;  // lane 0 of each warp: its items' sums
  for (int j = warp; j < kTile; j += kWarps) {
    const long long n = first + j;
    if (n >= n_items) break;
    const unsigned* Sn = S + n * ww;
    const unsigned* A = adj + clip_root(R[n], c) * W * ww;
    int cnt = 0;
    long long pc_sum = 0;
    for (int w = 0; w < ww; ++w) {
      const unsigned word = Sn[w];
      bool ok = false;
      int pc = 0;
      if ((word >> lane) & 1u) {
        pc = child_count(Sn, A + (long long)(32 * w + lane) * ww, ww);
        ok = pc >= need;
      }
      cnt += __popc(__ballot_sync(kFull, ok));
      pc_sum += ok ? pc : 0;
    }
    for (int o = 16; o > 0; o >>= 1)
      pc_sum += __shfl_down_sync(kFull, pc_sum, o);
    if (lane == 0) {
      counts[n] = cnt;
      kept += cnt;
      pcs += pc_sum;
    }
  }
  __shared__ long long red[2][kWarps];
  if (lane == 0) {
    red[0][warp] = kept;
    red[1][warp] = pcs;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long k = 0, p = 0;
    for (int x = 0; x < kWarps; ++x) {
      k += red[0][x];
      p += red[1][x];
    }
    tile_sums[blockIdx.x] = k;
    if (k) {
      atomicAdd(stats, (unsigned long long)k);
      atomicAdd(stats + 1, (unsigned long long)p);
    }
  }
}

// One block: tile_sums := their exclusive offsets.
__global__ void scan_tiles_kernel(long long n_tiles,
                                  long long* __restrict__ tile_sums) {
  __shared__ long long carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < n_tiles; base += blockDim.x) {
    const long long t = base + threadIdx.x;
    const long long v = t < n_tiles ? tile_sums[t] : 0;
    const long long off = block_scan(v, &carry);
    if (t < n_tiles) tile_sums[t] = off;
  }
}

__global__ void write_kernel(const unsigned* __restrict__ S,
                             const int* __restrict__ R, long long n_items,
                             const unsigned* __restrict__ adj, long long c,
                             int ww, int need,
                             const int* __restrict__ counts,
                             const long long* __restrict__ tile_offsets,
                             long long cap, unsigned* __restrict__ S_out,
                             int* __restrict__ R_out) {
  __shared__ long long off[kTile];
  __shared__ long long carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = 32 * ww;
  const long long first = (long long)blockIdx.x * kTile;
  if (threadIdx.x == 0) carry = tile_offsets[blockIdx.x];
  __syncthreads();
  for (int j0 = 0; j0 < kTile; j0 += kThreads) {
    const long long n = first + j0 + threadIdx.x;
    const long long v = n < n_items ? counts[n] : 0;
    off[j0 + threadIdx.x] = block_scan(v, &carry);
  }
  __syncthreads();
  for (int j = warp; j < kTile; j += kWarps) {
    const long long n = first + j;
    if (n >= n_items) break;
    long long pos = off[j];
    if (pos >= cap) break;  // this item's and every later item's rows
    const unsigned* Sn = S + n * ww;
    const int r = R[n];
    const unsigned* A = adj + clip_root(r, c) * W * ww;
    for (int w = 0; w < ww && pos < cap; ++w) {
      const unsigned word = Sn[w];
      bool ok = false;
      const unsigned* Ai = A + (long long)(32 * w + lane) * ww;
      if ((word >> lane) & 1u) ok = child_count(Sn, Ai, ww) >= need;
      const unsigned hit = __ballot_sync(kFull, ok);
      const long long p = pos + __popc(hit & ((1u << lane) - 1u));
      if (ok && p < cap) {
        unsigned* row = S_out + p * ww;
        for (int x = 0; x < ww; ++x) row[x] = Sn[x] & __ldg(Ai + x);
        R_out[p] = r;
      }
      pos += __popc(hit);
    }
  }
}

}  // namespace

// S: int32[n_items, ww]; R: int32[n_items]; adj: int32[c, 32*ww, ww];
// counts: int32[n_items] and tile_sums: int64[n_tiles], n_tiles =
// ceil(n_items / 1024), scratch; S_out: int32[cap, ww] and R_out:
// int32[cap], zeroed by the caller; stats: int64[2] zeros.
extern "C" int expand_level(const void* S, const void* R, long long n_items,
                            const void* adj, long long c, int ww, int need,
                            long long cap, void* counts, void* tile_sums,
                            long long n_tiles, void* S_out, void* R_out,
                            void* stats, void* stream) {
  if (n_items <= 0 || ww <= 0 || c <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  count_kernel<<<(unsigned)n_tiles, kThreads, 0, st>>>(
      (const unsigned*)S, (const int*)R, n_items, (const unsigned*)adj, c, ww,
      need, (int*)counts, (long long*)tile_sums, (unsigned long long*)stats);
  if (cap > 0) {
    scan_tiles_kernel<<<1, kScanThreads, 0, st>>>(n_tiles,
                                                   (long long*)tile_sums);
    write_kernel<<<(unsigned)n_tiles, kThreads, 0, st>>>(
        (const unsigned*)S, (const int*)R, n_items, (const unsigned*)adj, c,
        ww, need, (const int*)counts, (const long long*)tile_sums, cap,
        (unsigned*)S_out, (int*)R_out);
  }
  return (int)cudaGetLastError();
}
