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
//   bfs_push      — the top-down step over `fcount` frontier ids, two
//                   launches. push_offsets_kernel sorts the frontier rows
//                   as graphs/row_schedule.py does: a row of 1 to kNarrow
//                   (8) entries is narrow, a longer one is cut into
//                   segments of at most kSegment (512) entries. It writes
//                   the exclusive scan of the rows' segment counts to
//                   seg_off (block_scan.cuh: a block scan a tile of 1,024
//                   rows, tiles taken by a ticket and chained by decoupled
//                   look-back, its status zeroed by a memset when the
//                   frontier spans several tiles) and the narrow rows' ids
//                   to narrow.
//                   bfs_push_kernel runs on a grid sized from the SMs, not
//                   from the data: it reads the totals from seg_off, deals
//                   the items (32 narrow rows, then each segment) to the
//                   warps in contiguous runs, and finds the row of a warp's
//                   first segment by a warp-wide search of seg_off. A warp
//                   loads an item's entries (a lane a narrow row, or a
//                   segment's 512 entries, 16 a lane) and their dist words
//                   at once, claims each neighbour still INF with
//                   atomicCAS(INF -> it + 1), and the lanes that win append
//                   it to next_ids (one atomicAdd a warp and item) and
//                   count it in next_count. So no warp walks more than one
//                   segment of a row at a time, and a wide row spreads over
//                   the card. The claimed vertices are exactly gms_tpu's
//                   scatter-min(it + 1) discoveries, so the next frontier
//                   needs no compaction. Nothing is read back.
// Bound on an H100: bytes — for the pull, indptr, each unreached row read to
// the entry that decides it, the dist words of the distinct neighbours read
// and dist written; for the push, the frontier's rows and their neighbours'
// dist words, the ids read and written.

#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "block_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kInf = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
// the push: entries a segment and of a narrow row (graphs/row_schedule.py's
// SEGMENT and NARROW), entries a lane of a segment, frontier rows a scan
// tile; a scan value packs a row's narrow count above its segments
constexpr int kSegment = 512;
constexpr int kNarrow = 8;
constexpr int kPerLane = kSegment / 32;
constexpr int kScanThreads = 1024;
constexpr int kNarrowShift = 31;
constexpr long long kSegMask = (1ll << kNarrowShift) - 1;

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

// seg_off[f] := the segments of frontier rows 0..f-1, seg_off[fcount] :=
// all of them, seg_off[fcount + 1] := the narrow rows, whose ids go to
// narrow in frontier order; *next_count := 0. A tile of kScanThreads rows
// a block; several tiles are taken by a ticket (ctl[0]) and chained by
// look-back over status (ctl + 1), both zeroed before the launch.
__global__ void __launch_bounds__(kScanThreads) push_offsets_kernel(
    const long long* __restrict__ indptr, const int* __restrict__ ids,
    long long fcount, long long* __restrict__ seg_off,
    int* __restrict__ narrow, unsigned long long* ctl,
    unsigned long long* next_count) {
  __shared__ long long ticket, carry;
  if (threadIdx.x == 0) {
    ticket = gridDim.x > 1 ? (long long)atomicAdd(ctl, 1ull) : 0;
    carry = 0;
    if (ticket == 0) *next_count = 0;
  }
  __syncthreads();
  const long long t = ticket;
  const long long f = t * kScanThreads + threadIdx.x;
  int v = 0;
  long long n = 0;
  if (f < fcount) {
    v = ids[f];
    const long long d = indptr[v + 1] - indptr[v];
    n = d > kNarrow ? (d + kSegment - 1) / kSegment
                    : (long long)(d > 0) << kNarrowShift;
  }
  long long off = block_scan(n, &carry);
  if (gridDim.x > 1)
    off += tile_prefix((volatile unsigned long long*)(ctl + 1), t, carry);
  if (f < fcount) {
    seg_off[f] = off & kSegMask;
    if (n >> kNarrowShift) narrow[off >> kNarrowShift] = v;
  }
  if (f == fcount - 1) {
    seg_off[fcount] = (off + n) & kSegMask;
    seg_off[fcount + 1] = (off + n) >> kNarrowShift;
  }
}

// The last f in [0, c) with off[f] <= t (off ascending, off[0] = 0 <= t),
// every lane of the warp: each round the lanes probe 32 points of the
// range, which shrinks it 32-fold.
__device__ __forceinline__ long long warp_row_of(const long long* off,
                                                 long long c, long long t,
                                                 int lane) {
  long long lo = 0, hi = c;
  while (hi - lo > 1) {
    const long long step = (hi - lo + 31) / 32;
    const long long at = lo + lane * step;
    const bool le = at < hi && off[at] <= t;
    const int last = 31 - __clz(__ballot_sync(kFull, le));  // lane 0: lo
    lo += last * step;
    hi = min(hi, lo + step);
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) bfs_push_kernel(
    const long long* __restrict__ indptr, const int* __restrict__ indices,
    const int* __restrict__ ids, long long fcount,
    const long long* __restrict__ seg_off, const int* __restrict__ narrow,
    int* __restrict__ dist, int it, int* __restrict__ next_ids,
    unsigned long long* __restrict__ next_count) {
  const long long segs = seg_off[fcount], nar = seg_off[fcount + 1];
  const long long nitems = (nar + 31) / 32, items = nitems + segs;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  const long long w = (blockIdx.x * (long long)kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long lo = items * w / warps, hi = items * (w + 1) / warps;
  long long f = -1;  // the frontier row of the warp's segment
  for (long long k = lo; k < hi; ++k) {
    int nb[kPerLane];
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) nb[r] = -1;
    if (k < nitems) {  // a lane a narrow row
      const long long i = 32 * k + lane;
      if (i < nar) {
        const int v = narrow[i];
        const long long a = indptr[v], d = indptr[v + 1] - a;
#pragma unroll
        for (int r = 0; r < kNarrow; ++r)
          if (r < d) nb[r] = __ldg(indices + a + r);
      }
    } else {  // segment s, 16 entries a lane
      const long long s = k - nitems;
      if (f < 0) f = warp_row_of(seg_off, fcount, s, lane);
      while (seg_off[f + 1] <= s) ++f;  // skips rows without segments
      const int v = ids[f];
      const long long row_hi = indptr[v + 1];
      const long long j0 = indptr[v] + (s - seg_off[f]) * kSegment + lane;
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) {
        const long long j = j0 + 32 * r;
        if (j < row_hi) nb[r] = __ldg(indices + j);
      }
    }
#pragma unroll
    for (int r = 0; r < kPerLane; ++r)
      if (nb[r] >= 0 && dist[nb[r]] != kInf) nb[r] = -1;
    unsigned won = 0;
#pragma unroll
    for (int r = 0; r < kPerLane; ++r)
      if (nb[r] >= 0 && atomicCAS(dist + nb[r], kInf, it + 1) == kInf)
        won |= 1u << r;
    // the warp's wins: one atomicAdd, each lane writing at its offset
    const int mine = __popc(won);
    int incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    if (total == 0) continue;
    unsigned long long base = 0;
    if (lane == 31) base = atomicAdd(next_count, (unsigned long long)total);
    base = __shfl_sync(kFull, base, 31) + (incl - mine);
#pragma unroll
    for (int r = 0; r < kPerLane; ++r)
      if ((won >> r) & 1u) next_ids[base++] = nb[r];
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

// ids: the fcount frontier vertices; next_ids: int32[n]; scratch:
// int64[4 + tiles + fcount + ceil(fcount / 2)], any contents: the next
// count (scratch[0], the step's output), the scan's ticket and its tiles'
// look-back status, the segment offsets [fcount + 2], the narrow rows
// (int32[fcount]); blocks: the push's grid (a multiple of the SMs).
extern "C" int bfs_push(const void* indptr, const void* indices,
                        const void* ids, long long fcount, void* dist, int it,
                        void* next_ids, void* scratch, int blocks,
                        void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (fcount == 0) return (int)cudaMemsetAsync(scratch, 0, 8, st);
  const long long tiles = (fcount + kScanThreads - 1) / kScanThreads;
  unsigned long long* next_count = (unsigned long long*)scratch;
  unsigned long long* ctl = next_count + 1;
  long long* seg_off = (long long*)(ctl + 1 + tiles);
  int* narrow = (int*)(seg_off + fcount + 2);
  if (tiles > 1) {
    const cudaError_t err =
        cudaMemsetAsync(ctl, 0, (1 + tiles) * sizeof(*ctl), st);
    if (err) return (int)err;
  }
  push_offsets_kernel<<<(unsigned)tiles, kScanThreads, 0, st>>>(
      (const long long*)indptr, (const int*)ids, fcount, seg_off, narrow, ctl,
      next_count);
  bfs_push_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const long long*)indptr, (const int*)indices, (const int*)ids, fcount,
      seg_off, narrow, (int*)dist, it, (int*)next_ids, next_count);
  return (int)cudaGetLastError();
}
