// K15 bitmap_edge_count and K16 bitmap_rows_count: popcounts of word
// combinations of bitmap rows.
//
// K15 replaces count_hub_edges (gms_tpu/algorithms/triangle_count.py:184),
// whose caller here is the dense-bitmap triangle count: Σ over edges e with
// valid[e] != 0 of valid[e] * popcount(rows[ra] & rows[rb]) over the first
// `width` words, where (ra, rb) are the edge's ends, or row_of of them when
// row_of is given. Indices clip into range, as gms_tpu's `mode="clip"`
// takes do.
// K16 replaces the counts of gms_tpu/sets/bitmap_ops.py (:22-49): int32[B] =
// popcount(a op b) per row, op in {a, a & b, a | b, a & ~b} (cardinality,
// intersect_count, union_count, difference_count). It is a fused elementwise
// pass plus a reduction, which Triton would serve as well; it stays in CUDA so
// that the port keeps one build path, and shares K15's word loop.
// Bit words arrive as int32 tensors holding gms_tpu's uint32 bits and are read
// here as unsigned.
//
// Design. K15 takes the edges in tiles of kTile consecutive edges, a block a
// tile. The block finds the runs of edges that share a source row ra (after
// row_of and the clip; an edge with valid == 0 belongs to no run), reads
// each run's row to `width` once, 16-byte loads where the width and the
// rows' alignment allow, and compacts its non-zero words into shared memory
// as (word index, word) pairs. Each edge of the run then takes kGroup lanes,
// which read row rb only at those word indices, AND and popcount, and
// multiply by valid. A run whose row has more non-zero words than half of
// `width`, or whose pairs pass the tile's kPairs, is dense: its edges take
// a warp each and K16's word loop over both rows. Edges in any order are
// exact; an unsorted list only makes runs shorter, and a run that crosses a
// tile boundary reads its row once a tile. Each block adds its int64 sum
// with one 64-bit atomicAdd, as K2 does. K16 is a warp per row; its lanes
// walk the words with neighbouring lanes on neighbouring words, 16-byte
// loads where the width and the rows' alignment allow, and reduce each row
// in the warp.
//
// Bound on an H100: K15 needs one AND+popcount for each word where both
// rows' words are non-zero, at 16 popcounts per clock per SM (4.18e12/s at
// 1,980 MHz), and its bytes are each distinct ra row read once to `width`,
// the distinct (rb, word) pairs at ra's non-zero words, the edges and
// valid. At RMAT-16's DAG rows (2,048 words, at most a few hundred bits) the
// bytes of the source rows bound it. K16 does one word operation and one
// popcount per word of each row; its bytes (a, b, out) bound it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "block_sum.cuh"

namespace {

template <int OP>
__device__ __forceinline__ unsigned combine(unsigned a, unsigned b) {
  if (OP == 0) return a;
  if (OP == 1) return a & b;
  if (OP == 2) return a | b;
  return a & ~b;
}

// This lane's share of Σ_w popcount(a[w] op b[w]), w < W.
template <int OP>
__device__ __forceinline__ int lane_popcount(const unsigned* a,
                                             const unsigned* b, int W,
                                             bool vec) {
  const int lane = threadIdx.x & 31;
  int acc = 0;
  if (vec) {
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    for (int i = lane; i < W / 4; i += 32) {
      const uint4 x = a4[i], y = b4[i];
      acc += __popc(combine<OP>(x.x, y.x)) + __popc(combine<OP>(x.y, y.y)) +
             __popc(combine<OP>(x.z, y.z)) + __popc(combine<OP>(x.w, y.w));
    }
  } else {
    for (int i = lane; i < W; i += 32) acc += __popc(combine<OP>(a[i], b[i]));
  }
  return acc;
}

__device__ __forceinline__ long long clip(long long i, long long n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// K15: edges a tile (one a thread); (word index, word) pairs a tile stages
// (16 KiB); words a staging unit (64 bytes); units a thread loads at once;
// non-zero words a thread keeps in registers; lanes an edge in the gather
constexpr int kTile = kThreads;
constexpr int kPairs = 2048;
constexpr int kUnit = 16;
constexpr int kBatch = 2;
constexpr int kKeep = 4;
constexpr int kGroup = 8;

// Words [kUnit s, kUnit s + kUnit) of row a, those at or past width read
// as 0.
__device__ __forceinline__ void load_unit(const unsigned* a, int s, int width,
                                          bool vec, unsigned* x) {
  const int i = kUnit * s;
  if (vec) {  // width % 4 == 0, a 16-byte aligned
    const uint4* a4 = reinterpret_cast<const uint4*>(a + i);
#pragma unroll
    for (int h = 0; h < kUnit / 4; ++h) {
      const uint4 y = i + 4 * h < width ? __ldg(a4 + h) : make_uint4(0, 0, 0, 0);
      x[4 * h] = y.x, x[4 * h + 1] = y.y, x[4 * h + 2] = y.z, x[4 * h + 3] = y.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kUnit; ++c) x[c] = i + c < width ? __ldg(a + i + c) : 0u;
  }
}

// The tile's edges, a thread each: runs of valid edges with one source row
// (a new run where ra differs from the previous edge's, or after an edge
// with valid == 0). Staging: all the runs' rows, cut into units of kUnit
// words (run-major), are dealt to the threads in contiguous ranges; each
// thread counts its units' non-zero words and keeps the first kKeep, one
// block scan gives its offset, and it writes its pairs (a thread with more
// reads its units again), so a run's pairs are contiguous and in word
// order. Gather: each edge of a sparse run takes kGroup lanes over its
// run's pairs, reading row rb only at those words; an edge of a dense run
// takes its warp and the word loop.
__global__ void __launch_bounds__(kThreads) edge_runs_kernel(
    const unsigned* __restrict__ rows, long long n_rows, long long hw,
    const int* __restrict__ row_of, long long n_row_of,
    const int* __restrict__ edges, const int* __restrict__ valid,
    long long E, int width, bool vec, unsigned long long* out) {
  __shared__ int key[kTile], rb_of[kTile], val[kTile], lo_of[kTile];
  __shared__ int hi_of[kTile], run_row[kTile], run_off[kTile + 1];
  __shared__ uint2 pair[kPairs];  // (word index, word)
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // tiles from the last: a CSR edge list ends with its low-degree sources,
  // whose short runs make the tiles that stage the most rows; started
  // first, they do not trail the launch
  const long long e = (gridDim.x - 1 - blockIdx.x) * (long long)kTile + tid;
  int ra = -1, rb = 0, v = 0;
  if (e < E) {
    v = valid[e];
    if (v != 0) {
      long long a = edges[2 * e], b = edges[2 * e + 1];
      if (row_of) {
        a = row_of[clip(a, n_row_of)];
        b = row_of[clip(b, n_row_of)];
      }
      ra = (int)clip(a, n_rows);
      rb = (int)clip(b, n_rows);
    }
  }
  key[tid] = ra;
  rb_of[tid] = rb;
  val[tid] = v;
  if (tid == 0) carry = 0;
  __syncthreads();
  const int head = ra >= 0 && (tid == 0 || key[tid - 1] != ra);
  const int r = block_scan(head, &carry) + head - 1;  // this edge's run
  if (head) run_row[r] = ra;
  const int runs = carry;
  __syncthreads();
  if (tid == 0) carry = 0;

  // staging: units [u0, u1) of the runs' rows (per a row), unit u being
  // word unit s of run q; a thread keeps its first kKeep non-zero words in
  // registers, and records its count before each run's first unit in
  // run_off. Most units are all zero and cost one OR.
  const int per = (width + kUnit - 1) / kUnit;
  const int units = runs * per, m = (units + kTile - 1) / kTile;
  const int u0 = min(units, tid * m), u1 = min(units, u0 + m);
  const int q0 = u0 / per, s0 = u0 - q0 * per;
  int nz = 0, keep_at[kKeep], q = q0, s = s0;
  unsigned keep_word[kKeep];
  for (int u = u0; u < u1; u += kBatch) {
    unsigned x[kBatch][kUnit];
    int uq[kBatch], us[kBatch];
#pragma unroll
    for (int h = 0; h < kBatch; ++h) {
      uq[h] = q, us[h] = s;
      if (u + h < u1)
        load_unit(rows + (long long)run_row[q] * hw, s, width, vec, x[h]);
      if (++s == per) s = 0, ++q;
    }
#pragma unroll
    for (int h = 0; h < kBatch; ++h) {
      if (u + h >= u1) break;
      if (us[h] == 0) run_off[uq[h]] = nz;
      unsigned any = 0;
#pragma unroll
      for (int c = 0; c < kUnit; ++c) any |= x[h][c];
      if (any == 0u) continue;
#pragma unroll
      for (int c = 0; c < kUnit; ++c)
        if (x[h][c] != 0u) {
#pragma unroll
          for (int j = 0; j < kKeep; ++j)
            if (j == nz) {
              keep_at[j] = kUnit * us[h] + c;
              keep_word[j] = x[h][c];
            }
          ++nz;
        }
    }
  }
  const int o = block_scan(nz, &carry);
  for (int r0 = (u0 + per - 1) / per; r0 * per < u1; ++r0) run_off[r0] += o;
  if (nz <= kKeep) {
#pragma unroll
    for (int j = 0; j < kKeep; ++j)
      if (j < nz && o + j < kPairs) {
        pair[o + j] = make_uint2(keep_at[j], keep_word[j]);
      }
  } else {  // more than kKeep: the units again (in L1 or L2)
    int at = o;
    q = q0, s = s0;
    for (int u = u0; u < u1 && at < kPairs; ++u) {
      unsigned x[kUnit];
      load_unit(rows + (long long)run_row[q] * hw, s, width, vec, x);
#pragma unroll
      for (int c = 0; c < kUnit; ++c)
        if (x[c] != 0u) {
          if (at < kPairs) pair[at] = make_uint2(kUnit * s + c, x[c]);
          ++at;
        }
      if (++s == per) s = 0, ++q;
    }
  }
  if (tid == 0) run_off[runs] = carry;
  __syncthreads();
  // each edge's pairs [lo, hi); hi = -1 for a dense run's edge, -2 for an
  // edge with valid == 0
  int lo = 0, hi = -2;
  if (ra >= 0) {
    lo = run_off[r], hi = run_off[r + 1];
    if (hi > kPairs || 2 * (hi - lo) > width) hi = -1;
  }
  lo_of[tid] = lo;
  hi_of[tid] = hi;
  __syncthreads();

  long long acc = 0;
  const int gl = lane & (kGroup - 1);
  for (int p = tid / kGroup; p < kTile; p += kTile / kGroup) {
    const int end = hi_of[p];
    if (end < 0) continue;
    const unsigned* b = rows + (long long)rb_of[p] * hw;
    int c = 0;
#pragma unroll 4
    for (int k = lo_of[p] + gl; k < end; k += kGroup)
      c += __popc(pair[k].y & __ldg(b + pair[k].x));
    acc += (long long)c * val[p];
  }
  // a dense run's edges: the warp of their threads, an edge at a time, the
  // word loop
  for (unsigned d = __ballot_sync(0xffffffffu, hi == -1); d; d &= d - 1) {
    const int j = __ffs(d) - 1;
    const long long a = __shfl_sync(0xffffffffu, ra, j);
    const long long b = __shfl_sync(0xffffffffu, rb, j);
    acc += (long long)lane_popcount<1>(rows + a * hw, rows + b * hw, width,
                                       vec) * __shfl_sync(0xffffffffu, v, j);
  }
  block_sum_add(acc, out);
}

template <int OP>
__global__ void rows_kernel(const unsigned* __restrict__ a,
                            const unsigned* __restrict__ b, long long B, int W,
                            bool vec, int* __restrict__ out) {
  const long long r = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (r >= B) return;  // the whole warp
  int c = lane_popcount<OP>(a + r * W, b + r * W, W, vec);
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) out[r] = c;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" int bitmap_edge_count(const void* rows, long long n_rows,
                                 long long hw, const void* row_of,
                                 long long n_row_of, const void* edges,
                                 const void* valid, long long E, int width,
                                 void* out, void* stream) {
  if (E > 0 && n_rows > 0 && width > 0) {
    const bool vec = hw % 4 == 0 && width % 4 == 0 && aligned16(rows);
    const long long blocks = (E + kTile - 1) / kTile;
    edge_runs_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)rows, n_rows, hw, (const int*)row_of, n_row_of,
        (const int*)edges, (const int*)valid, E, width, vec,
        (unsigned long long*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int bitmap_rows_count(const void* a, const void* b, long long B,
                                 int W, int op, void* out, void* stream) {
  if (B > 0 && W > 0) {
    const bool vec = W % 4 == 0 && aligned16(a) && aligned16(b);
    const unsigned blocks = (unsigned)((B + kWarps - 1) / kWarps);
    const cudaStream_t s = (cudaStream_t)stream;
    const unsigned* ua = (const unsigned*)a;
    const unsigned* ub = (const unsigned*)b;
    switch (op) {
      case 0: rows_kernel<0><<<blocks, kThreads, 0, s>>>(ua, ub, B, W, vec, (int*)out); break;
      case 1: rows_kernel<1><<<blocks, kThreads, 0, s>>>(ua, ub, B, W, vec, (int*)out); break;
      case 2: rows_kernel<2><<<blocks, kThreads, 0, s>>>(ua, ub, B, W, vec, (int*)out); break;
      case 3: rows_kernel<3><<<blocks, kThreads, 0, s>>>(ua, ub, B, W, vec, (int*)out); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
