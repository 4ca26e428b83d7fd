// K34 bc_forward and bc_backward: Brandes' betweenness centrality over a
// batch of B <= 64 sources, the steps of gms_tpu/algorithms/gapbs.py
// `_bc_one_source` (:337) vmapped by `_bc_batched` (:375), over CSR rows
// read to their degree. A multi-source BFS (Then et al., VLDB 2015): bit b
// of a 64-bit word stands for source b.
//   lvl    uint64[max_depth + 1, n]: bit b of lvl[d][v] is set when
//          dist[b, v] == d (the sources' bits in lvl[0]);
//   seen   uint64[n]: the pairs reached so far, and the bits of unused
//          sources (b >= B), so that ~seen[v] is v's unreached live pairs;
//   sigma, delta float32[n, 64], vertex-major: a vertex's 64 sources' words
//          are one 256-byte row.
//   bc_forward(it)  — for each unreached pair (b, v): s = the sum of
//                     sigma[w, b] over the row's w with bit b in lvl[it][w];
//                     if s > 0, the bit goes into lvl[it+1][v] and seen[v]
//                     and sigma[v, b] = s (gms_tpu's `new = (dist == INF) &
//                     (s > 0)`).
//   bc_backward(it) — for each pair (b, v) in lvl[it]: delta[v, b] = the
//                     sum over the row's w with bit b in lvl[it+1][w] and
//                     sigma[w, b] > 0 of sigma[v, b] / max(sigma[w, b],
//                     1e-30) * (1 + delta[w, b]), in gms_tpu's float32
//                     operations; for it > 0 the row's new deltas, summed
//                     over its sources, are added to total[v] (float32[n]).
//                     The source, the only vertex at depth 0, keeps
//                     gms_tpu's `delta.at[source].set(0)` by not being
//                     added.
// Both steps are in place, which is safe: forward writes only unreached
// pairs and reads pairs at depth it; backward writes pairs at depth it and
// reads pairs at depth it + 1.
//
// What held the kernel it replaces back (a warp a (source, vertex) pair):
// 16.8 M warps a step at RMAT-18, all 32 lanes loading the same dist word,
// most warps exiting at once; a row that scans walked once for each source,
// reading that source's 4-byte dist words; a short row idling most lanes;
// float32 atomics making BC's bits change from run to run.
// Here a warp walks a row once for the whole batch, lane l owning sources
// 2l and 2l + 1:
//   * the lanes load 32 of the row's entries and their frontier words at a
//     time (lvl[it][w], or lvl[it+1][w] & lvl[it][v] backward), ballot the
//     entries that carry a bit the row still needs, and take them one by one
//     in row order: the lanes whose sources are in the word add that
//     neighbour's 256-byte sigma (and delta) row, one coalesced load;
//   * a row none of whose pairs need the step costs one 8-byte load;
//   * rows longer than the segment (512 entries; the 25,196-wide hub of
//     RMAT-18) are cut into the segments of graphs/row_schedule.py, read by
//     row_schedule.cuh: each segment's warp leaves float64 partials for its
//     64 sources, and a finish pass adds them in segment order, a warp a
//     wide row. Narrow rows keep one warp each: the lanes are sources, so a
//     short row idles no live lane.
// Every (source, vertex) sum accumulates in float64 in one fixed order
// (row order within a segment, then segment order) and rounds once to
// float32; a row's total is a fixed shuffle tree of its sources' deltas,
// stored once by one lane. BC gives the same bits on every run. The terms
// are gms_tpu's float32 values; XLA sums its rows in float32, so the result
// matches gms_tpu to rounding (rtol 1e-4), not bit for bit.
//
// Bound on an H100: bytes — per step one bit a (source, vertex) pair of the
// frontier, each scanned row once for the batch with its indptr words, the
// distinct (source, neighbour) sigma (and delta) words the sums read, and
// the writes (chip_smoke.py's bc_pass_bytes).

#include <cuda_runtime.h>

#include "row_schedule.cuh"

namespace {

using row_sched::Schedule;
using u64 = unsigned long long;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 64;

// The span of this warp's main-pass item: a whole row of at most NARROW
// entries, or one segment of a longer row. wide: the row has several
// segments (k: this one's index, its partials' row).
struct Span {
  int v;
  long long lo, hi, k;
  bool wide;
};

// False past the last item; warp-uniform.
__device__ __forceinline__ bool warp_span(const Schedule& s,
                                          const long long* __restrict__ indptr,
                                          Span* sp) {
  const long long item =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (item < s.n_narrow) {
    sp->v = s.narrow[item];
    sp->lo = indptr[sp->v];
    sp->hi = indptr[sp->v + 1];
    sp->k = -1;
    sp->wide = false;
    return true;
  }
  const long long k = item - s.n_narrow;
  if (k >= s.n_seg) return false;
  sp->v = s.seg_row[k];
  const long long row_lo = indptr[sp->v], row_hi = indptr[sp->v + 1];
  row_sched::segment_span(s, k, row_hi, &sp->lo, &sp->hi);
  sp->k = k;
  sp->wide = row_hi - row_lo > s.segment;
  return true;
}

inline unsigned span_blocks(const Schedule& s) {
  return (unsigned)((s.n_narrow + s.n_seg + row_sched::kWarps - 1) /
                    row_sched::kWarps);
}

// This lane's two sources' bits of a 64-bit word: bit 0 = source 2l, bit 1
// = source 2l + 1.
__device__ __forceinline__ unsigned pair_bits(u64 x, int lane) {
  return (unsigned)(x >> (2 * lane)) & 3u;
}

// Bit i of x to bit 2i.
__device__ __forceinline__ u64 spread(unsigned x) {
  u64 v = x;
  v = (v | (v << 16)) & 0x0000FFFF0000FFFFull;
  v = (v | (v << 8)) & 0x00FF00FF00FF00FFull;
  v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0Full;
  v = (v | (v << 2)) & 0x3333333333333333ull;
  v = (v | (v << 1)) & 0x5555555555555555ull;
  return v;
}

// The 64-bit word of the lanes' two bits each.
__device__ __forceinline__ u64 gather_bits(unsigned mine) {
  const unsigned lo = __ballot_sync(kFull, mine & 1u);
  const unsigned hi = __ballot_sync(kFull, mine & 2u);
  return spread(lo) | (spread(hi) << 1);
}

// Forward sums of a span: for this lane's sources in `need`, sigma[w, b]
// over the span's w with bit b in front[w], in row order.
__device__ __forceinline__ void forward_sums(
    const int* __restrict__ indices, const u64* __restrict__ front,
    const float* __restrict__ sigma, long long lo, long long hi, u64 need,
    int lane, double* s0, double* s1) {
  for (long long base = lo; base < hi; base += 32) {
    const long long j = base + lane;
    int w = 0;
    u64 f = 0ull;
    if (j < hi) {
      w = indices[j];
      f = front[w] & need;
    }
    unsigned hits = __ballot_sync(kFull, f != 0ull);
    while (hits) {
      const int i = __ffs(hits) - 1;
      hits &= hits - 1u;
      const int wi = __shfl_sync(kFull, w, i);
      const unsigned mine = pair_bits(__shfl_sync(kFull, f, i), lane);
      if (mine) {
        const float2 sg =
            reinterpret_cast<const float2*>(sigma + (long long)wi * kBatch)
                [lane];
        if (mine & 1u) *s0 = __dadd_rn(*s0, (double)sg.x);
        if (mine & 2u) *s1 = __dadd_rn(*s1, (double)sg.y);
      }
    }
  }
}

// A forward row's end: its pairs in `need` with s > 0 enter lvl[it+1] and
// seen, with sigma = s rounded once.
__device__ __forceinline__ void forward_finish(int v, u64 need, double s0,
                                               double s1, int lane,
                                               u64* __restrict__ next,
                                               u64* __restrict__ seen,
                                               float* __restrict__ sigma) {
  const unsigned want = pair_bits(need, lane);
  const unsigned nb = ((want & 1u) && s0 > 0.0 ? 1u : 0u) |
                      ((want & 2u) && s1 > 0.0 ? 2u : 0u);
  float* row = sigma + (long long)v * kBatch + 2 * lane;
  if (nb & 1u) row[0] = __double2float_rn(s0);
  if (nb & 2u) row[1] = __double2float_rn(s1);
  const u64 bits = gather_bits(nb);
  if (lane == 0 && bits) {
    next[v] |= bits;
    seen[v] |= bits;
  }
}

__global__ void __launch_bounds__(row_sched::kThreads)
    bc_forward_kernel(const long long* __restrict__ indptr,
                      const int* __restrict__ indices, Schedule sched,
                      const u64* __restrict__ front, u64* __restrict__ next,
                      u64* __restrict__ seen, float* __restrict__ sigma,
                      double* __restrict__ partial) {
  Span sp;
  if (!warp_span(sched, indptr, &sp)) return;
  const u64 need = ~seen[sp.v];
  if (need == 0ull) return;
  const int lane = threadIdx.x & 31;
  double s0 = 0.0, s1 = 0.0;
  forward_sums(indices, front, sigma, sp.lo, sp.hi, need, lane, &s0, &s1);
  if (sp.wide) {
    double* p = partial + sp.k * kBatch + 2 * lane;
    p[0] = s0;
    p[1] = s1;
    return;
  }
  forward_finish(sp.v, need, s0, s1, lane, next, seen, sigma);
}

// A wide row's partials, this lane's two sources, added in segment order.
__device__ __forceinline__ void segment_sums(
    const Schedule& sched, const long long* indptr,
    const double* __restrict__ partial, long long i, int v, int lane,
    double* s0, double* s1) {
  const long long first = sched.wide_seg[i];
  const long long count =
      row_sched::segments(indptr[v + 1] - indptr[v], sched.segment);
  for (long long c = 0; c < count; ++c) {
    const double2 p = reinterpret_cast<const double2*>(
        partial + (first + c) * kBatch)[lane];
    *s0 = __dadd_rn(*s0, p.x);
    *s1 = __dadd_rn(*s1, p.y);
  }
}

__global__ void __launch_bounds__(row_sched::kThreads)
    bc_forward_finish(const long long* __restrict__ indptr, Schedule sched,
                      const double* __restrict__ partial,
                      u64* __restrict__ next, u64* __restrict__ seen,
                      float* __restrict__ sigma) {
  const long long i = row_sched::finish_item(sched);
  if (i < 0) return;
  const int v = sched.wide_row[i];
  const u64 need = ~seen[v];
  if (need == 0ull) return;
  const int lane = threadIdx.x & 31;
  double s0 = 0.0, s1 = 0.0;
  segment_sums(sched, indptr, partial, i, v, lane, &s0, &s1);
  forward_finish(v, need, s0, s1, lane, next, seen, sigma);
}

// gms_tpu's term sigma_v / max(sigma_w, 1e-30) * (1 + delta_w), float32.
__device__ __forceinline__ double bc_term(float sv, float sw, float dw) {
  const float q = __fdiv_rn(sv, fmaxf(sw, 1e-30f));
  return (double)__fmul_rn(q, __fadd_rn(1.0f, dw));
}

// Backward sums of a span for this lane's sources in `at` (the row's pairs
// at depth it): the terms of the row's w with the bit in succ[w] and
// sigma[w, b] > 0, in row order.
__device__ __forceinline__ void backward_sums(
    const int* __restrict__ indices, const u64* __restrict__ succ,
    const float* __restrict__ sigma, const float* __restrict__ delta,
    long long lo, long long hi, u64 at, float2 sv, int lane, double* s0,
    double* s1) {
  for (long long base = lo; base < hi; base += 32) {
    const long long j = base + lane;
    int w = 0;
    u64 m = 0ull;
    if (j < hi) {
      w = indices[j];
      m = succ[w] & at;
    }
    unsigned hits = __ballot_sync(kFull, m != 0ull);
    while (hits) {
      const int i = __ffs(hits) - 1;
      hits &= hits - 1u;
      const int wi = __shfl_sync(kFull, w, i);
      const unsigned mine = pair_bits(__shfl_sync(kFull, m, i), lane);
      if (mine) {
        const long long o = (long long)wi * kBatch;
        const float2 sw = reinterpret_cast<const float2*>(sigma + o)[lane];
        const float2 dw = reinterpret_cast<const float2*>(delta + o)[lane];
        if ((mine & 1u) && sw.x > 0.0f)
          *s0 = __dadd_rn(*s0, bc_term(sv.x, sw.x, dw.x));
        if ((mine & 2u) && sw.y > 0.0f)
          *s1 = __dadd_rn(*s1, bc_term(sv.y, sw.y, dw.y));
      }
    }
  }
}

// A backward row's end: delta of its pairs at depth it rounded once; for
// it > 0 their sum (a fixed shuffle tree in float64, rounded once) added to
// total[v] by one lane.
__device__ __forceinline__ void backward_finish(int v, u64 at, double s0,
                                                double s1, int lane, int it,
                                                float* __restrict__ delta,
                                                float* __restrict__ total) {
  const unsigned mine = pair_bits(at, lane);
  const float d0 = (mine & 1u) ? __double2float_rn(s0) : 0.0f;
  const float d1 = (mine & 2u) ? __double2float_rn(s1) : 0.0f;
  float* row = delta + (long long)v * kBatch + 2 * lane;
  if (mine & 1u) row[0] = d0;
  if (mine & 2u) row[1] = d1;
  if (it == 0) return;
  double t = __dadd_rn((double)d0, (double)d1);
  for (int o = 16; o > 0; o >>= 1) {
    t = __dadd_rn(t, __shfl_xor_sync(kFull, t, o));
  }
  if (lane == 0) total[v] = __fadd_rn(total[v], __double2float_rn(t));
}

__device__ __forceinline__ float2 own_sigma(const float* __restrict__ sigma,
                                            int v, u64 at, int lane) {
  return pair_bits(at, lane)
             ? reinterpret_cast<const float2*>(sigma +
                                               (long long)v * kBatch)[lane]
             : make_float2(0.0f, 0.0f);
}

__global__ void __launch_bounds__(row_sched::kThreads)
    bc_backward_kernel(const long long* __restrict__ indptr,
                       const int* __restrict__ indices, Schedule sched,
                       const u64* __restrict__ cur,
                       const u64* __restrict__ succ,
                       const float* __restrict__ sigma,
                       float* __restrict__ delta, int it,
                       float* __restrict__ total,
                       double* __restrict__ partial) {
  Span sp;
  if (!warp_span(sched, indptr, &sp)) return;
  const u64 at = cur[sp.v];
  if (at == 0ull) return;
  const int lane = threadIdx.x & 31;
  double s0 = 0.0, s1 = 0.0;
  backward_sums(indices, succ, sigma, delta, sp.lo, sp.hi, at,
                own_sigma(sigma, sp.v, at, lane), lane, &s0, &s1);
  if (sp.wide) {
    double* p = partial + sp.k * kBatch + 2 * lane;
    p[0] = s0;
    p[1] = s1;
    return;
  }
  backward_finish(sp.v, at, s0, s1, lane, it, delta, total);
}

__global__ void __launch_bounds__(row_sched::kThreads)
    bc_backward_finish(const long long* __restrict__ indptr, Schedule sched,
                       const double* __restrict__ partial,
                       const u64* __restrict__ cur, int it,
                       float* __restrict__ delta, float* __restrict__ total) {
  const long long i = row_sched::finish_item(sched);
  if (i < 0) return;
  const int v = sched.wide_row[i];
  const u64 at = cur[v];
  if (at == 0ull) return;
  const int lane = threadIdx.x & 31;
  double s0 = 0.0, s1 = 0.0;
  segment_sums(sched, indptr, partial, i, v, lane, &s0, &s1);
  backward_finish(v, at, s0, s1, lane, it, delta, total);
}

}  // namespace

// lvl: uint64[>= it + 2, n]; seen: uint64[n]; sigma: float32[n, 64];
// rows, starts, n_narrow, n_seg, n_wide, segment: the row schedule;
// partial: float64[n_seg, 64] scratch (null when n_wide is 0).
extern "C" int bc_forward(const void* indptr, const void* indices,
                          long long n, void* lvl, void* seen, void* sigma,
                          int it, const void* rows, const void* starts,
                          long long n_narrow, long long n_seg,
                          long long n_wide, int segment, void* partial,
                          void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const Schedule sched =
      row_sched::make(rows, starts, n_narrow, n_seg, n_wide, segment);
  u64* front = (u64*)lvl + (long long)it * n;
  const unsigned blocks = span_blocks(sched);
  if (blocks > 0) {
    bc_forward_kernel<<<blocks, row_sched::kThreads, 0, st>>>(
        (const long long*)indptr, (const int*)indices, sched, front,
        front + n, (u64*)seen, (float*)sigma, (double*)partial);
  }
  if (n_wide > 0) {
    bc_forward_finish<<<row_sched::finish_blocks(sched), row_sched::kThreads,
                        0, st>>>((const long long*)indptr, sched,
                                 (const double*)partial, front + n,
                                 (u64*)seen, (float*)sigma);
  }
  return (int)cudaGetLastError();
}

// delta: float32[n, 64]; total: float32[n], added to.
extern "C" int bc_backward(const void* indptr, const void* indices,
                           long long n, const void* lvl, const void* sigma,
                           void* delta, int it, void* total,
                           const void* rows, const void* starts,
                           long long n_narrow, long long n_seg,
                           long long n_wide, int segment, void* partial,
                           void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const Schedule sched =
      row_sched::make(rows, starts, n_narrow, n_seg, n_wide, segment);
  const u64* cur = (const u64*)lvl + (long long)it * n;
  const unsigned blocks = span_blocks(sched);
  if (blocks > 0) {
    bc_backward_kernel<<<blocks, row_sched::kThreads, 0, st>>>(
        (const long long*)indptr, (const int*)indices, sched, cur, cur + n,
        (const float*)sigma, (float*)delta, it, (float*)total,
        (double*)partial);
  }
  if (n_wide > 0) {
    bc_backward_finish<<<row_sched::finish_blocks(sched), row_sched::kThreads,
                         0, st>>>((const long long*)indptr, sched,
                                  (const double*)partial, cur, it,
                                  (float*)delta, (float*)total);
  }
  return (int)cudaGetLastError();
}
