// K32 pr_pull: one PageRank pull iteration of gms_tpu/algorithms/gapbs.py
// `_pagerank` (:216, GAPBS PageRankPull), over CSR rows read to their degree:
//   out[v] = base + damp * sum over w in row v of contrib[w],
//   contrib[w] = pr[w] / max(deg[w], 1)
// for v < n, with float32 state. The caller rounds base once, as gms_tpu's
// weak-typed float64 (1 - damp) meeting float32 n: base = f32(1 - damp) /
// f32(n); damp is f32(damp). contrib is IEEE float32 division, once a
// vertex as gms_tpu divides (gapbs.py:225-228), bit for bit its `contrib`.
// A row's sum accumulates in float64 and rounds once to float32, so it does
// not hang on the order of the sum: a row of 25,196 entries summed in
// float32 drifts by about 1e-5 relative from one order to another. The
// product and the final sum round separately (no fused multiply-add). XLA
// sums gms_tpu's rows in float32, so the result matches gms_tpu to rounding
// (rtol 1e-5), not bit for bit.
//
// Three launches an iteration, on the row schedule of row_schedule.cuh:
//   1. contrib, a thread a vertex;
//   2. the pull: a narrow row (at most 8 entries) a thread, summing in
//      order; a segment (at most 512 entries) a warp, the lanes striding it
//      and a shuffle tree combining them. A row of one segment is written
//      here; a wide row leaves a float64 partial a segment;
//   3. the finish, only when there are wide rows: a warp a wide row adds
//      its partials, each lane summing every 32nd in order, then a shuffle
//      tree adding the lanes' sums.
// No warp walks more than 512 entries (32 narrow rows of at most 8, or one
// segment), whatever the widest row; every sum runs in one fixed order, so
// two runs give the same bits. The pull does one gather an entry (contrib,
// 1 MB at RMAT-18, lives in L2 after first touch).
//
// Bound on an H100: bytes — indptr and the indices once, pr and deg of each
// distinct neighbour, out written. The indices stream and the contrib
// gathers (a 32-byte sector each, from L2) set this design's floor.

#include <cuda_runtime.h>

#include "row_schedule.cuh"

namespace {

using row_sched::Schedule;

__global__ void pr_contrib_kernel(const float* __restrict__ pr,
                                  const int* __restrict__ deg, long long n,
                                  float* __restrict__ contrib) {
  const long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (v < n) {
    const int d = deg[v];
    contrib[v] = __fdiv_rn(pr[v], (float)(d > 1 ? d : 1));
  }
}

__device__ __forceinline__ float pr_out(double s, float base, float damp) {
  return __fadd_rn(base, __fmul_rn(damp, __double2float_rn(s)));
}

// Every lane ends with the same bits: each level adds the same two values.
__device__ __forceinline__ double warp_sum(double s) {
  for (int o = 16; o > 0; o >>= 1) {
    s = __dadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  }
  return s;
}

__global__ void __launch_bounds__(row_sched::kThreads)
    pr_pull_kernel(const long long* __restrict__ indptr,
                   const int* __restrict__ indices, Schedule sched,
                   unsigned narrow_blocks, const float* __restrict__ contrib,
                   float base, float damp, double* __restrict__ partial,
                   float* __restrict__ out) {
  const row_sched::Item item = row_sched::main_item(sched, narrow_blocks);
  if (item.index < 0) return;
  if (item.narrow) {
    const int v = sched.narrow[item.index];
    const long long end = indptr[v + 1];
    double s = 0.0;
#pragma unroll 4
    for (long long j = indptr[v]; j < end; ++j) {
      s = __dadd_rn(s, (double)contrib[indices[j]]);
    }
    out[v] = pr_out(s, base, damp);
    return;
  }
  // the warp's segment: item.index is the same on its 32 lanes
  const long long k = item.index;
  const int lane = threadIdx.x & 31;
  const int v = sched.seg_row[k];
  const long long row_lo = indptr[v], row_hi = indptr[v + 1];
  long long lo, hi;
  row_sched::segment_span(sched, k, row_hi, &lo, &hi);
  double s = 0.0;
#pragma unroll 4
  for (long long j = lo + lane; j < hi; j += 32) {
    s = __dadd_rn(s, (double)contrib[indices[j]]);
  }
  s = warp_sum(s);
  if (lane == 0) {
    if (row_hi - row_lo <= sched.segment) {
      out[v] = pr_out(s, base, damp);
    } else {
      partial[k] = s;
    }
  }
}

__global__ void __launch_bounds__(row_sched::kThreads)
    pr_finish_kernel(const long long* __restrict__ indptr, Schedule sched,
                     const double* __restrict__ partial, float base,
                     float damp, float* __restrict__ out) {
  const long long i = row_sched::finish_item(sched);
  if (i < 0) return;
  const int lane = threadIdx.x & 31;
  const int v = sched.wide_row[i];
  const long long first = sched.wide_seg[i];
  const long long count =
      row_sched::segments(indptr[v + 1] - indptr[v], sched.segment);
  double s = 0.0;
  for (long long c = lane; c < count; c += 32) {
    s = __dadd_rn(s, partial[first + c]);
  }
  s = warp_sum(s);
  if (lane == 0) out[v] = pr_out(s, base, damp);
}

}  // namespace

// deg: int32[n] out-degrees; pr, out: float32[n]; rows, starts, n_narrow,
// n_seg, n_wide, segment: the row schedule; partial: float64[n_seg] scratch
// (null when n_wide is 0); contrib: float32[n] scratch.
extern "C" int pr_pull(const void* indptr, const void* indices, long long n,
                       const void* deg, const void* pr, float base, float damp,
                       const void* rows, const void* starts,
                       long long n_narrow, long long n_seg, long long n_wide,
                       int segment, void* partial, void* contrib, void* out,
                       void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const Schedule sched =
      row_sched::make(rows, starts, n_narrow, n_seg, n_wide, segment);
  pr_contrib_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const float*)pr, (const int*)deg, n, (float*)contrib);
  const unsigned nb = row_sched::narrow_blocks(sched);
  const unsigned blocks = row_sched::main_blocks(sched);
  if (blocks > 0) {
    pr_pull_kernel<<<blocks, row_sched::kThreads, 0, st>>>(
        (const long long*)indptr, (const int*)indices, sched, nb,
        (const float*)contrib, base, damp, (double*)partial, (float*)out);
  }
  if (n_wide > 0) {
    pr_finish_kernel<<<row_sched::finish_blocks(sched), row_sched::kThreads,
                       0, st>>>((const long long*)indptr, sched,
                                (const double*)partial, base, damp,
                                (float*)out);
  }
  return (int)cudaGetLastError();
}
