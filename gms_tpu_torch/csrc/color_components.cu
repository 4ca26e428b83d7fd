// K25 color_components: one synchronous (Jacobi) min-label step on the friend
// graph of dense_sparse coloring, with a changed flag.
//
// Replaces the body of the lax.while_loop in gms_tpu/algorithms/coloring.py
// `_component_labels` (:486, the step at :499-503):
//   nxt[v] = min(comp[v], min over friends w of comp[w]),
// reading only `comp` and writing a fresh `nxt`. The wrapper's loop keeps
// gms_tpu's limit, 4 ceil(log2(n + 2)) + 8 steps: when the limit stops the
// loop before the fixpoint the labels are those of that exact step, which an
// in-place (Gauss–Seidel) step or a union-find would not give.
//
// Two launches on the row schedule of row_schedule.cuh (friend CSR: indptr
// int64, indices int32). The first zeroes `changed` (int32[1]) and sets
// nxt[v] = comp[v] for each wide row v. The main pass takes a narrow row
// (at most 8 entries, empty rows included) a thread and a segment (at most
// 512 entries) a warp, its lanes striding it, a shuffle tree taking their
// min; a row of one segment is written there, and each segment of a wide
// row folds its min into nxt[v] with atomicMin (min is exact in any order,
// so no partials and no finish pass). No warp walks more than 512 entries,
// whatever the widest row. `changed` is reduced inside each block
// (__syncthreads_or): only a block that saw a label move writes it, once.
//
// Bound on an H100: bytes — indptr and indices once, comp read once (a
// friend's label is a word of comp), nxt written, the changed word.

#include <cuda_runtime.h>
#include <limits.h>

#include "row_schedule.cuh"

namespace {

using row_sched::Schedule;

__device__ __forceinline__ int warp_min(int m) {
  for (int o = 16; o > 0; o >>= 1) {
    m = min(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  return m;
}

__global__ void component_init_kernel(Schedule sched,
                                      const int* __restrict__ comp,
                                      int* __restrict__ nxt,
                                      int* __restrict__ changed) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i == 0) *changed = 0;
  if (i < sched.n_wide) {
    const int v = sched.wide_row[i];
    nxt[v] = comp[v];
  }
}

// Every thread reaches the block's __syncthreads_or: no early return.
__global__ void __launch_bounds__(row_sched::kThreads)
    component_step_kernel(const long long* __restrict__ indptr,
                          const int* __restrict__ indices, Schedule sched,
                          unsigned narrow_blocks,
                          const int* __restrict__ comp, int* __restrict__ nxt,
                          int* __restrict__ changed) {
  const row_sched::Item item = row_sched::main_item(sched, narrow_blocks);
  int moved = 0;
  if (item.index >= 0 && item.narrow) {
    const int v = sched.narrow[item.index];
    const int own = comp[v];
    const long long end = indptr[v + 1];
    int m = own;
#pragma unroll 4
    for (long long j = indptr[v]; j < end; ++j) m = min(m, comp[indices[j]]);
    nxt[v] = m;
    moved = m != own;
  } else if (item.index >= 0) {
    // the warp's segment: item.index is the same on its 32 lanes
    const long long k = item.index;
    const int lane = threadIdx.x & 31;
    const int v = sched.seg_row[k];
    const long long row_lo = indptr[v], row_hi = indptr[v + 1];
    long long lo, hi;
    row_sched::segment_span(sched, k, row_hi, &lo, &hi);
    int m = INT_MAX;
#pragma unroll 4
    for (long long j = lo + lane; j < hi; j += 32) m = min(m, comp[indices[j]]);
    m = warp_min(m);
    if (lane == 0) {
      const int own = comp[v];
      if (row_hi - row_lo <= sched.segment) {
        nxt[v] = min(m, own);
      } else if (m < own) {
        atomicMin(nxt + v, m);
      }
      moved = m < own;
    }
  }
  if (__syncthreads_or(moved) && threadIdx.x == 0) *changed = 1;
}

}  // namespace

// comp, nxt: int32[n]; changed: int32[1]; rows, starts, n_narrow, n_seg,
// n_wide, segment: the row schedule.
extern "C" int component_step(const void* indptr, const void* indices,
                              long long n, const void* comp, void* nxt,
                              const void* rows, const void* starts,
                              long long n_narrow, long long n_seg,
                              long long n_wide, int segment, void* changed,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Schedule sched =
      row_sched::make(rows, starts, n_narrow, n_seg, n_wide, segment);
  component_init_kernel<<<(unsigned)(n_wide / 256 + 1), 256, 0, st>>>(
      sched, (const int*)comp, (int*)nxt, (int*)changed);
  const unsigned blocks = row_sched::main_blocks(sched);
  if (n > 0 && blocks > 0) {
    component_step_kernel<<<blocks, row_sched::kThreads, 0, st>>>(
        (const long long*)indptr, (const int*)indices, sched,
        row_sched::narrow_blocks(sched), (const int*)comp, (int*)nxt,
        (int*)changed);
  }
  return (int)cudaGetLastError();
}
