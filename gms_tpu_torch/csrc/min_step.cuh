// One synchronous (Jacobi) min step over CSR rows on the row schedule of
// row_schedule.cuh, with a changed flag: K25 (color_components.cu, the
// friend labels) and K33 (gapbs_min.cu, CC labels and SSSP distances).
//
//   nxt[v] = min(cur[v], min over slots j of row v of cand(j, cur[indices[j]]))
//
// reading only `cur` and writing a fresh `nxt` (double buffering). Two
// launches. min_init_kernel zeroes `changed` (int32[1]) and sets nxt[v] =
// cur[v] for each wide row v. min_step_kernel takes a narrow row (at most 8
// entries, empty rows included) a thread and a segment (at most 512
// entries) a warp, its lanes striding it and a shuffle tree taking their
// min; a row of one segment is written there, and each segment of a wide
// row folds its min into nxt[v] with atomicMin (min is exact in any order,
// so no partials and no finish pass). No warp walks more than 512 entries,
// whatever the widest row. `changed` is reduced inside each block
// (__syncthreads_or): only a block that saw a value move writes it, once.
//
// T is int or long long (atomicMin is native for both on sm_90); Cand is a
// functor (slot j, cur of its entry) -> T.

#pragma once

#include <cuda_runtime.h>

#include "row_schedule.cuh"

namespace min_step {

// Cand of a step whose candidates are the entries' own values (K25, CC)
struct Same {
  template <typename T>
  __device__ __forceinline__ T operator()(long long, T c) const {
    return c;
  }
};

template <typename T>
__device__ __forceinline__ T warp_min(T m) {
  for (int o = 16; o > 0; o >>= 1) {
    const T t = __shfl_xor_sync(0xffffffffu, m, o);
    m = t < m ? t : m;
  }
  return m;
}

template <typename T>
__global__ void min_init_kernel(row_sched::Schedule sched,
                                const T* __restrict__ cur, T* __restrict__ nxt,
                                int* __restrict__ changed) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i == 0) *changed = 0;
  if (i < sched.n_wide) {
    const int v = sched.wide_row[i];
    nxt[v] = cur[v];
  }
}

// Every thread reaches the block's __syncthreads_or: no early return.
template <typename T, typename Cand>
__global__ void __launch_bounds__(row_sched::kThreads)
    min_step_kernel(const long long* __restrict__ indptr,
                    const int* __restrict__ indices,
                    row_sched::Schedule sched, unsigned narrow_blocks,
                    const T* __restrict__ cur, T* __restrict__ nxt,
                    int* __restrict__ changed, T top, Cand cand) {
  const row_sched::Item item = row_sched::main_item(sched, narrow_blocks);
  int moved = 0;
  if (item.index >= 0 && item.narrow) {
    const int v = sched.narrow[item.index];
    const T own = cur[v];
    const long long end = indptr[v + 1];
    T m = own;
#pragma unroll 4
    for (long long j = indptr[v]; j < end; ++j) {
      const T c = cand(j, cur[indices[j]]);
      m = c < m ? c : m;
    }
    nxt[v] = m;
    moved = m != own;
  } else if (item.index >= 0) {
    // the warp's segment: item.index is the same on its 32 lanes
    const long long k = item.index;
    const int lane = threadIdx.x & 31;
    const int v = sched.seg_row[k];
    const T own = cur[v];  // loaded with the row's bounds, used at the end
    const long long row_lo = indptr[v], row_hi = indptr[v + 1];
    long long lo, hi;
    row_sched::segment_span(sched, k, row_hi, &lo, &hi);
    T m = top;
#pragma unroll 4
    for (long long j = lo + lane; j < hi; j += 32) {
      const T c = cand(j, cur[indices[j]]);
      m = c < m ? c : m;
    }
    m = warp_min(m);
    if (lane == 0) {
      if (row_hi - row_lo <= sched.segment) {
        nxt[v] = m < own ? m : own;
      } else if (m < own) {
        atomicMin(nxt + v, m);
      }
      moved = m < own;
    }
  }
  // one store a block, and none once another block has made it
  if (__syncthreads_or(moved) && threadIdx.x == 0 &&
      !*reinterpret_cast<volatile int*>(changed))
    *changed = 1;
}

// The step's two launches on `stream`; returns cudaGetLastError().
template <typename T, typename Cand>
int launch(const void* indptr, const void* indices, long long n,
           const void* cur, void* nxt, const void* rows, const void* starts,
           long long n_narrow, long long n_seg, long long n_wide, int segment,
           void* changed, T top, Cand cand, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const row_sched::Schedule sched =
      row_sched::make(rows, starts, n_narrow, n_seg, n_wide, segment);
  min_init_kernel<T><<<(unsigned)(n_wide / 256 + 1), 256, 0, st>>>(
      sched, (const T*)cur, (T*)nxt, (int*)changed);
  const unsigned blocks = row_sched::main_blocks(sched);
  if (n > 0 && blocks > 0) {
    min_step_kernel<T, Cand><<<blocks, row_sched::kThreads, 0, st>>>(
        (const long long*)indptr, (const int*)indices, sched,
        row_sched::narrow_blocks(sched), (const T*)cur, (T*)nxt,
        (int*)changed, top, cand);
  }
  return (int)cudaGetLastError();
}

}  // namespace min_step
