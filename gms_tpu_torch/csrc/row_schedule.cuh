// The degree-balanced CSR row schedule of graphs/row_schedule.py, device
// side. Rows of at most NARROW (8) entries take one thread each, 32 rows a
// warp; every other row is cut into segments of at most `segment` (512)
// entries, one warp a segment. A row of one segment is finished by its
// warp; a row of several (a wide row) leaves one partial a segment, which
// a finish pass combines, a warp a wide row (lane-strided sums, then a
// shuffle tree: one fixed order), or, where the combination is exact in any
// order, folds its segments with atomics.
// So no warp walks more than max(32 NARROW, segment) = 512 entries.
//
// A kernel on the schedule runs its main pass as one launch of
// kThreads-thread blocks, main_blocks() of them: the first narrow_blocks()
// take the narrow rows, a thread each, and the rest the segments, a warp
// each; a finish pass is a launch of finish_blocks() blocks, a warp a wide
// row, made only when there are wide rows.

#pragma once

#include <cuda_runtime.h>

namespace row_sched {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// rows: int32 narrow | seg_row | wide_row; starts: int64 seg_start |
// wide_seg (graphs/row_schedule.py's RowSchedule buffers).
struct Schedule {
  const int* narrow;
  const int* seg_row;
  const int* wide_row;
  const long long* seg_start;
  const long long* wide_seg;
  long long n_narrow, n_seg, n_wide;
  int segment;
};

inline Schedule make(const void* rows, const void* starts, long long n_narrow,
                     long long n_seg, long long n_wide, int segment) {
  const int* r = (const int*)rows;
  const long long* s = (const long long*)starts;
  return Schedule{r, r + n_narrow, r + n_narrow + n_seg, s, s + n_seg,
                  n_narrow, n_seg, n_wide, segment};
}

inline unsigned narrow_blocks(const Schedule& s) {
  return (unsigned)((s.n_narrow + kThreads - 1) / kThreads);
}

inline unsigned main_blocks(const Schedule& s) {
  return narrow_blocks(s) + (unsigned)((s.n_seg + kWarps - 1) / kWarps);
}

inline unsigned finish_blocks(const Schedule& s) {
  return (unsigned)((s.n_wide + kWarps - 1) / kWarps);
}

// The main pass's item of this thread: a narrow row (its index into the
// narrow list, or -1 past its end) in the first narrow_blocks blocks, else
// this warp's segment (or -1 past the last).
struct Item {
  bool narrow;
  long long index;
};

__device__ __forceinline__ Item main_item(const Schedule& s,
                                          unsigned narrow_blocks) {
  if (blockIdx.x < narrow_blocks) {
    const long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
    return Item{true, t < s.n_narrow ? t : -1};
  }
  const long long k = (blockIdx.x - narrow_blocks) * (long long)kWarps +
                      (threadIdx.x >> 5);
  return Item{false, k < s.n_seg ? k : -1};
}

// This warp's wide row in the finish pass, or -1.
__device__ __forceinline__ long long finish_item(const Schedule& s) {
  const long long i = (blockIdx.x * (long long)kThreads + threadIdx.x) >> 5;
  return i < s.n_wide ? i : -1;
}

// The entries [*lo, *hi) of segment k, whose row ends at row_hi.
__device__ __forceinline__ void segment_span(const Schedule& s, long long k,
                                             long long row_hi, long long* lo,
                                             long long* hi) {
  *lo = s.seg_start[k];
  const long long end = *lo + s.segment;
  *hi = end < row_hi ? end : row_hi;
}

// Segments of a row of d entries (d > NARROW).
__device__ __forceinline__ long long segments(long long d, int segment) {
  return (d + segment - 1) / segment;
}

}  // namespace row_sched
