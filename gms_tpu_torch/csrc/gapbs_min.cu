// K33 cc_step and sssp_step: one synchronous (Jacobi) min step over CSR rows
// read to their degree, with a changed flag — the loop bodies of
// gms_tpu/algorithms/gapbs.py `_cc` (:245, min-label propagation) and
// `_sssp` (:275, Bellman-Ford):
//   cc_step:   nxt[v] = min(cur[v], min over w in row v of cur[w])   int32
//   sssp_step: nxt[v] = min(cur[v], min over slots j of row v of
//                           cur[indices[j]] + weight[j])             int64
// with weight[j] = 1 when `weights` is null. Each reads only `cur` and writes
// a fresh `nxt` (double buffering), so the wrapper's loop takes gms_tpu's
// round count; both fixpoints are unique, so the results are exact either
// way. SSSP's unreached value big = int64 max / 4 leaves room for any int32
// weight. `changed` (int32[1]) is zeroed by the step's first launch and set
// when any value moved: a round reads back 4 bytes.
//
// K25's step (csrc/min_step.cuh) on the row schedule of row_schedule.cuh:
// an init launch (zeroes `changed`, nxt[v] = cur[v] for each wide row), then
// a narrow row (<= 8 entries) a thread and a segment (<= 512 entries) a warp
// with a shuffle-tree min, a wide row's segments folded into nxt[v] by
// atomicMin (int for CC, long long for SSSP), `changed` stored once by each
// block that saw a value move. Bound on an H100: bytes — indptr, indices
// (and weights) once, cur read once, nxt written, the changed word.

#include <cuda_runtime.h>
#include <limits.h>

#include "min_step.cuh"

namespace {

// a neighbour's distance plus the slot's weight (1 without weights)
struct Relax {
  const int* __restrict__ weights;
  __device__ __forceinline__ long long operator()(long long j,
                                                  long long c) const {
    return c + (weights ? weights[j] : 1);
  }
};

}  // namespace

// cur, nxt: int32[n]; the row schedule (rows, starts, n_narrow, n_seg,
// n_wide, segment); changed: int32[1].
extern "C" int cc_step(const void* indptr, const void* indices, long long n,
                       const void* cur, void* nxt, const void* rows,
                       const void* starts, long long n_narrow, long long n_seg,
                       long long n_wide, int segment, void* changed,
                       void* stream) {
  return min_step::launch<int>(indptr, indices, n, cur, nxt, rows, starts,
                               n_narrow, n_seg, n_wide, segment, changed,
                               INT_MAX, min_step::Same{}, stream);
}

// weights: int32[E] or null (unit); cur, nxt: int64[n]; the row schedule;
// changed: int32[1].
extern "C" int sssp_step(const void* indptr, const void* indices,
                         const void* weights, long long n, const void* cur,
                         void* nxt, const void* rows, const void* starts,
                         long long n_narrow, long long n_seg, long long n_wide,
                         int segment, void* changed, void* stream) {
  return min_step::launch<long long>(
      indptr, indices, n, cur, nxt, rows, starts, n_narrow, n_seg, n_wide,
      segment, changed, LLONG_MAX, Relax{(const int*)weights}, stream);
}
