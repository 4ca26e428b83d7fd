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
// The step of csrc/min_step.cuh on the row schedule of row_schedule.cuh
// (friend CSR: indptr int64, indices int32), shared with K33: an init
// launch (zeroes `changed`, sets nxt[v] = comp[v] for each wide row) and a
// main launch, a narrow row a thread and a segment of at most 512 entries a
// warp, a wide row's segments folded into nxt[v] by atomicMin, `changed`
// reduced inside each block.
//
// Bound on an H100: bytes — indptr and indices once, comp read once (a
// friend's label is a word of comp), nxt written, the changed word.

#include <cuda_runtime.h>
#include <limits.h>

#include "min_step.cuh"

// comp, nxt: int32[n]; changed: int32[1]; rows, starts, n_narrow, n_seg,
// n_wide, segment: the row schedule.
extern "C" int component_step(const void* indptr, const void* indices,
                              long long n, const void* comp, void* nxt,
                              const void* rows, const void* starts,
                              long long n_narrow, long long n_seg,
                              long long n_wide, int segment, void* changed,
                              void* stream) {
  return min_step::launch<int>(indptr, indices, n, comp, nxt, rows, starts,
                               n_narrow, n_seg, n_wide, segment, changed,
                               INT_MAX, min_step::Same{}, stream);
}
