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
// A warp a vertex over the friend CSR (indptr int64, indices int32); `changed`
// (int32[1], zeroed by the wrapper) is set when any label moved. Bound on an
// H100: bytes — indptr, indices, comp read once plus each friend's label,
// nxt written.

#include <cuda_runtime.h>

namespace {

__global__ void component_step_kernel(const long long* __restrict__ indptr,
                                      const int* __restrict__ indices,
                                      long long n,
                                      const int* __restrict__ comp,
                                      int* __restrict__ nxt,
                                      int* __restrict__ changed) {
  const long long v = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (v >= n) return;
  const int own = comp[v];
  int m = own;
  for (long long j = indptr[v] + lane; j < indptr[v + 1]; j += 32) {
    const int c = comp[indices[j]];
    m = c < m ? c : m;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const int t = __shfl_xor_sync(0xffffffffu, m, o);
    m = t < m ? t : m;
  }
  if (lane == 0) {
    nxt[v] = m;
    if (m != own) *changed = 1;
  }
}

}  // namespace

extern "C" int component_step(const void* indptr, const void* indices,
                              long long n, const void* comp, void* nxt,
                              void* changed, void* stream) {
  if (n > 0) {
    component_step_kernel<<<(unsigned)((32 * n + 255) / 256), 256, 0,
                            (cudaStream_t)stream>>>(
        (const long long*)indptr, (const int*)indices, n, (const int*)comp,
        (int*)nxt, (int*)changed);
  }
  return (int)cudaGetLastError();
}
