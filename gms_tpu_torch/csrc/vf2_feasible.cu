// K26 vf2_feasible: the candidate mask of one VF2 level, and its count.
//
// Replaces gms_tpu/algorithms/subgraph_iso.py `_feasible` (:81). Item n is a
// partial mapping M[n, 0..d-1] (target ids of the pattern positions placed so
// far; M[n, 0] < 0 marks a dead padding row) and cand[n, :] its Dc candidates
// for position d. ok[n, i] is true when candidate c = cand[n, i]
//   * is not SENTINEL, and the row is alive;
//   * has degree deg1[clip(c)] >= pdeg (deg1 holds one extra 0 at its end, so
//     SENTINEL lands there);
//   * differs from M[n, 0..d-1];
//   * is adjacent to M[n, p] for every p in `parents` and, in induced mode,
//     to none of M[n, p] for p in `nonparents`.
// parents and nonparents are bit masks over the positions 0..d-1 (gms_tpu
// passes them as static tuples). Adjacency is one word probe of the id-space
// bitmap bmp[V, vw] (query clipped to [0, 32 vw - 1], row to [0, V - 1]) or,
// with no bitmap, a binary search of c in the parent's padded row (sorted,
// SENTINEL tail; the found index clamped to d_pad - 1, as gms_tpu's
// searchsorted). The checks run in gms_tpu's order and a thread stops at the
// first that fails; the result is their AND either way.
//
// One thread per (item, candidate); each block adds its count of ok to *count
// (int64, zeroed by the wrapper) with one atomicAdd, so the level reads back
// 8 bytes. Bound on an H100: bytes — M and cand read once, the deg1 entries,
// bitmap words or row words each live candidate consults, ok written.

#include <cuda_runtime.h>

#include "block_sum.cuh"
#include "row_search.cuh"

namespace {

// gms_tpu's member(): searchsorted (left) of q in the sorted row, the index
// clamped to width - 1, then an equality test.
__device__ __forceinline__ bool row_has(const int* __restrict__ row,
                                        int width, int q) {
  int lo = 0, hi = width;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < q) lo = mid + 1; else hi = mid;
  }
  if (lo > width - 1) lo = width - 1;
  return row[lo] == q;
}

__device__ __forceinline__ bool adjacent(int a, int c,
                                         const int* __restrict__ nbr,
                                         long long v_pad, int d_pad,
                                         const unsigned* __restrict__ bmp,
                                         long long bmp_v, long long vw) {
  if (bmp != nullptr) {
    const long long q = clip_index(c, 32 * vw);
    const long long r = clip_index(a, bmp_v);
    const unsigned w = bmp[r * vw + (q >> 5)];
    return ((w >> (q & 31)) & 1u) != 0u;
  }
  return row_has(nbr + clip_index(a, v_pad) * d_pad, d_pad, c);
}

__global__ void feasible_kernel(const int* __restrict__ M, int P,
                                const int* __restrict__ cand, long long N,
                                int Dc, const int* __restrict__ nbr,
                                long long v_pad, int d_pad,
                                const int* __restrict__ deg1, long long n_deg1,
                                const unsigned* __restrict__ bmp,
                                long long bmp_v, long long vw, int pdeg, int d,
                                unsigned long long parents,
                                unsigned long long nonparents, int induced,
                                unsigned char* __restrict__ ok,
                                unsigned long long* __restrict__ count) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  bool good = false;
  if (t < N * Dc) {
    const long long n = t / Dc;
    const int* m = M + n * P;
    const int c = cand[t];
    good = c != GMS_SENTINEL && m[0] >= 0;
    good = good && deg1[clip_index(c, n_deg1)] >= pdeg;
    for (int j = 0; good && j < d; ++j) good = c != m[j];
    for (int j = 0; good && j < d; ++j)
      if ((parents >> j) & 1ull)
        good = adjacent(m[j], c, nbr, v_pad, d_pad, bmp, bmp_v, vw);
    if (induced)
      for (int j = 0; good && j < d; ++j)
        if ((nonparents >> j) & 1ull)
          good = !adjacent(m[j], c, nbr, v_pad, d_pad, bmp, bmp_v, vw);
    ok[t] = good ? 1 : 0;
  }
  block_sum_add(good ? 1 : 0, count);
}

}  // namespace

extern "C" int vf2_feasible(const void* M, int P, const void* cand,
                            long long N, int Dc, const void* nbr,
                            long long v_pad, int d_pad, const void* deg1,
                            long long n_deg1, const void* bmp, long long bmp_v,
                            long long vw, int pdeg, int d,
                            unsigned long long parents,
                            unsigned long long nonparents, int induced,
                            void* ok, void* count, void* stream) {
  const long long total = N * Dc;
  if (total > 0) {
    feasible_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                      (cudaStream_t)stream>>>(
        (const int*)M, P, (const int*)cand, N, Dc, (const int*)nbr, v_pad,
        d_pad, (const int*)deg1, n_deg1, (const unsigned*)bmp, bmp_v, vw, pdeg,
        d, parents, nonparents, induced, (unsigned char*)ok,
        (unsigned long long*)count);
  }
  return (int)cudaGetLastError();
}
