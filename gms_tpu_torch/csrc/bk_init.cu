// K35 init_items: the starting sets of the direct Bron–Kerbosch search,
// cand = the root's higher-ranked neighbours, fini = its lower-ranked ones,
// as bitsets over the first W slots of its padded row.
//
// Replaces gms_tpu/algorithms/bron_kerbosch.py:254 init_items. With
// r = clip(roots[b], 0, V_pad-1), slot j < W (W = 32*ww) holding
// x_j = nbr[r, j] for j < d and SENTINEL beyond, and rank(v) =
// rank_pad[clip(v, 0, n_rank-1)]:
//   bit j of cand[b] = x_j != SENTINEL && rank(x_j) > rank(roots[b])
//   bit j of fini[b] = x_j != SENTINEL && !(rank(x_j) > rank(roots[b]))
// Words are written as uint32 bits into int32 tensors.
//
// Design: one warp a root; lane l reads slot 32w + l of word w (coalesced)
// and its neighbour's rank, and two ballots give the word of each set.
//
// Bound on an H100 (3.35 TB/s): bytes. The roots, their rows' first
// min(W, deg + 1) slots, the ranks of the roots and of the neighbours read
// once, and the 2*C*ww words written. The neighbours' rank reads are
// scattered 4-byte loads.

#include <cuda_runtime.h>

#include "row_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void init_items_kernel(const int* __restrict__ nbr, long long v_pad,
                                  int d, const int* __restrict__ rank_pad,
                                  long long n_rank,
                                  const int* __restrict__ roots, long long c,
                                  int ww, unsigned* __restrict__ cand,
                                  unsigned* __restrict__ fini) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= c) return;
  const int root = roots[b];
  const int* row = nbr + clip_index(root, v_pad) * d;
  const int root_rank = rank_pad[clip_index(root, n_rank)];
  for (int w = 0; w < ww; ++w) {
    const int j = 32 * w + lane;
    const int x = j < d ? row[j] : GMS_SENTINEL;
    const bool valid = x != GMS_SENTINEL;
    const bool higher = valid && rank_pad[clip_index(x, n_rank)] > root_rank;
    const unsigned hi = __ballot_sync(0xffffffffu, higher);
    const unsigned lo = __ballot_sync(0xffffffffu, valid && !higher);
    if (lane == 0) {
      cand[b * ww + w] = hi;
      fini[b * ww + w] = lo;
    }
  }
}

}  // namespace

extern "C" int init_items(const void* nbr, long long v_pad, int d,
                          const void* rank_pad, long long n_rank,
                          const void* roots, long long c, int ww, void* cand,
                          void* fini, void* stream) {
  if (c > 0 && ww > 0) {
    const long long blocks = (c + kWarps - 1) / kWarps;
    init_items_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)nbr, v_pad, d, (const int*)rank_pad, n_rank,
        (const int*)roots, c, ww, (unsigned*)cand, (unsigned*)fini);
  }
  return (int)cudaGetLastError();
}
