// K11 build_local_univ: per-root local universe of k-clique-star listing,
// the root's full neighbourhood: undirected and rank-oriented local
// adjacency bitsets and the initial candidate and star sets.
//
// Replaces gms_tpu/algorithms/k_clique_star.py:54 build_local_univ, whose
// two branches (a blocked broadcast compare and a searchsorted scan, chosen
// by size at :82) give the same bits; this one kernel gives them too. With
// r = roots[b], r_nbr[j] = nbr[clip(r, 0, V_pad-1), j] for j < min(W, D),
// SENTINEL beyond (W = 32*ww), rank(v) = rank_pad[clip(v, 0, n_rank-1)] and
// valid(j) = r_nbr[j] != SENTINEL:
//   bit j of adj_full[b, i] = valid(i) && valid(j) &&
//                             r_nbr[j] in nbr[clip(r_nbr[i]), 0:D]
//   bit j of adj_dag[b, i]  = bit j of adj_full[b, i] &&
//                             rank(r_nbr[j]) > rank(r_nbr[i])
//   bit j of S0[b]          = valid(j) && rank(r_nbr[j]) > rank(r)
//   bit j of I0[b]          = valid(j)
// Words are written as uint32 bits into int32 tensors.
//
// Design, as K4 (local_adj.cu): one block per root keeps the root's W slots
// and their ranks in shared memory; each warp takes local rows i in turn,
// reads row nbr[r_nbr[i]] 32 slots at a time up to its first SENTINEL, and
// each lane binary-searches its element among the root's slots
// (row_search.cuh; rows strictly ascending with a SENTINEL tail, the padded
// layout) and sets the bit in two per-warp word buffers, the second only if
// the slot ranks above row i's vertex. Both matrices are written in one pass.
//
// Bound on an H100 (3.35 TB/s): bytes. Each distinct row read once up to
// and including its first SENTINEL, the ranks of the roots and their slots,
// the roots, and the 2*C*W*WW + 2*C*WW output words written once. This
// kernel reads a row once per root that holds it (L2 catches the repeats)
// and does log2(W) shared-memory probes per element.

#include <cuda_runtime.h>

#include "row_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void univ_kernel(const int* __restrict__ nbr, long long v_pad,
                            int d, const int* __restrict__ rank_pad,
                            long long n_rank, const int* __restrict__ roots,
                            int ww, unsigned* __restrict__ adj_full,
                            unsigned* __restrict__ adj_dag,
                            unsigned* __restrict__ s0,
                            unsigned* __restrict__ i0) {
  extern __shared__ int smem[];
  const int W = 32 * ww;
  int* r_nbr = smem;                                        // [W]
  int* lrank = smem + W;                                    // [W]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* full = reinterpret_cast<unsigned*>(smem + 2 * W) + warp * 2 * ww;
  unsigned* dag = full + ww;
  const long long b = blockIdx.x;
  const long long r = roots[b];
  const int* root_row = nbr + clip_index(r, v_pad) * d;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const int v = j < d ? root_row[j] : GMS_SENTINEL;
    r_nbr[j] = v;
    lrank[j] = rank_pad[clip_index(v, n_rank)];
  }
  const int rrank = rank_pad[clip_index(r, n_rank)];
  __syncthreads();

  if (warp == 0) {
    for (int w = 0; w < ww; ++w) {
      const int j = 32 * w + lane;
      const bool valid = r_nbr[j] != GMS_SENTINEL;
      const unsigned vm = __ballot_sync(0xffffffffu, valid);
      const unsigned sm = __ballot_sync(0xffffffffu, valid && lrank[j] > rrank);
      if (lane == 0) {
        i0[b * ww + w] = vm;
        s0[b * ww + w] = sm;
      }
    }
  }

  for (int i = warp; i < W; i += kWarps) {
    for (int w = lane; w < ww; w += 32) full[w] = dag[w] = 0u;
    __syncwarp();
    const int u = r_nbr[i];
    if (u != GMS_SENTINEL) {
      const int ri = lrank[i];
      for_each_slot_in_row(nbr + clip_index(u, v_pad) * d, d, r_nbr, W, lane,
                           [&](int j) {
                             const unsigned bit = 1u << (j & 31);
                             atomicOr(full + (j >> 5), bit);
                             if (lrank[j] > ri) atomicOr(dag + (j >> 5), bit);
                           });
    }
    __syncwarp();
    const long long row = (b * W + i) * ww;
    for (int w = lane; w < ww; w += 32) {
      adj_full[row + w] = full[w];
      adj_dag[row + w] = dag[w];
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int build_local_univ(const void* nbr, long long v_pad, int d,
                                const void* rank_pad, long long n_rank,
                                const void* roots, long long c, int ww,
                                void* adj_full, void* adj_dag, void* s0,
                                void* i0, void* stream) {
  if (c > 0 && ww > 0 && n_rank > 0) {
    const size_t smem = (size_t)(2 * 32 * ww + kWarps * 2 * ww) * sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          univ_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    univ_kernel<<<(unsigned)c, kThreads, smem, (cudaStream_t)stream>>>(
        (const int*)nbr, v_pad, d, (const int*)rank_pad, n_rank,
        (const int*)roots, ww, (unsigned*)adj_full, (unsigned*)adj_dag,
        (unsigned*)s0, (unsigned*)i0);
  }
  return (int)cudaGetLastError();
}
