// K4 build_local_adj: per-root local DAG adjacency bitsets and the initial
// candidate sets of k-clique counting.
//
// Replaces gms_tpu/algorithms/k_clique.py:82 build_local_adj, whose two
// branches (a blocked broadcast compare and a searchsorted scan, chosen by
// size at :113) give the same bits; this one kernel gives them too. With
// r = clip(roots[b], 0, V_pad-1) and r_nbr[j] = nbr[r, j] for j < min(W, D),
// SENTINEL beyond D (W = 32*ww):
//   bit j of adj[b, i] = r_nbr[i] != SENTINEL && r_nbr[j] != SENTINEL &&
//                        r_nbr[j] in nbr[clip(r_nbr[i]), 0:D]
//   bit j of S0[b]     = r_nbr[j] != SENTINEL
// Words are written as uint32 bits into int32 tensors.
//
// Design: one block per root. The root's W slots go to shared memory; each
// warp takes local rows i in turn and reads row nbr[r_nbr[i]] 32 slots at a
// time (coalesced), stopping at its first SENTINEL; each lane binary-searches
// its element among the root's slots (rows are strictly ascending with a
// SENTINEL tail, the padded-layout invariant) and sets the bit it finds in a
// per-warp word buffer in shared memory, which the warp then writes out
// (row_search.cuh, shared with K8 and K11).
//
// Bound on an H100 (3.35 TB/s): bytes. Each distinct row read once up to and
// including its first SENTINEL, the roots, and the C*W*WW + C*WW output words
// written once. This kernel reads a row once per root that holds it (L2
// catches the repeats) and does log2(W) shared-memory probes per element.

#include <cuda_runtime.h>

#include "row_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void local_adj_kernel(const int* __restrict__ nbr, long long v_pad,
                                 int d, const int* __restrict__ roots, int ww,
                                 unsigned* __restrict__ adj,
                                 unsigned* __restrict__ s0) {
  extern __shared__ int smem[];
  const int W = 32 * ww;
  int* r_nbr = smem;                                        // [W]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* bits = reinterpret_cast<unsigned*>(smem + W) + warp * ww;
  const long long b = blockIdx.x;
  const int* root_row = nbr + clip_index(roots[b], v_pad) * d;
  for (int j = threadIdx.x; j < W; j += blockDim.x)
    r_nbr[j] = j < d ? root_row[j] : GMS_SENTINEL;
  __syncthreads();

  if (warp == 0) {
    for (int w = 0; w < ww; ++w) {
      const unsigned m =
          __ballot_sync(0xffffffffu, r_nbr[32 * w + lane] != GMS_SENTINEL);
      if (lane == 0) s0[b * ww + w] = m;
    }
  }

  for (int i = warp; i < W; i += kWarps) {
    for (int w = lane; w < ww; w += 32) bits[w] = 0u;
    __syncwarp();
    const int u = r_nbr[i];
    if (u != GMS_SENTINEL)
      for_each_slot_in_row(nbr + clip_index(u, v_pad) * d, d, r_nbr, W, lane,
                           [&](int j) {
                             atomicOr(bits + (j >> 5), 1u << (j & 31));
                           });
    __syncwarp();
    unsigned* out = adj + (b * W + i) * ww;
    for (int w = lane; w < ww; w += 32) out[w] = bits[w];
    __syncwarp();
  }
}

}  // namespace

extern "C" int build_local_adj(const void* nbr, long long v_pad, int d,
                               const void* roots, long long c, int ww,
                               void* adj, void* s0, void* stream) {
  if (c > 0 && ww > 0) {
    const size_t smem = (size_t)(32 * ww + kWarps * ww) * sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          local_adj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    local_adj_kernel<<<(unsigned)c, kThreads, smem, (cudaStream_t)stream>>>(
        (const int*)nbr, v_pad, d, (const int*)roots, ww, (unsigned*)adj,
        (unsigned*)s0);
  }
  return (int)cudaGetLastError();
}
