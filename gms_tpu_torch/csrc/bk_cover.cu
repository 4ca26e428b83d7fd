// K8 hub_cover_bits: the cover bitsets of Bron-Kerbosch's leaf maximality
// filter, read straight from the lower-neighbour CSR.
//
// Replaces gms_tpu/algorithms/bron_kerbosch.py:876 _gather_wlists (each
// root's lower-ranked neighbour list, padded with SENTINEL to IN slots) and
// :376 _hub_cover_bits (a blocked broadcast compare of each listed w's DAG
// row against the root's W DAG slots). With r = roots[b], n the vertices,
// live = r < n, s = clip(r, 0, n-1), cnt = live ? indptr[s+1] - indptr[s] : 0,
// w_i = i < cnt ? cols[clip(indptr[s] + i)] : SENTINEL, and the root's slots
// q[j] = nbr[clip(r, 0, V_pad-1), j] for j < min(W, D), SENTINEL beyond:
//   bit j of M[b, i] = q[j] != SENTINEL && q[j] in nbr[clip(w_i), 0:D]
//   wvalid[b, i]     = w_i != SENTINEL
// (a SENTINEL w clips to the all-SENTINEL guard row V_pad-1: no bits). The
// lists are not materialized.
//
// Design, as K4 (local_adj.cu): one block per root keeps the root's W slots
// in shared memory; a warp per (root, i) reads w_i's row 32 slots at a time
// up to its first SENTINEL, and each lane binary-searches its element among
// the root's slots (rows strictly ascending with a SENTINEL tail, the padded
// layout) and sets the bit in a per-warp word buffer, which the warp writes
// (row_search.cuh).
//
// Bound on an H100 (3.35 TB/s): bytes. Each distinct DAG row read (the
// roots' and their lower neighbours') up to and including its first
// SENTINEL, the roots' CSR entries, and M and wvalid written once. This
// kernel reads a row once per root that lists it (L2 catches the repeats).

#include <cuda_runtime.h>

#include "row_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void cover_kernel(const int* __restrict__ nbr, long long v_pad,
                             int d, const int* __restrict__ indptr,
                             long long n, const int* __restrict__ cols,
                             long long n_cols, const int* __restrict__ roots,
                             int ww, int in_w, unsigned* __restrict__ m,
                             unsigned char* __restrict__ wvalid) {
  extern __shared__ int smem[];
  const int W = 32 * ww;
  int* q = smem;                                            // [W]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* bits = reinterpret_cast<unsigned*>(smem + W) + warp * ww;
  const long long b = blockIdx.x;
  const long long r = roots[b];
  const int* root_row = nbr + clip_index(r, v_pad) * d;
  for (int j = threadIdx.x; j < W; j += blockDim.x)
    q[j] = j < d ? root_row[j] : GMS_SENTINEL;
  const long long s = clip_index(r, n);
  const long long start = indptr[s];
  const long long cnt = r < n ? indptr[s + 1] - start : 0;
  __syncthreads();

  for (int i = warp; i < in_w; i += kWarps) {
    const int u = i < cnt ? cols[clip_index(start + i, n_cols)] : GMS_SENTINEL;
    warp_slot_bits(
        u != GMS_SENTINEL ? nbr + clip_index(u, v_pad) * d : nullptr, d, q, W,
        lane, bits, ww);
    unsigned* out = m + (b * in_w + i) * ww;
    for (int w = lane; w < ww; w += 32) out[w] = bits[w];
    if (lane == 0) wvalid[b * in_w + i] = u != GMS_SENTINEL;
    __syncwarp();
  }
}

}  // namespace

extern "C" int hub_cover_bits(const void* nbr, long long v_pad, int d,
                              const void* indptr, long long n, const void* cols,
                              long long n_cols, const void* roots, long long c,
                              int ww, int in_w, void* m, void* wvalid,
                              void* stream) {
  if (c > 0 && ww > 0 && in_w > 0 && n > 0) {
    const size_t smem = (size_t)(32 * ww + kWarps * ww) * sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          cover_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    cover_kernel<<<(unsigned)c, kThreads, smem, (cudaStream_t)stream>>>(
        (const int*)nbr, v_pad, d, (const int*)indptr, n, (const int*)cols,
        n_cols, (const int*)roots, ww, in_w, (unsigned*)m,
        (unsigned char*)wvalid);
  }
  return (int)cudaGetLastError();
}
