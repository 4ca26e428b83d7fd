// K39 member_pack: one rotation's membership bits of the ring-streamed
// vertex-sharded plans, OR-ed into the chunk's local bitsets.
//
// Replaces the two packs of gms_tpu/parallel/sharding.py that fold the
// visiting table shard into a root chunk's universe: `member_blocks`
// (:379-400, VertexShardedBKPlan, called twice a rotation: the induced DAG
// adjacency over the root's row Q, and the cover bitsets M over its lower
// neighbours) and the inline pack of VertexShardedKCliquePlan (:579-603).
// With q[c] the root's row (W = 32*ww slots, strictly ascending with a
// SENTINEL tail) and vis the visiting shard's rows (Vs x d, the same
// layout), for every slot i of locs[c, 0:L] with sel[c, i]:
//   out[c, i, :] |= {j : q[c, j] != SENTINEL &&
//                        q[c, j] in vis[clip(locs[c, i], 0, Vs-1), 0:d]}
// Unselected slots are left as they are. The caller selects the slots whose
// vertex the visiting shard owns, once a rotation (valid & owner == (me+t)
// mod N); words are uint32 bits in int32 tensors.
//
// Design, K4's (local_adj.cu): one block per root keeps q[c] in shared
// memory; a warp per selected slot reads its visiting row 32 slots at a
// time up to the first SENTINEL, each lane binary-searches its element among
// the root's slots and sets the bit in the warp's word buffer
// (row_search.cuh: warp_slot_bits), which the warp ORs into out. Over the N
// rotations every slot is selected once, so each out word is written once
// in all.
//
// Bound on an H100 (3.35 TB/s): bytes. Each distinct visiting row a
// selected slot names, read once up to and including its first SENTINEL;
// the q rows, locs and sel; the selected out words read and written once.
// This kernel reads a row once per root that names it (L2 catches the
// repeats) and does log2(W) shared-memory probes per element.

#include <cuda_runtime.h>

#include "row_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void member_kernel(const int* __restrict__ q_rows, int ww,
                              const int* __restrict__ vis, long long vs, int d,
                              const int* __restrict__ locs,
                              const unsigned char* __restrict__ sel, int L,
                              unsigned* __restrict__ out) {
  extern __shared__ int smem[];
  const int W = 32 * ww;
  int* q = smem;                                            // [W]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* bits = reinterpret_cast<unsigned*>(smem + W) + warp * ww;
  const long long c = blockIdx.x;
  for (int j = threadIdx.x; j < W; j += blockDim.x) q[j] = q_rows[c * W + j];
  __syncthreads();

  for (int i = warp; i < L; i += kWarps) {
    const long long slot = c * L + i;
    if (!sel[slot]) continue;
    warp_slot_bits(vis + clip_index(locs[slot], vs) * d, d, q, W, lane, bits,
                   ww);
    unsigned* o = out + slot * ww;
    for (int w = lane; w < ww; w += 32) o[w] |= bits[w];
    __syncwarp();
  }
}

}  // namespace

extern "C" int member_pack(const void* q, int ww, const void* vis,
                           long long vs, int d, const void* locs,
                           const void* sel, long long c, int L, void* out,
                           void* stream) {
  if (c > 0 && ww > 0 && L > 0 && vs > 0) {
    const size_t smem = (size_t)(32 * ww + kWarps * ww) * sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          member_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    member_kernel<<<(unsigned)c, kThreads, smem, (cudaStream_t)stream>>>(
        (const int*)q, ww, (const int*)vis, vs, d, (const int*)locs,
        (const unsigned char*)sel, L, (unsigned*)out);
  }
  return (int)cudaGetLastError();
}
