// K3 build_hub_rows: hub bitmap row i has bit hub_id[w] set for every
// w in N+(wide_ids[i]).
//
// Replaces gms_tpu/algorithms/triangle_count.py:219 build_hub_rows, run once
// while a TrianglePlan is built. The JAX program gathers with mode="clip" and
// scatter-adds with mode="drop" into hw+1 words, then slices the overflow word
// off; here each index is clipped the same way and an out-of-range bit is
// simply not written:
//   r = nbr[min(wide_ids[i], V_pad-1), slot]
//   h = hub_id[min(r, V_pad)]      (SENTINEL slots clip to the last entry,
//                                   whose value 32*hw means "drop")
//   if h < 32*hw: set bit h&31 of word h>>5.
// Neighbours of a row are distinct, so their bits are distinct and the JAX
// program's add equals the atomicOr used here. The wrapper zero-fills the
// output (int32 words carrying the uint32 bits).
//
// Design: one thread per (row, slot); neighbouring threads read neighbouring
// slots of a row, so the nbr reads coalesce; hub_id lookups are random but the
// 1 MB table (at 2^18 vertices) stays in L2; the bit is set with atomicOr.
//
// Bound on an H100 (3.35 TB/s): each wide row up to and including its first
// SENTINEL, wide_ids, the hub_id entries looked up and the Nw*hw output words,
// each moved once. This kernel reads all D_pad slots of every row, SENTINEL
// tail included, which is most of the gap to that bound.

#include <cuda_runtime.h>

namespace {

__global__ void hub_rows_kernel(const int* __restrict__ nbr, long long v_pad,
                                int d_pad, const int* __restrict__ hub_id,
                                const int* __restrict__ wide_ids, long long nw,
                                int hw, unsigned* out) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= nw * d_pad) return;
  const long long i = t / d_pad;
  const int slot = (int)(t - i * d_pad);
  long long u = wide_ids[i];
  u = u < 0 ? 0 : (u >= v_pad ? v_pad - 1 : u);
  long long r = nbr[u * d_pad + slot];
  r = r < 0 ? 0 : (r > v_pad ? v_pad : r);
  const int h = hub_id[r];
  if (h >= 0 && h < 32 * hw) atomicOr(out + i * hw + (h >> 5), 1u << (h & 31));
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int build_hub_rows(const void* nbr, long long v_pad, int d_pad,
                              const void* hub_id, const void* wide_ids,
                              long long nw, int hw, void* out, void* stream) {
  const long long n = nw * d_pad;
  if (n > 0 && hw > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    hub_rows_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)nbr, v_pad, d_pad, (const int*)hub_id,
        (const int*)wide_ids, nw, hw, (unsigned*)out);
  }
  return (int)cudaGetLastError();
}
