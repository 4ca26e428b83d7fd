// K10 decode_clique_members: emitted Bron-Kerbosch rows -> member ids.
//
// Replaces gms_tpu/algorithms/bron_kerbosch.py:832 decode_clique_members.
// A row of out (int32[L, WW+1]) is (Rbits[WW] | root-local index). With
// W = 32*WW, g = chunk[clip(out[l, WW], 0, C-1)] and the root's slots
// q[j] = nbr[clip(g, 0, V_pad-1), j] for j < min(W, D), SENTINEL beyond:
//   gid[l]        = g
//   members[l, j] = q[j] if bit j of Rbits is set and q[j] != SENTINEL,
//                   else -1
// One thread per (row, lane) pair.
//
// Bound on an H100 (3.35 TB/s): bytes, out read once, gid and members
// written once, and each distinct root row read once up to its first
// SENTINEL (a row is read again for every clique rooted there; L2 catches
// the repeats).

#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long clip(long long v, long long n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

__global__ void decode_kernel(const int* __restrict__ nbr, long long v_pad,
                              int d, const int* __restrict__ chunk,
                              long long c, const unsigned* __restrict__ out,
                              long long l_rows, int ww,
                              int* __restrict__ gid, int* __restrict__ members) {
  const int W = 32 * ww;
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= l_rows * W) return;
  const long long l = x / W;
  const int j = (int)(x % W);
  const unsigned* row = out + l * (ww + 1);
  const int g = chunk[clip((int)row[ww], c)];
  if (j == 0) gid[l] = g;
  const bool bit = (row[j >> 5] >> (j & 31)) & 1u;
  const int v = j < d ? nbr[clip(g, v_pad) * d + j] : GMS_SENTINEL;
  members[x] = bit && v != GMS_SENTINEL ? v : -1;
}

}  // namespace

extern "C" int decode_clique_members(const void* nbr, long long v_pad, int d,
                                     const void* chunk, long long c,
                                     const void* out, long long l_rows, int ww,
                                     void* gid, void* members, void* stream) {
  const long long n = l_rows * 32 * ww;
  if (n > 0 && c > 0) {
    decode_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                    (cudaStream_t)stream>>>(
        (const int*)nbr, v_pad, d, (const int*)chunk, c, (const unsigned*)out,
        l_rows, ww, (int*)gid, (int*)members);
  }
  return (int)cudaGetLastError();
}
