// Decode of emitted rows into vertex ids: the kernel of
// decode_clique_members (bk_decode.cu, one bit block a row) and
// decode_star_rows (star_decode.cu, two).
//
// A row of out (int32[L, blocks*WW + 1]) is `blocks` bit blocks of WW words
// and a root-local index. With W = 32*WW, g = chunk[clip(out[l, blocks*WW],
// 0, C-1)] and the root's slots q[j] = nbr[clip(g, 0, V_pad-1), j] for
// j < min(W, D), SENTINEL beyond:
//   gid[l]               = g
//   ids[blk * L*W + l*W + j] = q[j] if bit j of block blk of row l is set and
//                              q[j] != SENTINEL, else -1
// One thread per (row, lane) pair, writing every block's id of that lane.
//
// Bound on an H100 (3.35 TB/s): bytes, out read once, gid and ids written
// once, and each distinct root row read once up to its first SENTINEL (a
// row is read again for every row rooted there; L2 catches the repeats).
#pragma once

#include <cuda_runtime.h>

#include "row_search.cuh"

namespace {

constexpr int kDecodeThreads = 256;

__global__ void decode_rows_kernel(const int* __restrict__ nbr,
                                   long long v_pad, int d,
                                   const int* __restrict__ chunk, long long c,
                                   const unsigned* __restrict__ out,
                                   long long l_rows, int ww, int blocks,
                                   int* __restrict__ gid,
                                   int* __restrict__ ids) {
  const int W = 32 * ww;
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= l_rows * W) return;
  const long long l = x / W;
  const int j = (int)(x % W);
  const unsigned* row = out + l * (blocks * ww + 1);
  const int g = chunk[clip_index((int)row[blocks * ww], c)];
  if (j == 0) gid[l] = g;
  const int v = j < d ? nbr[clip_index(g, v_pad) * d + j] : GMS_SENTINEL;
  for (int blk = 0; blk < blocks; ++blk) {
    const bool bit = (row[blk * ww + (j >> 5)] >> (j & 31)) & 1u;
    ids[blk * l_rows * W + x] = bit && v != GMS_SENTINEL ? v : -1;
  }
}

// Launches decode_rows_kernel on `stream`; returns cudaGetLastError().
inline int decode_rows(const void* nbr, long long v_pad, int d,
                       const void* chunk, long long c, const void* out,
                       long long l_rows, int ww, int blocks, void* gid,
                       void* ids, void* stream) {
  const long long n = l_rows * 32 * ww;
  if (n > 0 && c > 0) {
    decode_rows_kernel<<<(unsigned)((n + kDecodeThreads - 1) / kDecodeThreads),
                         kDecodeThreads, 0, (cudaStream_t)stream>>>(
        (const int*)nbr, v_pad, d, (const int*)chunk, c, (const unsigned*)out,
        l_rows, ww, blocks, (int*)gid, (int*)ids);
  }
  return (int)cudaGetLastError();
}

}  // namespace
