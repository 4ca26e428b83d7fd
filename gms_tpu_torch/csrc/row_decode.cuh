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
//
// Design: a warp a row (at W = 32 a group of 8 lanes a row and four rows a
// warp, at W = 64 16 lanes and two), several rows a block, a grid-stride
// loop over rows. The group's first lane reads the row's index word and
// chunk[...] once and broadcasts g by shuffle, and writes gid. Each lane
// takes four consecutive slots at a time: their 4 bits of each block's word,
// the root's 4 slots in one 16-byte load where they lie inside min(W, D) and
// D keeps them 16-byte aligned (scalar loads otherwise; none where no bit is
// set, as for most slots), and one 16-byte streaming store a block. No 64-bit
// division: rows are walked by index, slots by lane.
//
// Bound on an H100 (3.35 TB/s): bytes, out read once, gid and ids written
// once, and each distinct root row read once up to its first SENTINEL (a
// row is read again for every row rooted there; L1 and L2 catch the
// repeats).
#pragma once

#include <cuda_runtime.h>

#include "row_search.cuh"

namespace {

constexpr int kDecodeThreads = 256;
constexpr int kDecodeBlocksPerSM = 2048 / kDecodeThreads;

template <int kBlocks>
__global__ void __launch_bounds__(kDecodeThreads) decode_rows_kernel(
    const int* __restrict__ nbr, long long v_pad, int d,
    const int* __restrict__ chunk, long long c,
    const unsigned* __restrict__ out, long long l_rows, int ww,
    int* __restrict__ gid, int* __restrict__ ids) {
  const int W = 32 * ww;
  const int log_group = ww == 1 ? 3 : (ww == 2 ? 4 : 5);  // lanes a row
  const int group = 1 << log_group;
  const int lane = threadIdx.x & 31;
  const int sub = lane >> log_group, gl = lane & (group - 1);
  const int rows_per_warp = 32 >> log_group;
  const int stride = kBlocks * ww + 1;
  const int wmax = W < d ? W : d;
  const bool vec =
      (d & 3) == 0 && (reinterpret_cast<size_t>(nbr) & 15) == 0;
  const long long plane = l_rows * W;
  const long long warps = (long long)gridDim.x * (kDecodeThreads / 32);
  for (long long base = ((long long)blockIdx.x * (kDecodeThreads / 32) +
                         (threadIdx.x >> 5)) * rows_per_warp;
       base < l_rows; base += warps * rows_per_warp) {
    const long long l = base + sub;
    const bool live = l < l_rows;
    const unsigned* row = out + (live ? l : 0) * stride;
    int g = 0;
    if (gl == 0 && live) g = chunk[clip_index((int)row[kBlocks * ww], c)];
    g = __shfl_sync(0xffffffffu, g, 0, group);
    if (!live) continue;  // the warp's last rows: no later shuffle
    if (gl == 0) gid[l] = g;
    const int* q = nbr + clip_index(g, v_pad) * d;
    int* dst = ids + l * W;
    for (int j0 = 4 * gl; j0 < W; j0 += 4 * group) {
      unsigned nib[kBlocks];
      unsigned any = 0u;
#pragma unroll
      for (int blk = 0; blk < kBlocks; ++blk) {
        nib[blk] = (row[blk * ww + (j0 >> 5)] >> (j0 & 31)) & 0xfu;
        any |= nib[blk];
      }
      int4 x = make_int4(GMS_SENTINEL, GMS_SENTINEL, GMS_SENTINEL,
                         GMS_SENTINEL);
      if (any) {
        if (vec && j0 + 4 <= wmax) {
          x = *reinterpret_cast<const int4*>(q + j0);
        } else {
          if (j0 < wmax) x.x = q[j0];
          if (j0 + 1 < wmax) x.y = q[j0 + 1];
          if (j0 + 2 < wmax) x.z = q[j0 + 2];
          if (j0 + 3 < wmax) x.w = q[j0 + 3];
        }
      }
#pragma unroll
      for (int blk = 0; blk < kBlocks; ++blk) {
        const unsigned bt = nib[blk];
        int4 v;
        v.x = (bt & 1u) && x.x != GMS_SENTINEL ? x.x : -1;
        v.y = (bt & 2u) && x.y != GMS_SENTINEL ? x.y : -1;
        v.z = (bt & 4u) && x.z != GMS_SENTINEL ? x.z : -1;
        v.w = (bt & 8u) && x.w != GMS_SENTINEL ? x.w : -1;
        __stcs(reinterpret_cast<int4*>(dst + blk * plane + j0), v);
      }
    }
  }
}

// Launches decode_rows_kernel on `stream`; returns cudaGetLastError().
// gid and ids are the wrapper's own 16-byte aligned allocations.
template <int kBlocks>
int decode_rows(const void* nbr, long long v_pad, int d, const void* chunk,
                long long c, const void* out, long long l_rows, int ww,
                void* gid, void* ids, void* stream) {
  if (l_rows > 0 && ww > 0 && c > 0) {
    const int rows_per_warp = ww == 1 ? 4 : (ww == 2 ? 2 : 1);
    const long long per_block = (long long)(kDecodeThreads / 32) *
                                rows_per_warp;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    long long grid = (l_rows + per_block - 1) / per_block;
    if (grid > (long long)sms * kDecodeBlocksPerSM)
      grid = (long long)sms * kDecodeBlocksPerSM;
    decode_rows_kernel<kBlocks>
        <<<(unsigned)grid, kDecodeThreads, 0, (cudaStream_t)stream>>>(
            (const int*)nbr, v_pad, d, (const int*)chunk, c,
            (const unsigned*)out, l_rows, ww, (int*)gid, (int*)ids);
  }
  return (int)cudaGetLastError();
}

}  // namespace
