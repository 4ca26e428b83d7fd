// K28 kbit_decode_rows: padded neighbour rows from k-bit packed words.
//
// Replaces gms_tpu/graphs/compressed.py `kbit_decode_rows` (:43). Row v of
// packed uint32[V_pad, W] holds its neighbours at k bits each (1 <= k <= 32),
// lane j at bits [j k, j k + k) of the row read as one little-endian bit
// string. out[b, j] (int32[B, d_pad]) is lane j of row v = clip(vids[b]) for
// j < deg[v], else SENTINEL.
//
// One thread per output lane, decoded by kbit_lane (kbit_lane.cuh, shared
// with K31): two word loads, two shifts, an OR and a mask, with the C traps
// at s == 0 and k == 32 handled there. Bound on an H100: bytes — the packed
// words up to each row's last live lane, deg and vids read once, the output
// written.

#include <cuda_runtime.h>

#include "block_sum.cuh"
#include "kbit_lane.cuh"
#include "row_search.cuh"

namespace {

__global__ void kbit_decode_kernel(const unsigned* __restrict__ packed,
                                   long long v_pad, int W,
                                   const int* __restrict__ deg,
                                   const int* __restrict__ vids, long long B,
                                   int d_pad, int k, int* __restrict__ out) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= B * d_pad) return;
  const long long b = t / d_pad;
  const int j = (int)(t - b * d_pad);
  const long long v = clip_index(vids[b], v_pad);
  int val = GMS_SENTINEL;
  if (j < deg[v]) val = kbit_lane(packed + v * W, W, j, k);
  out[t] = val;
}

}  // namespace

extern "C" int kbit_decode_rows(const void* packed, long long v_pad, int W,
                                const void* deg, const void* vids, long long B,
                                int d_pad, int k, void* out, void* stream) {
  const long long total = B * d_pad;
  if (total > 0) {
    kbit_decode_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(
        (const unsigned*)packed, v_pad, W, (const int*)deg, (const int*)vids,
        B, d_pad, k, (int*)out);
  }
  return (int)cudaGetLastError();
}
