// K28 kbit_decode_rows: padded neighbour rows from k-bit packed words.
//
// Replaces gms_tpu/graphs/compressed.py `kbit_decode_rows` (:43). Row v of
// packed uint32[V_pad, W] holds its neighbours at k bits each (1 <= k <= 32),
// lane j at bits [j k, j k + k) of the row read as one little-endian bit
// string. out[b, j] (int32[B, d_pad]) is lane j of row v = clip(vids[b]) for
// j < deg[v], else SENTINEL.
//
// One thread per output lane: two word loads (w0 and its successor, clamped
// to W - 1), two shifts, an OR and a mask. The C traps gms_tpu's uint32
// arithmetic does not have: at s == 0 the high part is 0 (w1 << 32 is
// undefined in C), and at k == 32 the mask is all ones ((1u << 32) - 1 is
// undefined). Bound on an H100: bytes — the packed words up to each row's
// last live lane, deg and vids read once, the output written.

#include <cuda_runtime.h>

#include "block_sum.cuh"
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
  if (j < deg[v]) {
    const long long bitpos = (long long)j * k;
    const long long w0i = bitpos >> 5;
    const unsigned s = (unsigned)(bitpos & 31);
    const long long w1i = w0i + 1 < W ? w0i + 1 : W - 1;
    const unsigned* row = packed + v * W;
    const unsigned lo = row[w0i] >> s;
    const unsigned hi = s == 0 ? 0u : row[w1i] << (32 - s);
    const unsigned mask = k == 32 ? 0xffffffffu : ((1u << k) - 1u);
    val = (int)((lo | hi) & mask);
  }
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
