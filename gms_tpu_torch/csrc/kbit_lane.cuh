// Lane j of a k-bit packed row: the arithmetic shared by kbit_decode_rows
// (K28, kbit_decode.cu) and bfs_kbit_pull (K31, gapbs_kbit_bfs.cu).
//
// A row of W uint32 words holds its lanes at k bits each (1 <= k <= 32),
// lane j at bits [j k, j k + k) of the row read as one little-endian bit
// string: two word loads (w0 and its successor, clamped to W - 1), two
// shifts, an OR and a mask. The C traps gms_tpu's uint32 arithmetic does not
// have: at s == 0 the high part is 0 (w1 << 32 is undefined in C), and at
// k == 32 the mask is all ones ((1u << 32) - 1 is undefined).
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ int kbit_lane(const unsigned* row, int W,
                                         long long j, int k) {
  const long long bitpos = j * k;
  const long long w0i = bitpos >> 5;
  const unsigned s = (unsigned)(bitpos & 31);
  const long long w1i = w0i + 1 < W ? w0i + 1 : W - 1;
  const unsigned lo = row[w0i] >> s;
  const unsigned hi = s == 0 ? 0u : row[w1i] << (32 - s);
  const unsigned mask = k == 32 ? 0xffffffffu : ((1u << k) - 1u);
  return (int)((lo | hi) & mask);
}
