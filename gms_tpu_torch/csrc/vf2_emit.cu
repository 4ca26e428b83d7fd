// K27 vf2_emit: stable compaction of one VF2 level's children.
//
// Replaces gms_tpu/algorithms/subgraph_iso.py `_emit` (:128). The children of
// (M int32[N, P], cand int32[N, Dc], ok bool[N, Dc]) are the pairs (n, i)
// with ok[n, i], in item-major order (n, then i), the order of gms_tpu's sort
// key. Child number r is row r of out int32[cap, P]: M's row n with column d
// set to cand[n, i]. Rows n_out..cap-1 are -1; children past cap are dropped
// (gms_tpu slices its sorted buffer to cap and pads it with -1 rows). *n_out
// gets the number of children, int64.
//
// Four launches on the stream, one call: a block per item counts its ok
// (block_sum_add into the zeroed cnt[n]); one block scans the counts into
// exclusive offsets and n_out; a block per item scans its row tile by tile
// and writes its children; a last pass fills the rows past n_out. The order
// decides which mapping limit=1 returns, and equals gms_tpu's.
// Bound on an H100: bytes — ok read once, each child's M row and candidate,
// and the cap x P output written.

#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "block_sum.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void item_count_kernel(const unsigned char* __restrict__ ok, int Dc,
                                  unsigned long long* __restrict__ cnt) {
  const long long n = blockIdx.x;
  long long c = 0;
  for (int i = threadIdx.x; i < Dc; i += blockDim.x) c += ok[n * Dc + i];
  block_sum_add(c, cnt + n);
}

// One block: cnt[0..N) := exclusive offsets, *n_out = the total.
__global__ void item_offsets_kernel(long long N, long long* __restrict__ cnt,
                                    long long* __restrict__ n_out) {
  __shared__ long long carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < N; base += blockDim.x) {
    const long long n = base + threadIdx.x;
    const long long c = n < N ? cnt[n] : 0;
    const long long off = block_scan(c, &carry);
    if (n < N) cnt[n] = off;
  }
  if (threadIdx.x == 0) *n_out = carry;
}

__global__ void write_children_kernel(const int* __restrict__ M, int P,
                                      const int* __restrict__ cand,
                                      const unsigned char* __restrict__ ok,
                                      int Dc, int d,
                                      const long long* __restrict__ off,
                                      long long cap, int* __restrict__ out) {
  __shared__ long long carry;
  const long long n = blockIdx.x;
  if (threadIdx.x == 0) carry = off[n];
  __syncthreads();
  const int* m = M + n * P;
  for (int base = 0; base < Dc; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const long long t = n * Dc + i;
    const bool live = i < Dc && ok[t] != 0;
    const long long r = block_scan<long long>(live ? 1 : 0, &carry);
    if (live && r < cap) {
      int* row = out + r * P;
      for (int j = 0; j < P; ++j) row[j] = j == d ? cand[t] : m[j];
    }
  }
}

__global__ void fill_tail_kernel(long long cap, int P,
                                 const long long* __restrict__ n_out,
                                 int* __restrict__ out) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e < cap * P && e / P >= *n_out) out[e] = -1;
}

}  // namespace

extern "C" int vf2_emit(const void* M, int P, const void* cand,
                        const void* ok, long long N, int Dc, int d,
                        long long cap, void* cnt, void* out, void* n_out,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N > 0 && Dc > 0)
    item_count_kernel<<<(unsigned)N, kThreads, 0, s>>>(
        (const unsigned char*)ok, Dc, (unsigned long long*)cnt);
  item_offsets_kernel<<<1, 1024, 0, s>>>(N, (long long*)cnt,
                                         (long long*)n_out);
  if (N > 0 && Dc > 0 && cap > 0)
    write_children_kernel<<<(unsigned)N, kThreads, 0, s>>>(
        (const int*)M, P, (const int*)cand, (const unsigned char*)ok, Dc, d,
        (const long long*)cnt, cap, (int*)out);
  if (cap * P > 0)
    fill_tail_kernel<<<(unsigned)((cap * P + kThreads - 1) / kThreads),
                       kThreads, 0, s>>>(cap, P, (const long long*)n_out,
                                         (int*)out);
  return (int)cudaGetLastError();
}
