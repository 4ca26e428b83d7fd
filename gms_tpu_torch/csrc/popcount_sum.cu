// K38 total_popcount: the number of set bits in an array of 32-bit words,
// exact int64.
//
// Replaces gms_tpu/algorithms/k_clique.py:209 total_popcount (inlined in
// gms_tpu/parallel/multi.py:56, the last step of the sharded k-clique
// count: each bit of a (k-1)-clique item's candidates closes one k-clique).
//
// Design: a grid-stride loop, one __popc a word, 16-byte loads where the
// words are aligned, and one 64-bit atomicAdd a block (block_sum.cuh), so
// the total is order-free and equals a sequential sum.
//
// Bound on an H100: bytes, the words read once over 3.35 TB/s (one popcount
// a 4-byte word is far under the 16-a-clock-per-SM popcount rate).

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void popcount_kernel(const unsigned* __restrict__ words,
                                long long n, unsigned long long* out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long acc = 0;
  const bool vec = ((uintptr_t)words & 15u) == 0;
  const long long n4 = vec ? n / 4 : 0;
  const uint4* w4 = reinterpret_cast<const uint4*>(words);
  for (long long i = tid; i < n4; i += stride) {
    const uint4 v = __ldg(w4 + i);
    acc += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride)
    acc += __popc(__ldg(words + i));
  block_sum_add(acc, out);
}

}  // namespace

// words: int32[n]; out: int64, added to.
extern "C" int total_popcount(const void* words, long long n, void* out,
                              void* stream) {
  if (n > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    long long blocks = (n / 4 + kThreads - 1) / kThreads;
    const long long most = 8LL * (sms > 0 ? sms : 1);
    if (blocks > most) blocks = most;
    if (blocks < 1) blocks = 1;
    popcount_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)words, n, (unsigned long long*)out);
  }
  return (int)cudaGetLastError();
}
