// K7 symmetrize_bits: adj[c, i, j] |= adj[c, j, i] over int32[C, W, WW]
// bit words (W = 32*WW), written to a new array.
//
// Replaces gms_tpu/algorithms/bron_kerbosch.py:406 _symmetrize_bits, which
// unpacks SB rows at a time into a dense bool block, transposes it and packs
// it back, in a scan over row blocks sized to its memory budget. Here one
// block per root loads the root's W x WW words into shared memory (2 KB at
// W = 128; up to 96 KB, W = 512, then the rows are read from device memory
// through L1) and each thread builds output words: word (i, w) is adj[i, w]
// OR the bits i of rows 32w .. 32w+31, gathered one bit per row. Exact, bit
// for bit.
//
// Bound on an H100 (3.35 TB/s): bytes, the C x W x WW words read once and
// written once. Each output word reads 33 words, from shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemMax = 96 * 1024;

__global__ void symmetrize_kernel(const unsigned* __restrict__ adj, int ww,
                                  bool in_smem, unsigned* __restrict__ out) {
  extern __shared__ unsigned smem[];
  const int W = 32 * ww;
  const long long words = (long long)W * ww;
  const unsigned* src = adj + blockIdx.x * words;
  const unsigned* A = src;
  if (in_smem) {
    for (long long x = threadIdx.x; x < words; x += blockDim.x)
      smem[x] = src[x];
    __syncthreads();
    A = smem;
  }
  unsigned* dst = out + blockIdx.x * words;
  for (long long x = threadIdx.x; x < words; x += blockDim.x) {
    const int i = (int)(x / ww), w = (int)(x % ww);
    const int iw = i >> 5, ib = i & 31;
    const unsigned* col = A + (long long)32 * w * ww + iw;
    unsigned v = A[x];
    for (int j = 0; j < 32; ++j) v |= ((col[(long long)j * ww] >> ib) & 1u) << j;
    dst[x] = v;
  }
}

}  // namespace

extern "C" int symmetrize_bits(const void* adj, long long c, int ww, void* out,
                               void* stream) {
  if (c > 0 && ww > 0) {
    const size_t bytes = (size_t)32 * ww * ww * sizeof(unsigned);
    const bool in_smem = bytes <= kSmemMax;
    const size_t smem = in_smem ? bytes : 0;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          symmetrize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    symmetrize_kernel<<<(unsigned)c, kThreads, smem, (cudaStream_t)stream>>>(
        (const unsigned*)adj, ww, in_smem, (unsigned*)out);
  }
  return (int)cudaGetLastError();
}
