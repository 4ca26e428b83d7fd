// K5 kclique_dense_count: k-cliques (k = 3, 4, 5) rooted at a chunk, from
// the chunk's local DAG adjacency A (bit j of A_i: local edge i -> j).
//
// Replaces the counting half of gms_tpu/algorithms/k_clique.py:548
// kclique_dense_chunk, which unpacks A to 0/1 bf16 and runs the products on
// its matrix unit (Σ A, Σ A⊙(A@A), Σ M⊙(M@A)). Here the same sums are taken
// over the bits:
//   k=3: Σ popcount(A)
//   k=4: Σ_b Σ_i Σ_{j∈A_i} popcount(A_i & A_j)
//   k=5: Σ_b Σ_i Σ_{j∈A_i} Σ_{m∈A_i∩A_j} popcount(A_i & A_j & A_m)
// exactly, in int64 (one 64-bit atomicAdd per block), at any W: the f32
// limit of the matrix-unit form (:574-582) does not arise.
//
// Design: one block per root. The root's W x WW words go to shared memory
// when they fit (W <= 1024: 128 KB) and are read from device memory (through
// L1/L2) otherwise. k=3: threads stride over the words. k=4/5: threads
// stride over the W*W pairs (i, j) and skip pairs with j not in A_i; a kept
// pair ANDs the two rows (k=4) or walks the bits m of A_i & A_j and ANDs the
// three rows (k=5).
//
// Bound on an H100: the larger of the bytes (A read once, 3.35 TB/s) and the
// operations the data needs: one AND+popcount per word per (b, i, j) with
// j ∈ A_i for k=4 (the chunk's k=3 count × WW), per (b, i, j, m) for k=5
// (its k=4 count × WW), at the popcount rate of compute capability 9.0
// (16 per clock per SM, CUDA C++ Programming Guide, arithmetic instructions
// table) × 132 SMs × the SM clock. Popcounts bind. Pairs with j ∉ A_i cost a
// test each here, which the bound does not count.

#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 200 * 1024;

__global__ void dense_kernel(const unsigned* __restrict__ adj, int ww, int k,
                             int use_smem, unsigned long long* out) {
  extern __shared__ unsigned sA[];
  const int W = 32 * ww;
  const long long words = (long long)W * ww;
  const unsigned* gA = adj + blockIdx.x * words;
  const unsigned* A = gA;
  if (use_smem) {
    for (long long t = threadIdx.x; t < words; t += blockDim.x) sA[t] = gA[t];
    __syncthreads();
    A = sA;
  }
  long long cnt = 0;
  if (k == 3) {
    for (long long t = threadIdx.x; t < words; t += blockDim.x)
      cnt += __popc(A[t]);
  } else {
    const long long pairs = (long long)W * W;
    for (long long t = threadIdx.x; t < pairs; t += blockDim.x) {
      const int i = (int)(t / W), j = (int)(t - (long long)i * W);
      const unsigned* Ai = A + (long long)i * ww;
      if (!((Ai[j >> 5] >> (j & 31)) & 1u)) continue;
      const unsigned* Aj = A + (long long)j * ww;
      if (k == 4) {
        int c = 0;
        for (int w = 0; w < ww; ++w) c += __popc(Ai[w] & Aj[w]);
        cnt += c;
        continue;
      }
      for (int w = 0; w < ww; ++w) {
        unsigned x = Ai[w] & Aj[w];
        while (x) {
          const int m = 32 * w + __ffs(x) - 1;
          x &= x - 1;
          const unsigned* Am = A + (long long)m * ww;
          int c = 0;
          for (int v = 0; v < ww; ++v) c += __popc(Ai[v] & Aj[v] & Am[v]);
          cnt += c;
        }
      }
    }
  }
  block_sum_add(cnt, out);
}

}  // namespace

extern "C" int kclique_dense_count(const void* adj, long long c, int ww, int k,
                                   void* out, void* stream) {
  if (c > 0 && ww > 0) {
    const size_t bytes = (size_t)32 * ww * ww * sizeof(unsigned);
    const int use_smem = k != 3 && bytes <= kMaxSmem;  // k=3 reads A once
    const size_t smem = use_smem ? bytes : 0;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dense_kernel<<<(unsigned)c, kThreads, smem, (cudaStream_t)stream>>>(
        (const unsigned*)adj, ww, k, use_smem, (unsigned long long*)out);
  }
  return (int)cudaGetLastError();
}
