// K5 kclique_dense_count: k-cliques (k = 3, 4, 5) rooted at a chunk, from
// the chunk's local DAG adjacency A (bit j of A_i: local edge i -> j).
//
// Replaces the counting half of gms_tpu/algorithms/k_clique.py:548
// kclique_dense_chunk, which unpacks A to 0/1 bf16 and runs the products on
// its matrix unit (Σ A, Σ A⊙(A@A), Σ M⊙(M@A)). Here the same sums are taken
// over the bits:
//   k=3: Σ popcount(A)
//   k=4: Σ_b Σ_i Σ_{j∈A_i} popcount(A_i & A_j)
//   k=5: Σ_b Σ_i Σ_{j∈A_i} Σ_{m∈X} popcount(X & A_m),  X = A_i & A_j
// exactly, in int64 (one 64-bit atomicAdd per block), at any W: the f32
// limit of the matrix-unit form (:574-582) does not arise.
//
// Bound on an H100: the larger of the bytes (A read once, 3.35 TB/s) and the
// AND+popcount words the sums need, a word only where it can be non-zero:
// A_i's non-zero words for each (b, i, j) with j ∈ A_i (k=4; at k=5 they
// form X), and at k=5 also X's non-zero words for each (b, i, j, m) with
// m ∈ X (kclique_dense_count_plain's stats count them), at the popcount
// rate of compute capability 9.0 (16 per clock per SM, CUDA C++ Programming
// Guide, arithmetic instructions table) × 132 SMs × the SM clock. Popcounts
// bind. The kernel at W <= 256 ANDs whole rows (WW words each (i, j, m)),
// more words than the bound counts; the generic kernel skips X's zero words
// but is 2.3-2.8x slower on the same chunks (its bit ring, X recomputed a
// word an m, scalar row loads), so the per-WW kernels stay.
//
// Design: the lanes take the set bits of a row, never the W² pairs. A block
// takes a (root, slab of kSlabRows rows), a warp two of the slab's rows, so a
// heavy root spreads over the grid; a block whose rows are all zero (a
// SENTINEL root, rows past the root's degree) leaves after reading them.
// A live block stages the root's W × WW words in shared memory (8 KB at
// W = 256). k=4: the warp lists the j ∈ A_i (each lane writes its own bit
// of each word at its rank, a popcount of the lower lanes), then each lane
// takes one j and ANDs A_j with A_i, which every lane holds in registers.
// k=5: for each j of that list in turn, X = A_i & A_j (the same in every
// lane), the warp lists the m ∈ X and each lane takes one m, 32 at a time,
// ANDing X with A_m. Rows are read from shared memory in 16-byte loads at
// WW = 4 and 8 (8-byte at WW = 2, 6). WW = 1..8 (W <= 256, every chunk of
// the main path and the ring plan's W = 224) are compiled per WW, X and A_i
// in registers; wider chunks take a generic kernel that walks the bits 32
// at a time through a 64-entry ring a warp and skips X's zero words, the
// root staged while it fits in 64 KB (W <= 704), else read from device
// memory. k=3: a grid-stride popcount stream.

#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlabRows = 2 * kWarps;     // rows a block; two a warp
constexpr int kRing = 64;                 // ints of a generic walk's ring
constexpr size_t kStageBytes = 64 * 1024;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__global__ void popcount_kernel(const unsigned* __restrict__ adj, long long n,
                                unsigned long long* out) {
  long long cnt = 0;
  for (long long t = blockIdx.x * (long long)kThreads + threadIdx.x; t < n;
       t += (long long)gridDim.x * kThreads)
    cnt += __popc(adj[t]);
  block_sum_add(cnt, out);
}

// --- W <= 256: WW known at compile time ------------------------------------

// Row r of the staged root (shared memory, 16-byte aligned).
template <int WW>
__device__ __forceinline__ void load_row(const unsigned* A, int r,
                                         unsigned (&v)[WW]) {
  const unsigned* p = A + r * WW;
  if constexpr (WW % 4 == 0) {
#pragma unroll
    for (int q = 0; q < WW / 4; ++q) {
      const uint4 t = reinterpret_cast<const uint4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (WW % 2 == 0) {
#pragma unroll
    for (int q = 0; q < WW / 2; ++q) {
      const uint2 t = reinterpret_cast<const uint2*>(p)[q];
      v[2 * q] = t.x;
      v[2 * q + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int w = 0; w < WW; ++w) v[w] = p[w];
  }
}

template <int WW>
__device__ __forceinline__ bool any_bit(const unsigned (&v)[WW]) {
  unsigned o = 0;
#pragma unroll
  for (int w = 0; w < WW; ++w) o |= v[w];
  return o != 0;
}

template <int WW>
__device__ __forceinline__ int and_popc(const unsigned (&a)[WW],
                                        const unsigned (&b)[WW]) {
  int c = 0;
#pragma unroll
  for (int w = 0; w < WW; ++w) c += __popc(a[w] & b[w]);
  return c;
}

// Lists the set bits of v (the same bitset in every lane) into L in
// ascending order and returns their number: each lane writes its own bit of
// each word at its rank. L is read after the __syncwarp here; the caller
// __syncwarp()s before L is written again.
template <int WW>
__device__ __forceinline__ int list_bits(const unsigned (&v)[WW], int* L) {
  const int lane = threadIdx.x & 31;
  const unsigned below = lanes_below();
  int n = 0;
#pragma unroll
  for (int w = 0; w < WW; ++w) {
    if ((v[w] >> lane) & 1u) L[n + __popc(v[w] & below)] = 32 * w + lane;
    n += __popc(v[w]);
  }
  __syncwarp();
  return n;
}

// Shared memory: the root [W * WW] words, then each warp's two lists of W.
template <int WW, int K>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const unsigned* __restrict__ adj, int slabs,
            unsigned long long* out) {
  constexpr int W = 32 * WW;
  extern __shared__ uint4 smem[];
  unsigned* A = reinterpret_cast<unsigned*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* J = reinterpret_cast<int*>(A + W * WW) + warp * 2 * W;
  int* M = J + W;
  const unsigned* gA = adj + (long long)(blockIdx.x / slabs) * (W * WW);
  const int i0 = (blockIdx.x % slabs) * kSlabRows + warp;

  unsigned ai[2][WW];
  bool live = false;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + r * kWarps;
#pragma unroll
    for (int w = 0; w < WW; ++w) ai[r][w] = i < W ? gA[i * WW + w] : 0u;
    live |= any_bit<WW>(ai[r]);
  }
  if (!__syncthreads_or(live)) return;
  for (int t = threadIdx.x; t < W * WW; t += kThreads) A[t] = gA[t];
  __syncthreads();

  long long cnt = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!any_bit<WW>(ai[r])) continue;
    const int n = list_bits<WW>(ai[r], J);
    if constexpr (K == 4) {
      for (int b = lane; b < n; b += 32) {
        unsigned aj[WW];
        load_row<WW>(A, J[b], aj);
        cnt += and_popc<WW>(ai[r], aj);
      }
    } else {
      for (int t = 0; t < n; ++t) {
        unsigned x[WW];
        load_row<WW>(A, J[t], x);
#pragma unroll
        for (int w = 0; w < WW; ++w) x[w] &= ai[r][w];
        if (!any_bit<WW>(x)) continue;
        const int nx = list_bits<WW>(x, M);
        for (int b = lane; b < nx; b += 32) {
          unsigned am[WW];
          load_row<WW>(A, M[b], am);
          cnt += and_popc<WW>(x, am);
        }
        __syncwarp();
      }
    }
    __syncwarp();
  }
  block_sum_add(cnt, out);
}

// --- any W ------------------------------------------------------------------

// Calls body(m) in every lane, one set bit m a lane, 32 bits at a time (a
// lane without a bit in the last call gets -1), for the bitset whose words
// word(0 .. nw) gives alike in every lane. ring: the warp's kRing ints.
template <class Word, class Body>
__device__ __forceinline__ void for_bits(int nw, int* ring, Word word,
                                         Body body) {
  const int lane = threadIdx.x & 31;
  const unsigned below = lanes_below();
  int have = 0;
  for (int w = 0; w < nw; ++w) {
    const unsigned x = word(w);
    if (!x) continue;
    if ((x >> lane) & 1u) ring[have + __popc(x & below)] = 32 * w + lane;
    have += __popc(x);
    if (have >= 32) {
      __syncwarp();
      const int m = ring[lane];
      have -= 32;
      const int carry = lane < have ? ring[32 + lane] : 0;
      __syncwarp();
      if (lane < have) ring[lane] = carry;
      __syncwarp();
      body(m);
    }
  }
  if (have > 0) {
    __syncwarp();
    const int m = lane < have ? ring[lane] : -1;
    __syncwarp();
    body(m);
  }
}

// Shared memory: each warp's two rings, then the root's W * ww words when
// `stage` (else A is read from device memory).
template <int K>
__global__ void __launch_bounds__(kThreads)
rows_any_kernel(const unsigned* __restrict__ adj, int ww, int slabs,
                int stage, unsigned long long* out) {
  extern __shared__ uint4 smem[];
  const int W = 32 * ww;
  const long long words = (long long)W * ww;
  int* ring_j = reinterpret_cast<int*>(smem) + (threadIdx.x >> 5) * 2 * kRing;
  int* ring_m = ring_j + kRing;
  unsigned* sA = reinterpret_cast<unsigned*>(smem) + kWarps * 2 * kRing;
  const int lane = threadIdx.x & 31;
  const unsigned* gA = adj + (long long)(blockIdx.x / slabs) * words;
  const int i0 = (blockIdx.x % slabs) * kSlabRows + (threadIdx.x >> 5);

  bool live = false;
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + r * kWarps;
    if (i < W)
      for (int w = lane; w < ww; w += 32) live |= gA[(long long)i * ww + w] != 0;
  }
  if (!__syncthreads_or(live)) return;
  const unsigned* A = gA;
  if (stage) {
    for (long long t = threadIdx.x; t < words; t += kThreads) sA[t] = gA[t];
    __syncthreads();
    A = sA;
  }

  long long cnt = 0;
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + r * kWarps;
    if (i >= W) break;
    const unsigned* Ai = A + (long long)i * ww;
    auto row_i = [&](int w) { return Ai[w]; };
    if constexpr (K == 4) {
      for_bits(ww, ring_j, row_i, [&](int j) {
        if (j < 0) return;
        const unsigned* Aj = A + (long long)j * ww;
        for (int w = 0; w < ww; ++w) {
          const unsigned a = Ai[w];
          if (a) cnt += __popc(a & Aj[w]);
        }
      });
    } else {
      for_bits(ww, ring_j, row_i, [&](int my_j) {
        for (int s = 0; s < 32; ++s) {
          const int j = __shfl_sync(kAll, my_j, s);
          if (j < 0) break;
          const unsigned* Aj = A + (long long)j * ww;
          auto x_of = [&](int w) { return Ai[w] & Aj[w]; };
          for_bits(ww, ring_m, x_of, [&](int m) {
            if (m < 0) return;
            const unsigned* Am = A + (long long)m * ww;
            for (int w = 0; w < ww; ++w) {
              const unsigned x = x_of(w);
              if (x) cnt += __popc(x & Am[w]);
            }
          });
        }
      });
    }
  }
  block_sum_add(cnt, out);
}

template <int WW, int K>
cudaError_t launch_rows(const unsigned* adj, long long c,
                        unsigned long long* out, cudaStream_t stream) {
  constexpr int W = 32 * WW;
  constexpr int slabs = (W + kSlabRows - 1) / kSlabRows;
  constexpr size_t smem = (size_t)(W * WW + kWarps * 2 * W) * sizeof(unsigned);
  static_assert(smem <= 48 * 1024, "rows_kernel's shared memory");
  rows_kernel<WW, K><<<(unsigned)(c * slabs), kThreads, smem, stream>>>(
      adj, slabs, out);
  return cudaSuccess;
}

template <int K>
cudaError_t launch_k(const unsigned* adj, long long c, int ww,
                     unsigned long long* out, cudaStream_t stream) {
  switch (ww) {
    case 1: return launch_rows<1, K>(adj, c, out, stream);
    case 2: return launch_rows<2, K>(adj, c, out, stream);
    case 3: return launch_rows<3, K>(adj, c, out, stream);
    case 4: return launch_rows<4, K>(adj, c, out, stream);
    case 5: return launch_rows<5, K>(adj, c, out, stream);
    case 6: return launch_rows<6, K>(adj, c, out, stream);
    case 7: return launch_rows<7, K>(adj, c, out, stream);
    case 8: return launch_rows<8, K>(adj, c, out, stream);
    default: break;
  }
  const int W = 32 * ww;
  const int slabs = (W + kSlabRows - 1) / kSlabRows;
  const size_t root = (size_t)W * ww * sizeof(unsigned);
  const int stage = root <= kStageBytes;
  const size_t smem = kWarps * 2 * kRing * sizeof(int) + (stage ? root : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rows_any_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  rows_any_kernel<K><<<(unsigned)(c * slabs), kThreads, smem, stream>>>(
      adj, ww, slabs, stage, out);
  return cudaSuccess;
}

}  // namespace

extern "C" int kclique_dense_count(const void* adj, long long c, int ww, int k,
                                   void* out, void* stream) {
  if (c > 0 && ww > 0) {
    const unsigned* a = (const unsigned*)adj;
    unsigned long long* o = (unsigned long long*)out;
    const cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaSuccess;
    if (k == 3) {
      const long long n = c * 32 * ww * (long long)ww;
      const long long blocks = (n + kThreads * 16 - 1) / (kThreads * 16);
      popcount_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536), kThreads,
                        0, s>>>(a, n, o);
    } else {
      e = k == 4 ? launch_k<4>(a, c, ww, o, s) : launch_k<5>(a, c, ww, o, s);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
