// K6 kc_stack_count: k-cliques (k >= 5) rooted at a chunk, by a depth-first
// search of each (root, i, j) item over candidate bitsets.
//
// Replaces the counting half of gms_tpu/algorithms/k_clique.py:343
// kc_fused_chunk (its first half, build_local_adj, is K4). gms_tpu keeps a
// LIFO work stack of (S | root*256 + rem) rows in device memory, pops a
// bounded window each round, and compacts the pushes with a band sort; the
// window, the overflow flag with its split-and-retry and the resumable state
// exist for its platform. Here the same search tree is walked depth-first,
// which needs at most k-3 bitsets per item, so nothing can overflow:
//   root item (S0, rem k-1), kept iff |S0| >= k-1 (:390-392);
//   a child of (S, rem) along i ∈ S is (S & adj_i, rem-1);
//   a child needing r >= 3 is searched iff |S & adj_i| >= r (:490,499);
//   a child needing 2 is counted inline: Σ_{j∈cS} popcount(cS & adj_j)
//   (the rem==3 branch, :492-499, taken here at every W; gms_tpu's rem==4
//   matrix-unit branch for W <= 128 counts the same cliques).
//
// Design. Items are the search tree's nodes two levels below the root:
// (root b, i ∈ S0, j ∈ S1) with S1 = S0 & adj_i kept iff |S1| >= k-2, so a
// hub root's subtree spreads over as many warps as it has DAG triangles:
// with (root, i) items, a few deep subtrees, each walked by one warp, set
// whole chunks' times. Three launches:
//   count_kernel, one block per root: n_i = |S1| for each kept i, scanned
//     into per-root offsets; the root's total;
//   scan_kernel, one block: the roots' totals scanned into item offsets;
//   stack_kernel: persistent warps take item numbers from an atomic counter,
//     find (b, i, j) by binary search in the offsets, and search below
//     S2 = S1 & adj_j. A warp keeps its search path in shared memory: level
//     d holds the bitset that needs k-2-d more vertices and a cursor. Lanes
//     split the words of an AND and, at the inline count, the set bits of a
//     word (lane l takes bit l).
// adj rows are read from device memory through L1/L2 (a root's W x WW words
// reach 128 KB at W=1024, more than a block can hold for several roots).
//
// Bound on an H100: operations. The AND+popcount word operations of the
// pruned tree, |S|*WW per expanded item plus |cS|*WW per inline count (the
// plain version counts them as it expands), at the popcount rate of compute
// capability 9.0 (16 per clock per SM, CUDA C++ Programming Guide,
// arithmetic instructions table) x 132 SMs x the SM clock, against adj's
// bytes read once at 3.35 TB/s. The serial walk of a level's bits, the
// lanes idle on sparse words and the deepest items' subtrees are what this
// kernel spends beyond that.

#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ int popc_words(const unsigned* s, int ww) {
  int p = 0;
  for (int w = 0; w < ww; ++w) p += __popc(s[w]);
  return p;
}

// Exclusive scan of one value per thread over the block, tile after tile:
// returns this thread's offset within the running total *carry, which it
// advances by the tile's sum. Every thread of the block must call it.
template <typename T>
__device__ T block_scan(T n, T* carry) {
  __shared__ T warp_tot[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = n;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T y = lane < (int)(blockDim.x >> 5) ? warp_tot[lane] : T(0);
    for (int o = 1; o < 32; o <<= 1) {
      const T z = __shfl_up_sync(kFull, y, o);
      if (lane >= o) y += z;
    }
    warp_tot[lane] = y;  // inclusive over warps
  }
  __syncthreads();
  const T excl = *carry + (warp > 0 ? warp_tot[warp - 1] : T(0)) + x - n;
  __syncthreads();
  if (threadIdx.x == blockDim.x - 1) *carry = excl + n;
  __syncthreads();
  return excl;
}

// ioff[b*W + i] = first item of (b, i) within root b; roff[b] = root b's
// items (scan_kernel turns these into offsets).
__global__ void count_kernel(const unsigned* __restrict__ adj,
                             const unsigned* __restrict__ s0, int ww, int k,
                             int* __restrict__ ioff,
                             long long* __restrict__ roff) {
  __shared__ int carry;
  const int W = 32 * ww;
  const long long b = blockIdx.x;
  const unsigned* S0 = s0 + b * ww;
  const unsigned* A = adj + b * W * ww;
  const bool root_ok = popc_words(S0, ww) >= k - 1;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < W; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int n = 0;
    if (root_ok && i < W && ((S0[i >> 5] >> (i & 31)) & 1u)) {
      const unsigned* Ai = A + (long long)i * ww;
      for (int w = 0; w < ww; ++w) n += __popc(S0[w] & Ai[w]);
      if (n < k - 2) n = 0;
    }
    const int off = block_scan(n, &carry);
    if (i < W) ioff[b * W + i] = off;
  }
  if (threadIdx.x == 0) roff[b] = carry;
}

// roff[0..c) := exclusive offsets of the roots' items, roff[c] = items;
// *next = 0.
__global__ void scan_kernel(long long c, long long* roff,
                            unsigned long long* next) {
  __shared__ long long carry;
  if (threadIdx.x == 0) {
    carry = 0;
    *next = 0ull;
  }
  __syncthreads();
  for (long long base = 0; base < c; base += blockDim.x) {
    const long long b = base + threadIdx.x;
    const long long n = b < c ? roff[b] : 0;
    const long long off = block_scan(n, &carry);
    if (b < c) roff[b] = off;
  }
  if (threadIdx.x == 0) roff[c] = carry;
}

// First set bit >= pos among S's ww words, or 32*ww; warp-uniform.
__device__ __forceinline__ int next_bit(const unsigned* S, int ww, int pos,
                                        int lane) {
  for (int wb = pos >> 5; wb < ww; wb += 32) {
    const int w = wb + lane;
    unsigned x = w < ww ? S[w] : 0u;
    if (w == (pos >> 5)) x &= kFull << (pos & 31);
    const unsigned hit = __ballot_sync(kFull, x != 0u);
    if (hit) {
      const int f = __ffs(hit) - 1;
      const unsigned xf = __shfl_sync(kFull, x, f);
      return 32 * (wb + f) + __ffs(xf) - 1;
    }
  }
  return 32 * ww;
}

// The nth set bit of S (n < |S|); every lane computes it.
__device__ __forceinline__ int nth_bit(const unsigned* S, int ww, int n) {
  for (int w = 0; w < ww; ++w) {
    unsigned x = S[w];
    const int p = __popc(x);
    if (n < p) {
      for (; n > 0; --n) x &= x - 1;
      return 32 * w + __ffs(x) - 1;
    }
    n -= p;
  }
  return 32 * ww;
}

// This lane's share of Σ_{j∈c} popcount(c & A_j): lane l takes bit l of
// each word of c. c lies in shared memory, written before a __syncwarp.
__device__ __forceinline__ long long inline_count(const unsigned* c,
                                                  const unsigned* A, int ww,
                                                  int lane) {
  long long cnt = 0;
  for (int w = 0; w < ww; ++w) {
    const unsigned x = c[w];
    if (x == 0u || !((x >> lane) & 1u)) continue;
    const unsigned* Aj = A + (long long)(32 * w + lane) * ww;
    int s = 0;
    for (int v = 0; v < ww; ++v) s += __popc(c[v] & __ldg(Aj + v));
    cnt += s;
  }
  return cnt;
}

// dst = S & A_i over ww words (lanes split the words); returns |dst|.
__device__ __forceinline__ int and_row(unsigned* dst, const unsigned* S,
                                       const unsigned* Ai, int ww, int lane) {
  int pc = 0;
  for (int w = lane; w < ww; w += 32) {
    const unsigned x = S[w] & __ldg(Ai + w);
    dst[w] = x;
    pc += __popc(x);
  }
  __syncwarp();
  return __reduce_add_sync(kFull, pc);
}

__global__ void stack_kernel(const unsigned* __restrict__ adj,
                             const unsigned* __restrict__ s0, long long c,
                             int ww, int k, const int* __restrict__ ioff,
                             const long long* __restrict__ roff,
                             unsigned long long* next,
                             unsigned long long* out) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = 32 * ww;
  const int levels = k - 3;  // bitsets needing k-2, ..., 2 more vertices
  unsigned* stk = smem + (long long)warp * levels * ww;
  int* curs = reinterpret_cast<int*>(smem + (long long)kWarps * levels * ww) +
              warp * levels;
  const unsigned long long items = roff[c];
  long long cnt = 0;
  for (;;) {
    unsigned long long t = 0;
    if (lane == 0) t = atomicAdd(next, 1ull);
    t = __shfl_sync(kFull, t, 0);
    if (t >= items) break;
    long long lo = 0, hi = c;  // root: the last b with roff[b] <= t
    while (hi - lo > 1) {
      const long long mid = (lo + hi) >> 1;
      if ((unsigned long long)roff[mid] <= t) lo = mid; else hi = mid;
    }
    const long long b = lo;
    const int local = (int)(t - roff[b]);
    const int* io = ioff + b * W;
    int il = 0, ih = W;  // i: the last i with io[i] <= local
    while (ih - il > 1) {
      const int mid = (il + ih) >> 1;
      if (io[mid] <= local) il = mid; else ih = mid;
    }
    const int i = il;
    const unsigned* A = adj + b * W * ww;
    and_row(stk, s0 + b * ww, A + (long long)i * ww, ww, lane);
    const int j = nth_bit(stk, ww, local - io[i]);
    const int pc = and_row(stk + ww, stk, A + (long long)j * ww, ww, lane);
    if (levels == 2) {  // k == 5: S2 needs 2
      cnt += inline_count(stk + ww, A, ww, lane);
      __syncwarp();
      continue;
    }
    if (pc < k - 3) continue;
    if (lane == 0) curs[1] = 0;
    __syncwarp();
    int d = 1;
    while (d >= 1) {
      unsigned* S = stk + d * ww;
      const int v = next_bit(S, ww, curs[d], lane);
      __syncwarp();
      if (v >= W) {
        --d;
        continue;
      }
      if (lane == 0) curs[d] = v + 1;
      unsigned* child = S + ww;
      const int cp = and_row(child, S, A + (long long)v * ww, ww, lane);
      const int need = k - 3 - d;  // the child's
      if (need == 2) {
        cnt += inline_count(child, A, ww, lane);
      } else if (cp >= need) {
        ++d;
        if (lane == 0) curs[d] = 0;
      }
      __syncwarp();
    }
  }
  block_sum_add(cnt, out);
}

}  // namespace

// roff: int64[c + 2] (root offsets, then the item counter); ioff: int32[c*W].
extern "C" int kc_stack_count(const void* adj, const void* s0, long long c,
                              int ww, int k, void* roff, void* ioff,
                              void* out, void* stream) {
  if (k < 5) return (int)cudaErrorInvalidValue;
  if (c <= 0 || ww <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  long long* offsets = (long long*)roff;
  unsigned long long* next = (unsigned long long*)(offsets + c + 1);
  count_kernel<<<(unsigned)c, kThreads, 0, st>>>(
      (const unsigned*)adj, (const unsigned*)s0, ww, k, (int*)ioff, offsets);
  scan_kernel<<<1, kScanThreads, 0, st>>>(c, offsets, next);
  const int levels = k - 3;
  const size_t smem = (size_t)kWarps * levels * (ww + 1) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (long long)sms * kBlocksPerSm;
  if (blocks > c * 32 * ww) blocks = c * 32 * ww;
  stack_kernel<<<(unsigned)blocks, kThreads, smem, st>>>(
      (const unsigned*)adj, (const unsigned*)s0, c, ww, k, (const int*)ioff,
      offsets, next, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
