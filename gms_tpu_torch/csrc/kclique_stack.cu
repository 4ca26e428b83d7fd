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
// Items are the search tree's nodes two levels below the root: (root b,
// i ∈ S0, j ∈ S1) with S1 = S0 & adj_i kept iff |S1| >= k-2, so a hub
// root's subtree spreads over as many warps as it has DAG triangles. Three
// launches:
//   count_kernel, one block per root: n_i = |S1| for each kept i, scanned
//     into per-root offsets; the root's total;
//   root_offsets_kernel (block_scan.cuh), one block: the roots' totals
//     scanned into item offsets;
//   the walk: persistent warps take item numbers from an atomic counter,
//     find (b, i, j) by binary search in the offsets, and search below
//     S2 = S1 & adj_j.
//
// What held the walk back at W <= 128, where every main-path chunk lies
// (RMAT-13 k=6: W = 32, 32, 32, 64, 128; RMAT-12 k=8: 32, 32, 64, 128): the
// path and its cursors sat in shared memory with a __syncwarp a step; an
// AND of ww <= 4 words gave one to four of the 32 lanes work; the set bits
// were walked one at a time; the inline count gave lane l bit l of each
// word and read each of its rows from device memory in a loop. The walk at
// W <= 128 and 5 <= k <= 9 is now the register walk of reg_rows.cuh (ww
// and k template arguments; K9's and K36's walk in bk_walk.cuh holds its
// rows the same way):
//   * lane l holds rows l, l+32, l+64, l+96 of the root's adj, ww words each
//     (at most 16 registers), loaded once per root a warp takes;
//   * the path's bitsets and their unwalked bits are warp-uniform registers,
//     one template instance a search level; the next bit comes from __ffs,
//     with no shared memory and no __syncwarp;
//   * a child is S & row v, by ww __shfl_sync from lane v & 31;
//   * the inline count is one lane-parallel step: each lane adds
//     popc(c & A_j) over its own rows j ∈ c (the lanes' shares are summed
//     once, at the end, by block_sum.cuh).
// A level needing 3 taken lane-parallel as a whole (each lane walking the
// children of its own rows, each A_j by ww * ww shuffles) measured slower on
// an H100 on every main-path chunk of width 64 or more, and was dropped
// (PERF.md, row 10c).
// Wider universes (ww > 4, or k > 9) keep the memory walk: the path in
// shared memory, lanes splitting the words of an AND and, at the inline
// count, the set bits of a word (lane l takes bit l); rows come from device
// memory through L1/L2 (a root's W x WW words reach 128 KB at W=1024, more
// than a block can hold for several roots).
//
// Bound on an H100: operations. The AND+popcount word operations of the
// pruned tree, |S|*WW per expanded item plus |cS|*WW per inline count (the
// plain version counts them as it expands), at the popcount rate of compute
// capability 9.0 (16 per clock per SM, CUDA C++ Programming Guide,
// arithmetic instructions table) x 132 SMs x the SM clock, against adj's
// bytes read once at 3.35 TB/s. The register walk spends a step's row
// shuffles and its loop on top of those operations.

#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "block_sum.cuh"
#include "reg_rows.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kBlocksPerSm = 8;  // the memory walk's grid
// the register walk: the blocks an SM its registers must allow (ptxas: no
// spills at 2; the grid takes what the occupancy of each instance allows)
constexpr int kRegBlocksPerSm = 2;

__device__ __forceinline__ int popc_words(const unsigned* s, int ww) {
  int p = 0;
  for (int w = 0; w < ww; ++w) p += __popc(s[w]);
  return p;
}

// ioff[b*W + i] = first item of (b, i) within root b; roff[b] = root b's
// items (root_offsets_kernel turns these into offsets).
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
    const long long b = item_root(roff, c, t);
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

// ---------------------------------------------------------------------------
// the register walk, W = 32*WW <= 128, 5 <= k <= 9
// ---------------------------------------------------------------------------

// This lane's share of Σ_{j∈c} popcount(c & A_j): its own rows j ∈ c.
template <int WW>
__device__ __forceinline__ int reg_edges(const RegRows<WW>& rows,
                                         const unsigned (&c)[WW], int lane) {
  int s = 0;
#pragma unroll
  for (int k = 0; k < WW; ++k) {
    if ((c[k] >> lane) & 1u) {
#pragma unroll
      for (int x = 0; x < WW; ++x) s += __popc(c[x] & rows.r[k][x]);
    }
  }
  return s;
}

// This lane's share of the cliques below S, which needs NEED >= 3 more
// vertices: each v ∈ S in ascending order forms c = S & A_v; a c needing 2
// is counted inline, one needing r >= 3 searched iff |c| >= r. Each level's
// unwalked bits are registers of its template instance.
template <int WW, int NEED>
__device__ __forceinline__ long long reg_walk(const RegRows<WW>& rows,
                                              const unsigned (&S)[WW],
                                              int lane) {
  long long share = 0;
  unsigned rest[WW];
#pragma unroll
  for (int x = 0; x < WW; ++x) rest[x] = S[x];
  for (int v = first_bit(rest); v >= 0; v = first_bit(rest)) {
    clear_bit(rest, v);
    unsigned c[WW];
    rows.row(v, c);
#pragma unroll
    for (int x = 0; x < WW; ++x) c[x] &= S[x];
    if constexpr (NEED == 3) {
      share += reg_edges(rows, c, lane);
    } else {
      if (popc_bits(c) >= NEED - 1)
        share += reg_walk<WW, NEED - 1>(rows, c, lane);
    }
  }
  return share;
}

template <int WW, int K>
__global__ void __launch_bounds__(kThreads, kRegBlocksPerSm)
    stack_reg_kernel(const unsigned* __restrict__ adj,
                     const unsigned* __restrict__ s0, long long c,
                     const int* __restrict__ ioff,
                     const long long* __restrict__ roff,
                     unsigned long long* next, unsigned long long* out) {
  constexpr int W = 32 * WW;
  const int lane = threadIdx.x & 31;
  const unsigned long long items = roff[c];
  RegRows<WW> rows;
  long long held = -1;
  long long cnt = 0;
  for (;;) {
    unsigned long long t = 0;
    if (lane == 0) t = atomicAdd(next, 1ull);
    t = __shfl_sync(kFull, t, 0);
    if (t >= items) break;
    const long long b = item_root(roff, c, t);
    const int local = (int)(t - roff[b]);
    const int* io = ioff + b * W;
    int il = 0, ih = W;  // i: the last i with io[i] <= local
    while (ih - il > 1) {
      const int mid = (il + ih) >> 1;
      if (io[mid] <= local) il = mid; else ih = mid;
    }
    if (b != held) {
      rows.load(adj + b * W * WW, lane);
      held = b;
    }
    unsigned S[WW], r[WW];
    rows.row(il, r);
#pragma unroll
    for (int x = 0; x < WW; ++x) S[x] = __ldg(s0 + b * WW + x) & r[x];
    rows.row(reg_nth_bit(S, local - io[il]), r);
#pragma unroll
    for (int x = 0; x < WW; ++x) S[x] &= r[x];
    if constexpr (K == 5) {  // S2 needs 2
      cnt += reg_edges(rows, S, lane);
    } else {
      if (popc_bits(S) >= K - 3) cnt += reg_walk<WW, K - 3>(rows, S, lane);
    }
  }
  block_sum_add(cnt, out);
}

struct RegLaunch {
  const unsigned* adj;
  const unsigned* s0;
  long long c;
  const int* ioff;
  const long long* roff;
  unsigned long long* next;
  unsigned long long* out;
  int sms;
  cudaStream_t st;
};

template <int WW, int K>
cudaError_t launch_reg(const RegLaunch& a) {
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stack_reg_kernel<WW, K>, kThreads, 0);
  if (e != cudaSuccess) return e;
  long long blocks = (long long)a.sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > a.c * 32 * WW) blocks = a.c * 32 * WW;
  stack_reg_kernel<WW, K><<<(unsigned)blocks, kThreads, 0, a.st>>>(
      a.adj, a.s0, a.c, a.ioff, a.roff, a.next, a.out);
  return cudaSuccess;
}

template <int WW>
cudaError_t launch_reg_k(int k, const RegLaunch& a) {
  switch (k) {
    case 5: return launch_reg<WW, 5>(a);
    case 6: return launch_reg<WW, 6>(a);
    case 7: return launch_reg<WW, 7>(a);
    case 8: return launch_reg<WW, 8>(a);
    default: return launch_reg<WW, 9>(a);
  }
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
  root_offsets_kernel<<<1, kScanThreads, 0, st>>>(c, offsets, next);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ww <= 4 && k <= 9) {
    const RegLaunch a{(const unsigned*)adj, (const unsigned*)s0, c,
                      (const int*)ioff, offsets, next,
                      (unsigned long long*)out, sms, st};
    cudaError_t e;
    switch (ww) {
      case 1: e = launch_reg_k<1>(k, a); break;
      case 2: e = launch_reg_k<2>(k, a); break;
      case 3: e = launch_reg_k<3>(k, a); break;
      default: e = launch_reg_k<4>(k, a); break;
    }
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  const int levels = k - 3;
  const size_t smem = (size_t)kWarps * levels * (ww + 1) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = (long long)sms * kBlocksPerSm;
  if (blocks > c * 32 * ww) blocks = c * 32 * ww;
  stack_kernel<<<(unsigned)blocks, kThreads, smem, st>>>(
      (const unsigned*)adj, (const unsigned*)s0, c, ww, k, (const int*)ioff,
      offsets, next, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
