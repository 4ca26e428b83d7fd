// K12 star_stack: the k-clique-stars rooted at a chunk, counted or emitted,
// by a depth-first search over (S, I, R) bitsets in each root's local
// universe, its full neighbourhood (K11 builds it).
//
// Replaces gms_tpu/algorithms/k_clique_star.py:137 star_fused_chunk, less
// its first step, build_local_univ (K11). gms_tpu keeps a LIFO work stack
// of (S | I | R | root*256 + rem) rows in device memory, pops an adaptive
// window each round, compacts the pushes with a band sort and banks leaf
// rows in an output buffer; the window, the stack and output capacities
// with their overflow flag and split-and-retry, and the iter_budget
// segments exist for its platform. Here the same tree is walked
// depth-first, so nothing overflows. The tree, as gms_tpu's (:192-194,
// :273-314):
//   root b: the node (S0, I0, R = 0, rem = k-1), kept iff live0[b] and
//     |S0| >= k-1;
//   the child of (S, I, R, rem) along i in S is (S & adj_dag[i],
//     I & adj_full[i], R | {i}, rem-1);
//   a child of rem 0 is the k-clique {root} + R with star I & ~R; a child
//     of rem r >= 1 is searched iff |S| >= r.
// gms_tpu's count mode counts the leaves below a rem-2 node inline; they
// are the same leaves.
//
// Design. Items are the tree's nodes `depth` levels below the root: depth 1
// (b, i) for k <= 3 and depth 2 (b, i, j) for k >= 4, so that a hub root's
// leaves spread over as many warps as it has items (the lesson of K6). The
// items of k = 2 are leaves, those of k = 3 and k = 4 nodes of rem 1 (one
// and two levels down), and k >= 5 walks below its items. Three launches:
//   count_kernel, one block per root: the items of each i in S0 (1 at depth
//     1; at depth 2 |S0 & adj_dag[i]| if that is >= k-2, else 0), scanned
//     into per-root offsets; the root's total;
//   root_offsets_kernel (block_scan.cuh): the roots' totals scanned;
//   stack_kernel: persistent warps take item numbers from an atomic counter,
//     find (b, i[, j]) by binary search in the offsets, build the item's node
//     and walk its subtree depth-first. A warp keeps its path in shared
//     memory: one (S | I | R) node of 3*WW words and a cursor a level,
//     max(1, k-1-depth) levels. Lanes split the words of a child's ANDs.
//     The leaves of a rem-1 node are counted with lane l taking bit l of
//     each word of S: its star is WW words of I & adj_full[l] & ~R, less l.
// Emit mode runs the walk twice: the count pass's count sizes `out`
// exactly; in the emit pass the leaves of one word of S take consecutive
// rows of out by one atomic add, and each lane writes its row
// (R | star | b). The rows' order varies from run to run; their set does
// not.
//
// Bound on an H100: operations. Per child node 2*WW bitwise words (S and I)
// and WW popcounts (|S| for the prune), per leaf WW three-input bitwise
// words and WW popcounts (the star), and WW popcounts per live root (the
// plain version counts them): popcounts at 16 and bitwise operations at 64
// per clock per SM x 132 SMs x the SM clock, against the universe's bytes
// read once at 3.35 TB/s. W reaches 2048 at RMAT-12 (a leaf there costs
// WW = 64 words of one adj_full row, read through L1/L2, uncoalesced across
// the lanes), and a warp walks a node's set bits one after another.

#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "block_sum.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ int popc_words(const unsigned* s, int ww) {
  int p = 0;
  for (int w = 0; w < ww; ++w) p += __popc(s[w]);
  return p;
}

// ioff[b*W + i] = the first item of (b, i) within root b; roff[b] = root b's
// items (root_offsets_kernel turns these into offsets).
__global__ void count_kernel(const unsigned* __restrict__ adj_dag,
                             const unsigned* __restrict__ s0,
                             const unsigned char* __restrict__ live0, int ww,
                             int k, int depth, int* __restrict__ ioff,
                             long long* __restrict__ roff) {
  __shared__ int carry;
  const int W = 32 * ww;
  const long long b = blockIdx.x;
  const unsigned* S0 = s0 + b * ww;
  const unsigned* A = adj_dag + b * W * ww;
  const bool root_ok = live0[b] && popc_words(S0, ww) >= k - 1;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < W; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int n = 0;
    if (root_ok && i < W && ((S0[i >> 5] >> (i & 31)) & 1u)) {
      if (depth == 1) {
        n = 1;
      } else {
        const unsigned* Ai = A + (long long)i * ww;
        for (int w = 0; w < ww; ++w) n += __popc(S0[w] & Ai[w]);
        if (n < k - 2) n = 0;
      }
    }
    const int off = block_scan(n, &carry);
    if (i < W) ioff[b * W + i] = off;
  }
  if (threadIdx.x == 0) roff[b] = carry;
}

// dst = (S & Dv, I & Fv, R | {v}) from src = (S | I | R), WW words each;
// lanes split the words, and dst may be src. Returns |dst.S| (every lane).
__device__ __forceinline__ int child(unsigned* dst, const unsigned* src,
                                     const unsigned* Dv, const unsigned* Fv,
                                     int v, int ww, int lane) {
  int pc = 0;
  for (int w = lane; w < ww; w += 32) {
    const unsigned s = src[w] & __ldg(Dv + w);
    dst[w] = s;
    dst[ww + w] = src[ww + w] & __ldg(Fv + w);
    dst[2 * ww + w] = src[2 * ww + w] | (w == (v >> 5) ? 1u << (v & 31) : 0u);
    pc += __popc(s);
  }
  __syncwarp();
  return __reduce_add_sync(kFull, pc);
}

// Leaves of one root, counted per lane and, in the emit pass, written.
struct Leaves {
  const unsigned* F;  // the root's adj_full rows
  long long b;
  int ww, lane;
  unsigned long long* out_tail;
  unsigned* out_rows;
  unsigned long long out_cap;
  long long n, star;

  // The leaf of a rem-0 node N = (S | I | R): R with star I & ~R.
  __device__ __forceinline__ void one(const unsigned* N) {
    const unsigned *I = N + ww, *R = N + 2 * ww;
    int s = 0;
    for (int w = lane; w < ww; w += 32) s += __popc(I[w] & ~R[w]);
    s = __reduce_add_sync(kFull, s);
    if (lane == 0) {
      ++n;
      star += s;
    }
    if (!out_rows) return;
    unsigned long long pos = 0;
    if (lane == 0) pos = atomicAdd(out_tail, 1ull);
    pos = __shfl_sync(kFull, pos, 0);
    if (pos >= out_cap) return;
    unsigned* row = out_rows + pos * (2 * ww + 1);
    for (int w = lane; w < ww; w += 32) {
      row[w] = R[w];
      row[ww + w] = I[w] & ~R[w];
    }
    if (lane == 0) row[2 * ww] = (unsigned)b;
  }

  // The leaves of a rem-1 node N = (S | I | R), one per l in S: R | {l} with
  // star I & adj_full[l] & ~R, less l. Lane l takes bit l of each word.
  __device__ __forceinline__ void below(const unsigned* N) {
    const unsigned *S = N, *I = N + ww, *R = N + 2 * ww;
    const unsigned lbit = 1u << lane;
    for (int w = 0; w < ww; ++w) {
      const unsigned x = S[w];
      if (x == 0u) continue;
      unsigned long long base = 0;
      if (out_rows) {
        if (lane == 0) base = atomicAdd(out_tail, (unsigned long long)__popc(x));
        base = __shfl_sync(kFull, base, 0);
      }
      if (!(x & lbit)) continue;
      const unsigned* Fl = F + (long long)(32 * w + lane) * ww;
      unsigned* row = nullptr;  // this leaf's row of out, in the emit pass
      if (out_rows) {
        const unsigned long long pos = base + __popc(x & (lbit - 1u));
        if (pos < out_cap) row = out_rows + pos * (2 * ww + 1);
      }
      int s = 0;
      for (int v = 0; v < ww; ++v) {
        unsigned sw = I[v] & __ldg(Fl + v) & ~R[v];
        if (v == w) sw &= ~lbit;
        s += __popc(sw);
        if (row) {
          row[v] = R[v] | (v == w ? lbit : 0u);
          row[ww + v] = sw;
        }
      }
      ++n;
      star += s;
      if (row) row[2 * ww] = (unsigned)b;
    }
  }
};

__global__ void __launch_bounds__(kThreads)
stack_kernel(const unsigned* __restrict__ adj_full,
             const unsigned* __restrict__ adj_dag,
             const unsigned* __restrict__ s0, const unsigned* __restrict__ i0,
             long long c, int ww, int k, int depth,
             const int* __restrict__ ioff, const long long* __restrict__ roff,
             unsigned long long* next, unsigned long long* out_tail,
             unsigned* out_rows, unsigned long long out_cap,
             unsigned long long* totals) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = 32 * ww;
  const int node = 3 * ww;
  const int rem0 = k - 1 - depth;  // the items' rem
  const int levels = rem0 > 1 ? rem0 : 1;
  unsigned* path = smem + (long long)warp * levels * node;
  int* curs = reinterpret_cast<int*>(smem + (long long)kWarps * levels * node) +
              warp * levels;
  const unsigned long long items = roff[c];
  Leaves lv{nullptr, 0, ww, lane, out_tail, out_rows, out_cap, 0, 0};
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
    const unsigned* F = adj_full + b * W * ww;
    const unsigned* D = adj_dag + b * W * ww;
    // the root's node (S0 | I0 | 0), then its child along i [and j]
    for (int w = lane; w < ww; w += 32) {
      path[w] = s0[b * ww + w];
      path[ww + w] = i0[b * ww + w];
      path[2 * ww + w] = 0u;
    }
    __syncwarp();
    int pc = child(path, path, D + (long long)i * ww, F + (long long)i * ww, i,
                   ww, lane);
    if (depth == 2) {
      const int j = nth_bit(path, ww, local - io[i]);
      __syncwarp();
      pc = child(path, path, D + (long long)j * ww, F + (long long)j * ww, j,
                 ww, lane);
    }
    lv.F = F;
    lv.b = b;
    if (rem0 == 0) {
      lv.one(path);
    } else if (pc < rem0) {
      // pruned: fewer candidates than members still needed
    } else if (rem0 == 1) {
      lv.below(path);
    } else {
      if (lane == 0) curs[0] = 0;
      __syncwarp();
      int d = 0;
      while (d >= 0) {
        unsigned* L = path + d * node;
        const int v = next_bit(L, ww, curs[d], lane);
        __syncwarp();
        if (v >= W) {
          --d;
          continue;
        }
        if (lane == 0) curs[d] = v + 1;
        unsigned* ch = L + node;
        const int cp = child(ch, L, D + (long long)v * ww,
                             F + (long long)v * ww, v, ww, lane);
        const int crem = rem0 - d - 1;  // the child's
        if (crem == 1) {
          lv.below(ch);
        } else if (cp >= crem) {
          ++d;
          if (lane == 0) curs[d] = 0;
        }
        __syncwarp();
      }
    }
    __syncwarp();
  }
  block_sum_add(lv.n, totals);
  __syncthreads();
  block_sum_add(lv.star, totals + 1);
}

}  // namespace

// roff: int64[c + 2] (root offsets, then the item counter); ioff: int32[c*W];
// out_tail: int64[1] zeros; totals: int64[2] zeros (cliques, star total).
// Count pass: out_rows null. Emit pass: out_rows int32[out_cap, 2*ww + 1],
// out_cap the count pass's count. The grid is the blocks that can be
// resident at once.
extern "C" int star_stack(const void* adj_full, const void* adj_dag,
                          const void* s0, const void* i0, const void* live0,
                          long long c, int ww, int k, void* roff, void* ioff,
                          void* out_tail, void* out_rows, long long out_cap,
                          void* totals, void* stream) {
  if (k < 2) return (int)cudaErrorInvalidValue;
  if (c <= 0 || ww <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int depth = k <= 3 ? 1 : 2;
  long long* offsets = (long long*)roff;
  unsigned long long* next = (unsigned long long*)(offsets + c + 1);
  count_kernel<<<(unsigned)c, kThreads, 0, st>>>(
      (const unsigned*)adj_dag, (const unsigned*)s0,
      (const unsigned char*)live0, ww, k, depth, (int*)ioff, offsets);
  root_offsets_kernel<<<1, kScanThreads, 0, st>>>(c, offsets, next);
  const int rem0 = k - 1 - depth;
  const int levels = rem0 > 1 ? rem0 : 1;
  const size_t smem = (size_t)kWarps * levels * (3 * ww + 1) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stack_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  stack_kernel<<<(unsigned)blocks, kThreads, smem, st>>>(
      (const unsigned*)adj_full, (const unsigned*)adj_dag,
      (const unsigned*)s0, (const unsigned*)i0, c, ww, k, depth,
      (const int*)ioff, offsets, next, (unsigned long long*)out_tail,
      (unsigned*)out_rows, (unsigned long long)out_cap,
      (unsigned long long*)totals);
  return (int)cudaGetLastError();
}
