// K36 bk_direct_stack: the maximal cliques rooted at a chunk, counted by a
// Tomita-pivot search over (cand, fini) bitsets in each root's FULL
// neighbourhood: the direct=True variant of Bron–Kerbosch.
//
// Replaces the search of gms_tpu/algorithms/bron_kerbosch.py:131
// bk_count_chunk (after build_local_adj, K4, and init_items, K35). gms_tpu
// keeps a LIFO work stack of (cand | fini | root) rows in device memory,
// pops a batch each round, forms every child of the batch in one [B, W, WW]
// tensor and compacts the ones with work left; its stack capacity, the
// overflow flag with split-and-retry and the iter_budget rounds exist for
// its platform. Here the same tree is walked depth-first, one node per
// level of a warp's path. The tree, as gms_tpu's (:160-239):
//   root b (live): cand = cand0[b], fini = fini0[b]; a live root with
//     cand0 = fini0 = 0 is a maximal clique ({root}, an isolated vertex);
//   a node's pivot is the first u of cand | fini, in slot order, with the
//     largest popcount(cand & adj_u); ext = cand & ~adj_pivot;
//   the child along i in ext, with e< = ext & below(i), is
//     cand' = (cand & ~e<) & adj_i, fini' = (fini | e<) & adj_i;
//   it is searched iff cand' != 0, and counted iff cand' = fini' = 0.
// Walking children in ascending i while moving each i from cand to fini
// gives the same cand' and fini' as the e< masks.
//
// Design: K9's (bk_stack.cu), without R and the leaf filter. Four launches:
//   root_kernel, one block per root: the root's pivot and ext_b; its items,
//     the root's children (b, i in ext_b), or one leaf item for a live root
//     with cand0 = fini0 = 0;
//   root_offsets_kernel (block_scan.cuh): the roots' items scanned;
//   init_kernel: the count of unfinished items, the warps of the grid;
//   stack_kernel, as many blocks as can be resident at once: each warp takes
//     tickets from an atomic counter. A ticket below the root items is (b,
//     i), found by binary search in the offsets; a later ticket is a slot of
//     a queue of nodes (cand, fini, b) in device memory, which the warp waits
//     for until it is filled or no item is left unfinished. A warp walks its
//     node's subtree depth-first; level d of its path holds cand, fini and
//     the pivot, 2*ww + 1 words. Every 16 steps it looks whether tickets wait
//     for queue slots and, if so, donates the unexplored children of its
//     shallowest open level to the queue. One root's subtree can hold most
//     of a chunk's work (RMAT-14: 35 roots hold 122 M of the 165 M maximal
//     cliques), and the donations spread it.
// The path has `depth` levels, which the caller sizes from the core bound:
// the node at level d has |R| = d + 1 higher-ranked neighbours of the root
// in R, so d < max out-degree of the orientation. A child that would need
// level `depth` sets the overflow word and abandons its item: the count is
// then short and the caller retries with a deeper path. A depth of
// min(W, core bound) + 2 never overflows. The path lies in shared memory
// where the block's paths fit 100 KB, else in device memory taken from the
// stream's pool for the launch. Lanes split the words of the ANDs and the
// set bits of cand | fini for the pivot (first index on ties: a 64-bit max
// of (score + 1, ~u)).
//
// Bound on an H100: operations. The tree's AND+popcount word operations,
// |cand | fini| * WW per expanded node for the pivot, and its 32-bit
// bitwise operations, the pivot's ANDs and 2 * WW per child (the plain
// version counts them), at 16 popcounts and 64 bitwise results per clock
// per SM (compute capability 9.0) x 132 SMs x the SM clock. fini makes the
// pivot rows wider than K9's DAG universe; idle lanes on narrow words, the
// serial walk of a node's children and each step's dependent loads are what
// this kernel spends beyond the bound.

#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "block_sum.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
// DFS steps between a warp's looks at whether other warps wait for work
constexpr int kDonateEvery = 16;
// A block's paths lie in shared memory up to this size, else in device
// memory, at most kPathScratch bytes for the grid.
constexpr size_t kSmemPaths = 100 * 1024;
constexpr size_t kPathScratch = size_t(1) << 30;

// (score + 1, ~u): the larger key has the larger score, then the smaller u.
__device__ __forceinline__ unsigned long long pivot_key(int score, int u) {
  return ((unsigned long long)(score + 1) << 32) | (kFull - (unsigned)u);
}

__device__ __forceinline__ int key_vertex(unsigned long long key) {
  return (int)(kFull - (unsigned)(key & kFull));
}

// Bits below i within word w.
__device__ __forceinline__ unsigned below_word(int i, int w) {
  const int iw = i >> 5;
  return w < iw ? kFull : (w == iw ? (1u << (i & 31)) - 1u : 0u);
}

// Per root: the pivot of (cand0, fini0) and ext_b = cand0 & ~adj_pivot into
// rext; roff[b] = the root's items (|ext_b|, 1 for a live root with cand0 =
// fini0 = 0, 0 for a dead root).
__global__ void root_kernel(const unsigned* __restrict__ adj,
                            const unsigned* __restrict__ cand0,
                            const unsigned* __restrict__ fini0,
                            const unsigned char* __restrict__ live0, int ww,
                            unsigned* __restrict__ rext,
                            long long* __restrict__ roff) {
  __shared__ unsigned long long best;
  const int W = 32 * ww;
  const long long b = blockIdx.x;
  const unsigned* C0 = cand0 + b * ww;
  const unsigned* F0 = fini0 + b * ww;
  const unsigned* A = adj + b * W * ww;
  const bool live = live0[b] != 0;
  if (threadIdx.x == 0) best = 0ull;
  __syncthreads();
  if (live) {
    for (int u = threadIdx.x; u < W; u += blockDim.x) {
      if (!(((C0[u >> 5] | F0[u >> 5]) >> (u & 31)) & 1u)) continue;
      const unsigned* Au = A + (long long)u * ww;
      int s = 0;
      for (int w = 0; w < ww; ++w) s += __popc(C0[w] & Au[w]);
      atomicMax(&best, pivot_key(s, u));
    }
  }
  __syncthreads();
  const unsigned long long key = best;
  const unsigned* Ap = A + (long long)(key ? key_vertex(key) : 0) * ww;
  for (int w = threadIdx.x; w < ww; w += blockDim.x)
    rext[b * ww + w] = key ? C0[w] & ~Ap[w] : 0u;
  if (threadIdx.x == 0) {
    long long n = 0;
    if (live && !key) n = 1;
    if (key)
      for (int w = 0; w < ww; ++w) n += __popc(C0[w] & ~Ap[w]);
    roff[b] = n;
  }
}

// First set bit >= pos of X & ~Y, or 32*ww; warp-uniform.
__device__ __forceinline__ int first_andnot(const unsigned* X,
                                            const unsigned* Y, int ww,
                                            int lane, int pos = 0) {
  const int pw = pos >> 5;
  for (int wb = pw & ~31; wb < ww; wb += 32) {
    const int w = wb + lane;
    unsigned x = w < ww && w >= pw ? X[w] & ~__ldg(Y + w) : 0u;
    if (w == pw) x &= kFull << (pos & 31);
    const unsigned hit = __ballot_sync(kFull, x != 0u);
    if (hit) {
      const int f = __ffs(hit) - 1;
      const unsigned xf = __shfl_sync(kFull, x, f);
      return 32 * (wb + f) + __ffs(xf) - 1;
    }
  }
  return 32 * ww;
}

// Whether all ww words of S are 0; warp-uniform.
__device__ __forceinline__ bool all_zero(const unsigned* S, int ww, int lane) {
  for (int wb = 0; wb < ww; wb += 32) {
    const int w = wb + lane;
    if (__any_sync(kFull, w < ww && S[w] != 0u)) return false;
  }
  return true;
}

// node = (cand[ww] | fini[ww] | pivot): stores the pivot. cand | fini is
// not empty.
__device__ __forceinline__ void set_pivot(unsigned* node, const unsigned* A,
                                          int ww, int lane) {
  unsigned long long best = 0ull;
  for (int w = 0; w < ww; ++w) {
    if (!(((node[w] | node[ww + w]) >> lane) & 1u)) continue;
    const int u = 32 * w + lane;
    const unsigned* Au = A + (long long)u * ww;
    int s = 0;
    for (int x = 0; x < ww; ++x) s += __popc(node[x] & __ldg(Au + x));
    const unsigned long long k = pivot_key(s, u);
    if (k > best) best = k;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_xor_sync(kFull, best, o);
    if (other > best) best = other;
  }
  __syncwarp();
  if (lane == 0) node[2 * ww] = (unsigned)key_vertex(best);
  __syncwarp();
}

// Work shared by a chunk's warps (int64[64], zeroed by the caller): tickets
// taken, queue slots reserved, items not yet finished (the root items and
// every queued node); then, on the fourth line, the overflow word, the
// items taken, the most items one warp took and the warps of the grid. Each
// of the first three words has a 128-byte line of its own, so that the
// waiting warps' polls of `pending` do not queue behind the atomics.
struct Ctl {
  alignas(128) unsigned long long head;
  alignas(128) unsigned long long tail;
  alignas(128) unsigned long long pending;
  alignas(128) unsigned long long overflow;
  unsigned long long items;
  unsigned long long max_items;
  unsigned long long warps;
};

__global__ void init_kernel(const long long* roff, long long c, Ctl* ctl,
                            long long warps) {
  ctl->pending = (unsigned long long)roff[c];
  ctl->warps = (unsigned long long)warps;
}

__device__ __forceinline__ void load_node(unsigned* dst, const unsigned* src,
                                          int words, int lane) {
  for (int w = lane; w < words; w += 32) dst[w] = __ldcg(src + w);
  __syncwarp();
}

struct Search {
  const unsigned* A;  // the root's adj rows
  long long b;
  int ww, lane, depth;
  Ctl* ctl;
  long long k;  // maximal cliques counted, warp-uniform
  bool full;    // the queue had no room: donate no more

  // The child of node L along v, with the children before it already moved
  // from cand to fini (done = those bits), into dst (cand' | fini');
  // returns 2 if cand' != 0, 1 if it is a maximal clique, 0 if it is dead.
  __device__ __forceinline__ int child(unsigned* dst, const unsigned* L,
                                       const unsigned* done, int v) {
    const unsigned* Av = A + (long long)v * ww;
    unsigned nc = 0u, nf = 0u;
    for (int w = lane; w < ww; w += 32) {
      const unsigned av = __ldg(Av + w);
      const unsigned dn = done ? done[w] : 0u;
      const unsigned cw = (L[w] & ~dn) & av, fw = (L[ww + w] | dn) & av;
      dst[w] = cw;
      dst[ww + w] = fw;
      nc |= cw;
      nf |= fw;
    }
    __syncwarp();
    if (__any_sync(kFull, nc != 0u)) return 2;
    return __any_sync(kFull, nf != 0u) ? 0 : 1;
  }
};

// Moves the unexplored children of the shallowest path level that has any
// to the queue, if warps wait for work and the queue has room; counts those
// that are maximal cliques. path[0..d] is the warp's path, tmp a free node.
__device__ void donate(Search& s, unsigned* path, int d, int stride,
                       unsigned* tmp, unsigned* done, unsigned* queue,
                       int* ready, unsigned long long cap,
                       unsigned long long n_root) {
  const int ww = s.ww, lane = s.lane, W = 32 * ww;
  if (s.full) return;
  int hungry = 0;
  if (lane == 0) {
    const volatile Ctl* v = s.ctl;
    hungry = v->head > n_root + v->tail;
  }
  if (!__shfl_sync(kFull, hungry, 0)) return;
  for (int e = 0; e <= d; ++e) {
    unsigned* L = path + e * stride;
    const unsigned* Ap = s.A + (long long)L[2 * ww] * ww;
    if (first_andnot(L, Ap, ww, lane) >= W) continue;
    // count the children with candidates left
    int n = 0;
    for (int v = first_andnot(L, Ap, ww, lane); v < W;) {
      for (int w = lane; w < ww; w += 32)
        done[w] = L[w] & ~__ldg(Ap + w) & below_word(v, w);
      __syncwarp();
      n += s.child(tmp, L, done, v) == 2;
      v = first_andnot(L, Ap, ww, lane, v + 1);
    }
    unsigned long long base = 0;
    int ok = 1;
    if (n > 0 && lane == 0) {
      unsigned long long cur = *(volatile unsigned long long*)&s.ctl->tail;
      for (;;) {
        if (cur + n > cap) {
          ok = 0;
          break;
        }
        const unsigned long long prev = atomicCAS(&s.ctl->tail, cur, cur + n);
        if (prev == cur) break;
        cur = prev;
      }
      base = cur;
      if (ok) atomicAdd(&s.ctl->pending, (unsigned long long)n);
    }
    if (!__shfl_sync(kFull, ok, 0)) {  // no room: keep the work
      s.full = true;
      return;
    }
    base = __shfl_sync(kFull, base, 0);
    // move them: queue the children with candidates, count the leaves
    int q = 0;
    for (int v = first_andnot(L, Ap, ww, lane); v < W;) {
      for (int w = lane; w < ww; w += 32)
        done[w] = L[w] & ~__ldg(Ap + w) & below_word(v, w);
      __syncwarp();
      const int kind = s.child(tmp, L, done, v);
      if (kind == 2) {
        unsigned* dst = queue + (base + q++) * stride;
        for (int w = lane; w < 2 * ww; w += 32) __stcg(dst + w, tmp[w]);
        if (lane == 0) __stcg(dst + 2 * ww, (unsigned)s.b);
      } else if (kind == 1) {
        ++s.k;
      }
      v = first_andnot(L, Ap, ww, lane, v + 1);
    }
    __threadfence();
    __syncwarp();
    if (lane == 0)
      for (int i = 0; i < n; ++i)
        *(volatile int*)(ready + base + i) = 1;
    // the level has no children left
    for (int w = lane; w < ww; w += 32) L[w] &= __ldg(Ap + w);
    __syncwarp();
    return;
  }
}

// Walks the subtree below path[0] (a node with its pivot set) depth-first.
__device__ void walk(Search& s, unsigned* path, int stride, unsigned* tmp,
                     unsigned* done, unsigned* queue, int* ready,
                     unsigned long long cap, unsigned long long n_root) {
  const int ww = s.ww, lane = s.lane, W = 32 * ww;
  int d = 0, since = 0;
  while (d >= 0) {
    unsigned* L = path + d * stride;
    const int v = first_andnot(L, s.A + (long long)L[2 * ww] * ww, ww, lane);
    __syncwarp();
    if (v >= W) {
      --d;
      continue;
    }
    // level d + 1 may be the spare node tmp when d + 1 == depth; the child
    // is only read there if it is searched, which overflows first
    unsigned* nxt = L + stride;
    const int kind = s.child(nxt, L, nullptr, v);
    if (kind == 2 && d + 1 >= s.depth) {  // no level left: abandon the item
      if (lane == 0) atomicExch(&s.ctl->overflow, 1ull);
      return;
    }
    for (int w = lane; w < ww; w += 32) {  // v moves from cand to fini
      if (w == (v >> 5)) {
        L[w] &= ~(1u << (v & 31));
        L[ww + w] |= 1u << (v & 31);
      }
    }
    __syncwarp();
    if (kind == 2) {
      set_pivot(nxt, s.A, ww, lane);
      ++d;
    } else if (kind == 1) {
      ++s.k;
    }
    if (++since == kDonateEvery) {
      since = 0;
      donate(s, path, d, stride, tmp, done, queue, ready, cap, n_root);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3)
stack_kernel(const unsigned* __restrict__ adj,
             const unsigned* __restrict__ cand0,
             const unsigned* __restrict__ fini0,
             const unsigned* __restrict__ rext, long long c, int ww,
             int depth, const long long* __restrict__ roff, Ctl* ctl,
             unsigned* queue, int* ready, unsigned long long cap,
             unsigned* gpath, unsigned long long* total) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = 32 * ww;
  const int stride = 2 * ww + 1;
  // depth path levels, a spare node and a word buffer
  const long long path_words = (long long)(depth + 1) * stride + ww;
  unsigned* path =
      gpath ? gpath + ((long long)blockIdx.x * kWarps + warp) * path_words
            : smem + warp * path_words;
  unsigned* tmp = path + (long long)depth * stride;
  unsigned* done = tmp + stride;
  const unsigned long long n_root = roff[c];
  Search s;
  s.ww = ww;
  s.lane = lane;
  s.depth = depth;
  s.ctl = ctl;
  s.k = 0;
  s.full = false;
  unsigned long long taken = 0;
  for (;;) {
    unsigned long long t = 0;
    if (lane == 0) t = atomicAdd(&ctl->head, 1ull);
    t = __shfl_sync(kFull, t, 0);
    unsigned* L0 = path;
    bool search = false;
    if (t < n_root) {  // item (b, i) of the root offsets
      const long long b = item_root(roff, c, t);
      s.b = b;
      s.A = adj + b * W * ww;
      const unsigned* C0 = cand0 + b * ww;
      const unsigned* F0 = fini0 + b * ww;
      if (all_zero(C0, ww, lane)) {
        ++s.k;  // a live root with cand0 = fini0 = 0
      } else {
        // the root node (cand0, fini0) in tmp, its child along the i-th
        // ext bit
        const unsigned* E = rext + b * ww;
        const int i = nth_bit(E, ww, (int)(t - roff[b]));
        for (int w = lane; w < ww; w += 32) {
          tmp[w] = C0[w];
          tmp[ww + w] = F0[w];
          done[w] = E[w] & below_word(i, w);
        }
        __syncwarp();
        const int kind = s.child(L0, tmp, done, i);
        search = kind == 2;
        if (kind == 1) ++s.k;
      }
    } else {  // a queued node
      const unsigned long long slot = t - n_root;
      int ok = 0;
      if (lane == 0 && slot < cap) {
        const volatile int* flag = ready + slot;
        const volatile Ctl* v = ctl;
        for (unsigned ns = 64;; ns = ns < 4096 ? 2 * ns : ns) {
          if (*flag) {
            ok = 1;
            break;
          }
          if (v->pending == 0ull) break;
          __nanosleep(ns);
        }
      }
      if (!__shfl_sync(kFull, ok, 0)) break;  // no work will come
      __threadfence();
      load_node(L0, queue + slot * stride, stride, lane);
      const long long b = L0[2 * ww];
      s.b = b;
      s.A = adj + b * W * ww;
      search = true;
    }
    if (search) {
      set_pivot(L0, s.A, ww, lane);
      walk(s, path, stride, tmp, done, queue, ready, cap, n_root);
    }
    ++taken;
    __threadfence();
    if (lane == 0) atomicAdd(&ctl->pending, ~0ull);  // this item is done
    __syncwarp();
  }
  if (lane == 0) {
    atomicAdd(&ctl->items, taken);
    atomicMax(&ctl->max_items, taken);
  }
  block_sum_add(lane == 0 ? s.k : 0, total);
}

}  // namespace

// adj: int32[c, 32*ww, ww] (the undirected local adjacency, K4); cand0,
// fini0: int32[c, ww] (K35); live0: bool[c]; depth >= 1 path levels; roff:
// int64[c + 2]; rext: int32[c * ww]; ctl: int64[64] zeros; queue:
// int32[cap * (2*ww + 1)]; ready: int32[cap] zeros; total: int64, added to.
// The grid is the blocks that can be resident at once; where a block's
// paths do not fit kSmemPaths they lie in device memory taken from the
// stream's pool for this launch.
extern "C" int bk_direct_stack(const void* adj, const void* cand0,
                               const void* fini0, const void* live0,
                               long long c, int ww, int depth, void* roff,
                               void* rext, void* ctl, void* queue, void* ready,
                               long long cap, void* total, void* stream) {
  if (c <= 0 || ww <= 0 || depth <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  long long* offsets = (long long*)roff;
  root_kernel<<<(unsigned)c, kThreads, 0, st>>>(
      (const unsigned*)adj, (const unsigned*)cand0, (const unsigned*)fini0,
      (const unsigned char*)live0, ww, (unsigned*)rext, offsets);
  root_offsets_kernel<<<1, kScanThreads, 0, st>>>(
      c, offsets, (unsigned long long*)(offsets + c + 1));
  const size_t block_path_bytes =
      (size_t)kWarps * ((size_t)(depth + 1) * (2 * ww + 1) + ww) *
      sizeof(unsigned);
  const bool in_smem = block_path_bytes <= kSmemPaths;
  const size_t smem = in_smem ? block_path_bytes : 0;
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
  // every block resident at once: waiting warps never hold back a block
  // that has work
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  unsigned* gpath = nullptr;
  if (!in_smem) {
    const long long fit = (long long)(kPathScratch / block_path_bytes);
    if (blocks > fit) blocks = fit > 0 ? fit : 1;
    e = cudaMallocAsync((void**)&gpath, (size_t)blocks * block_path_bytes, st);
    if (e != cudaSuccess) return (int)e;
  }
  init_kernel<<<1, 1, 0, st>>>(offsets, c, (Ctl*)ctl, blocks * kWarps);
  stack_kernel<<<(unsigned)blocks, kThreads, smem, st>>>(
      (const unsigned*)adj, (const unsigned*)cand0, (const unsigned*)fini0,
      (const unsigned*)rext, c, ww, depth, offsets, (Ctl*)ctl,
      (unsigned*)queue, (int*)ready, (unsigned long long)cap, gpath,
      (unsigned long long*)total);
  e = cudaGetLastError();
  if (gpath) {
    const cudaError_t f = cudaFreeAsync(gpath, st);
    if (e == cudaSuccess) e = f;
  }
  return (int)e;
}
