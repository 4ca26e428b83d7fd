// K9 bk_stack: the globally maximal cliques rooted at a chunk, counted or
// emitted, by a Tomita-pivot search over (cand, fini, R) bitsets in each
// root's local DAG universe.
//
// Replaces gms_tpu/algorithms/bron_kerbosch.py:550 bk_stack_machine (and so
// the search of :483 bk_fused_chunk). gms_tpu keeps a LIFO work stack of
// (cand | fini | R | root) rows in device memory, pops a window each round,
// compacts the children with a band sort, banks leaves in a buffer that a
// maximality flush filters, and pauses every iter_budget rounds; the window,
// the capacities with their overflow and split-and-retry, and the resumable
// state exist for its platform. Here the same search tree is walked
// depth-first, which needs one node per level of the path, so nothing
// overflows. The tree, as gms_tpu's (:598-624, :704-756):
//   root b (live): cand = S0, fini = 0, R = 0; a live root with S0 = 0 is
//     the leaf R = 0;
//   a node's pivot is the first u of cand | fini with the largest
//     popcount(cand & adj_u); ext = cand & ~adj_pivot;
//   the child along i in ext, with e< = ext & below(i), is
//     cand' = (cand & ~e<) & adj_i, fini' = (fini | e<) & adj_i, R | {i};
//     it is searched iff cand' != 0, and is a leaf iff cand' = fini' = 0;
//   a leaf R counts iff no w < in_w with wvalid[b, w] has R & ~M[b, w] = 0
//     (:645-650): no lower-ranked neighbour of the root extends the clique.
// Walking children in ascending i while moving each i from cand to fini
// gives the same cand' and fini' as the e< masks.
//
// Design. One root's tree can hold nearly all of a chunk's work (RMAT-14:
// 35 roots hold 122 M of the 165 M cliques, and each root's pivot leaves
// ext_b with one or two vertices), so work moves between warps while they
// run. Five launches:
//   cover_t_kernel, one block per root: the cover transposed, T[b, j] the
//     bitset over w of "bit j of M[b, w] and wvalid[b, w]", T[b, W] that of
//     wvalid. A leaf R is covered iff T[b, W] & AND_{j in R} T[b, j] != 0:
//     |R| + 1 rows of IN/32 words, where testing M row by row reads IN * WW
//     words (16 KB a leaf at IN = 1024, WW = 4);
//   root_kernel, one block per root: the root's pivot and ext_b; its items,
//     the root's children (b, i in ext_b), or one leaf item for a live root
//     with S0 = 0;
//   root_offsets_kernel (block_scan.cuh): the roots' items scanned;
//   init_kernel: the count of unfinished items;
//   stack_kernel, as many blocks as can be resident at once: each warp takes
//     tickets from an atomic counter. A ticket below the root items is (b, i),
//     found by binary search in the offsets; a later ticket is a slot of a
//     queue of nodes (cand, fini, R, b) in device memory, which the warp
//     waits for, polling with a growing sleep, until it is filled or no item
//     is left unfinished. A warp walks its node's subtree depth-first. Level
//     d of its path holds the node's cand, fini and R and its pivot,
//     3*WW + 1 words; a node's next child is the first bit of
//     cand & ~adj_pivot, as children move from cand to fini. Every 16 steps
//     the warp looks whether tickets wait for queue slots; if so it donates
//     the unexplored children of its shallowest open level to the queue (the
//     same children the walk would have made: each queued subtree is the one
//     the plain version expands) and closes that level. A full queue keeps
//     the work with the warp. The control words sit on separate 128-byte
//     lines: polls that share a line with the atomics slowed RMAT-12 four
//     times. The path lies in shared memory where the block's paths fit in
//     100 KB (W <= 128), else in a per-warp slice of device memory; at most
//     W levels, as a node at level d has |R| >= d + 1 and cand outside R.
//     Lanes split the words of the ANDs, the set bits of cand | fini for the
//     pivot (first index on ties, a 64-bit max of (score + 1, ~u)), and the
//     words of the leaf filter.
// Emit mode runs the walk twice: the count pass gives the count, which
// sizes out exactly; in the emit pass each accepted leaf takes the next row
// of out by an atomic counter and writes (R | b). The rows' order varies
// from run to run; their set does not.
//
// Bound on an H100: operations. The AND+popcount word operations of the
// tree, |cand | fini| * WW per expanded node for the pivot, 2 * WW per child
// and (|R| + 1) * ceil(indeg / 32) per leaf tested, indeg the root's lower
// neighbours (the plain version counts them), at the popcount rate of
// compute capability 9.0 (16 per clock per SM) x 132 SMs x the SM clock.
// Lanes idle on narrow words (WW <= 4 at RMAT-14), the serial walk of a
// node's children and the latency of each step's dependent loads are what
// this kernel spends beyond that.

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
// A block's paths lie in shared memory up to this size (W <= 128), else in
// device memory, at most kPathScratch bytes for the grid.
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

// Per root: the pivot of (cand S0, fini 0) and ext_b = S0 & ~adj_pivot into
// rext; roff[b] = the root's items (|ext_b|, 1 for a live root with S0 = 0,
// 0 for a dead root).
__global__ void root_kernel(const unsigned* __restrict__ adj,
                            const unsigned* __restrict__ s0,
                            const unsigned char* __restrict__ live0, int ww,
                            unsigned* __restrict__ rext,
                            long long* __restrict__ roff) {
  __shared__ unsigned long long best;
  const int W = 32 * ww;
  const long long b = blockIdx.x;
  const unsigned* S0 = s0 + b * ww;
  const unsigned* A = adj + b * W * ww;
  const bool live = live0[b] != 0;
  if (threadIdx.x == 0) best = 0ull;
  __syncthreads();
  if (live) {
    for (int u = threadIdx.x; u < W; u += blockDim.x) {
      if (!((S0[u >> 5] >> (u & 31)) & 1u)) continue;
      const unsigned* Au = A + (long long)u * ww;
      int s = 0;
      for (int w = 0; w < ww; ++w) s += __popc(S0[w] & Au[w]);
      atomicMax(&best, pivot_key(s, u));
    }
  }
  __syncthreads();
  const unsigned long long key = best;
  const unsigned* Ap = A + (long long)(key ? key_vertex(key) : 0) * ww;
  for (int w = threadIdx.x; w < ww; w += blockDim.x)
    rext[b * ww + w] = key ? S0[w] & ~Ap[w] : 0u;
  if (threadIdx.x == 0) {
    long long n = 0;
    if (live && !key) n = 1;
    if (key)
      for (int w = 0; w < ww; ++w) n += __popc(S0[w] & ~Ap[w]);
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

// node = (cand[ww] | fini[ww] | R[ww] | pivot): stores the pivot. cand |
// fini is not empty.
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
  if (lane == 0) node[3 * ww] = (unsigned)key_vertex(best);
  __syncwarp();
}

// The chunk's cover, transposed: T[b, j] (j < W) is the bitset over w of
// "bit j of M[b, w] and wvalid[b, w]", T[b, W] that of wvalid[b, w]; each
// row in_words = ceil(in_w / 32) words.
__global__ void cover_t_kernel(const unsigned* __restrict__ m,
                               const unsigned char* __restrict__ wvalid,
                               int ww, int in_w, unsigned* __restrict__ t) {
  const int W = 32 * ww, in_words = (in_w + 31) >> 5;
  const long long b = blockIdx.x;
  const unsigned* Mb = m + b * in_w * ww;
  const unsigned char* Vb = wvalid + b * in_w;
  unsigned* Tb = t + b * (W + 1) * in_words;
  for (int x = threadIdx.x; x < (W + 1) * in_words; x += blockDim.x) {
    const int j = x / in_words, base = 32 * (x % in_words);
    unsigned word = 0u;
    for (int i = 0; i < 32 && base + i < in_w; ++i) {
      const int w = base + i;
      const bool in_m =
          j == W || ((Mb[(long long)w * ww + (j >> 5)] >> (j & 31)) & 1u);
      if (Vb[w] && in_m) word |= 1u << i;
    }
    Tb[x] = word;
  }
}

// Whether leaf R is maximal: no valid w row of the root covers it, i.e. the
// AND of the root's transposed cover rows T[j], j in R, and T[W] is empty.
// Lanes split the words. (Loading the rows 8 at a time and stopping once the
// AND is empty in every lane measured no faster at RMAT-14.)
__device__ __forceinline__ bool leaf_ok(const unsigned* R, const unsigned* T,
                                        int in_words, int ww, int lane) {
  const int W = 32 * ww;
  for (int xb = 0; xb < in_words; xb += 32) {
    const int x = xb + lane;
    unsigned acc = 0u;
    if (x < in_words) {
      acc = __ldg(T + (long long)W * in_words + x);
      for (int r = 0; r < ww; ++r) {
        for (unsigned bits = R[r]; bits; bits &= bits - 1)
          acc &= __ldg(T + (long long)(32 * r + __ffs(bits) - 1) * in_words + x);
      }
    }
    if (__any_sync(kFull, acc != 0u)) return false;
  }
  return true;
}

// Work shared by a chunk's warps (int64[64], zeroed by the caller; pending
// set by init_kernel): tickets taken, queue slots reserved, items not yet
// finished (the implicit root items and every queued node), rows emitted.
// Each word has a 128-byte line of its own, so that the waiting warps'
// polls of `pending` do not queue behind the atomics on the others.
struct Ctl {
  alignas(128) unsigned long long head;
  alignas(128) unsigned long long tail;
  alignas(128) unsigned long long pending;
  alignas(128) unsigned long long out_tail;
};

__global__ void init_kernel(const long long* roff, long long c, Ctl* ctl) {
  ctl->pending = (unsigned long long)roff[c];
}

// Queued node / path level: cand[ww] | fini[ww] | R[ww] | one word (the
// root in the queue, the pivot on the path).
__device__ __forceinline__ void load_node(unsigned* dst, const unsigned* src,
                                          int words, int lane) {
  for (int w = lane; w < words; w += 32) dst[w] = __ldcg(src + w);
  __syncwarp();
}

struct Search {
  const unsigned* A;   // the root's adj rows
  const unsigned* T;   // the root's transposed cover rows
  long long b;
  int ww, in_words, lane;
  Ctl* ctl;
  unsigned* out_rows;
  unsigned long long out_cap;
  long long k;  // accepted leaves, warp-uniform
  bool full;    // the queue had no room: donate no more

  // a leaf at R: counts (and is written) iff it is maximal
  __device__ __forceinline__ void leaf(const unsigned* R) {
    if (!leaf_ok(R, T, in_words, ww, lane)) return;
    if (out_rows) {
      unsigned long long pos = 0;
      if (lane == 0) pos = atomicAdd(&ctl->out_tail, 1ull);
      pos = __shfl_sync(kFull, pos, 0);
      if (pos < out_cap) {
        unsigned* row = out_rows + pos * (ww + 1);
        for (int w = lane; w < ww; w += 32) row[w] = R[w];
        if (lane == 0) row[ww] = (unsigned)b;
      }
    }
    ++k;
  }

  // The child of node L along v, with the children before it already moved
  // from cand to fini (done = those bits), into dst (cand' | fini' | R');
  // returns 2 if cand' != 0, 1 if it is a leaf, 0 if it is dead.
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
      dst[2 * ww + w] = L[2 * ww + w] | (w == (v >> 5) ? 1u << (v & 31) : 0u);
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
// that are leaves. path[0..d] is the warp's path, tmp a free node.
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
    const unsigned* Ap = s.A + (long long)L[3 * ww] * ww;
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
        for (int w = lane; w < 3 * ww; w += 32) __stcg(dst + w, tmp[w]);
        if (lane == 0) __stcg(dst + 3 * ww, (unsigned)s.b);
      } else if (kind == 1) {
        s.leaf(tmp + 2 * ww);
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
    const int v = first_andnot(L, s.A + (long long)L[3 * ww] * ww, ww, lane);
    __syncwarp();
    if (v >= W) {
      --d;
      continue;
    }
    unsigned* nxt = L + stride;
    const int kind = s.child(nxt, L, nullptr, v);
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
      s.leaf(nxt + 2 * ww);
    }
    if (++since == kDonateEvery) {
      since = 0;
      donate(s, path, d, stride, tmp, done, queue, ready, cap, n_root);
    }
  }
}

// At most 80 registers a thread, so that 3 blocks fit an SM (96 allowed 2;
// 64 spilled and ran slower at RMAT-14).
__global__ void __launch_bounds__(kThreads, 3)
stack_kernel(const unsigned* __restrict__ adj,
                             const unsigned* __restrict__ s0,
                             const unsigned* __restrict__ rext, long long c,
                             int ww, const unsigned* __restrict__ cover_t,
                             int in_w, const long long* __restrict__ roff,
                             Ctl* ctl, unsigned* queue, int* ready,
                             unsigned long long cap, unsigned* gpath,
                             unsigned* out_rows, unsigned long long out_cap,
                             unsigned long long* total) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = 32 * ww;
  const int stride = 3 * ww + 1;
  // W path levels, a spare node and a word buffer
  const long long path_words = (long long)(W + 1) * stride + ww;
  unsigned* path = gpath ? gpath + ((long long)blockIdx.x * kWarps + warp) * path_words
                         : smem + warp * path_words;
  unsigned* tmp = path + (long long)W * stride;
  unsigned* done = tmp + stride;
  const unsigned long long n_root = roff[c];
  Search s;
  s.ww = ww;
  s.in_words = (in_w + 31) >> 5;
  s.lane = lane;
  s.ctl = ctl;
  s.out_rows = out_rows;
  s.out_cap = out_cap;
  s.k = 0;
  s.full = false;
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
      s.T = cover_t + b * (W + 1) * s.in_words;
      const unsigned* S0 = s0 + b * ww;
      if (all_zero(S0, ww, lane)) {
        for (int w = lane; w < ww; w += 32) L0[2 * ww + w] = 0u;
        __syncwarp();
        s.leaf(L0 + 2 * ww);  // a live root with S0 = 0: R = 0
      } else {
        // the root node (S0, 0, 0) in tmp, its child along the i-th ext bit
        const unsigned* E = rext + b * ww;
        const int i = nth_bit(E, ww, (int)(t - roff[b]));
        for (int w = lane; w < ww; w += 32) {
          tmp[w] = S0[w];
          tmp[ww + w] = 0u;
          tmp[2 * ww + w] = 0u;
          done[w] = E[w] & below_word(i, w);
        }
        __syncwarp();
        const int kind = s.child(L0, tmp, done, i);
        search = kind == 2;
        if (kind == 1) s.leaf(L0 + 2 * ww);
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
      const long long b = L0[3 * ww];
      s.b = b;
      s.A = adj + b * W * ww;
      s.T = cover_t + b * (W + 1) * s.in_words;
      search = true;
    }
    if (search) {
      set_pivot(L0, s.A, ww, lane);
      walk(s, path, stride, tmp, done, queue, ready, cap, n_root);
    }
    __threadfence();
    if (lane == 0) atomicAdd(&ctl->pending, ~0ull);  // this item is done
    __syncwarp();
  }
  block_sum_add(lane == 0 ? s.k : 0, total);
}

}  // namespace

// roff: int64[c + 2] (root offsets); rext: int32[c * ww]; cover_t:
// int32[c * (32*ww + 1) * ceil(in_w / 32)]; ctl: int64[64] zeros; queue:
// int32[cap * (3*ww + 1)]; ready: int32[cap] zeros. Count pass: out_rows
// null. Emit pass: out_rows int32[out_cap, ww + 1], out_cap the count pass's
// count. The launch shape is chosen here: the grid is the blocks that can be
// resident at once, and where a block's paths do not fit kSmemPaths the
// paths lie in device memory taken from the stream's pool for this launch.
extern "C" int bk_stack(const void* adj, const void* s0, const void* live0,
                        long long c, int ww, const void* m, const void* wvalid,
                        int in_w, void* roff, void* rext, void* cover_t,
                        void* ctl, void* queue, void* ready, long long cap,
                        void* out_rows, long long out_cap, void* total,
                        void* stream) {
  if (c <= 0 || ww <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  long long* offsets = (long long*)roff;
  cover_t_kernel<<<(unsigned)c, kThreads, 0, st>>>(
      (const unsigned*)m, (const unsigned char*)wvalid, ww, in_w,
      (unsigned*)cover_t);
  root_kernel<<<(unsigned)c, kThreads, 0, st>>>(
      (const unsigned*)adj, (const unsigned*)s0,
      (const unsigned char*)live0, ww, (unsigned*)rext, offsets);
  root_offsets_kernel<<<1, kScanThreads, 0, st>>>(
      c, offsets, (unsigned long long*)(offsets + c + 1));
  init_kernel<<<1, 1, 0, st>>>(offsets, c, (Ctl*)ctl);
  const size_t block_path_bytes =
      (size_t)kWarps * ((32 * ww + 1) * (3 * ww + 1) + ww) * sizeof(unsigned);
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
  stack_kernel<<<(unsigned)blocks, kThreads, smem, st>>>(
      (const unsigned*)adj, (const unsigned*)s0, (const unsigned*)rext, c, ww,
      (const unsigned*)cover_t, in_w, offsets,
      (Ctl*)ctl, (unsigned*)queue, (int*)ready, (unsigned long long)cap,
      gpath, (unsigned*)out_rows, (unsigned long long)out_cap,
      (unsigned long long*)total);
  e = cudaGetLastError();
  if (gpath) {
    const cudaError_t f = cudaFreeAsync(gpath, st);
    if (e == cudaSuccess) e = f;
  }
  return (int)e;
}
