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
// Design. Five launches:
//   bk_stack_cover_t, one block per root: the cover transposed, T[b, j] the
//     bitset over w of "bit j of M[b, w] and wvalid[b, w]", T[b, W] that of
//     wvalid. A leaf R is covered iff T[b, W] & AND_{j in R} T[j] != 0;
//   bk_stack_root, one block per root: the root's pivot and ext_b; its items,
//     the root's children (b, i in ext_b), or one leaf item for a live root
//     with S0 = 0;
//   root_offsets_kernel (block_scan.cuh): the roots' items scanned;
//   bk_stack_init: the count of unfinished items, the warps;
//   bk_stack_kernel, as many blocks as can be resident at once: the walk of
//     bk_walk.cuh, shared with K36. Its warps take the items and share one
//     root's tree through a queue in device memory (RMAT-14: 35 roots hold
//     122 M of the 165 M cliques). The running cover replaces the leaf test
//     of |R| + 1 cover rows: a child ANDs one row of T into its parent's C,
//     a leaf counts iff its C is empty, and under an empty C nothing is
//     tested. W <= 128 (every RMAT-14 job under the degeneracy order) takes
//     the register walk, wider universes (other orders; W = 2048 with the
//     cover's IN >= 2048) the memory walk.
// Emit mode runs the walk twice: the count pass gives the count, which
// sizes out exactly; in the emit pass each accepted leaf takes the next row
// of out by an atomic counter and writes (R | b). The rows' order varies
// from run to run; their set does not.
//
// Bound on an H100: operations, the function's own. The pivot scores'
// words by the cheaper of two ways a node (each candidate on cand's
// nonzero words, or each member of cand's row added to every score),
// 2 * WW bitwise words per child and the running cover's ceil(indeg / 32)
// words per child formed under a non-empty cover (chip_smoke.py counts
// them from the plain version's tree), at the popcount rate of compute
// capability 9.0 (16 per clock per SM) and the bitwise rate (64) x 132 SMs
// x the SM clock. The plain tree's whole count (|cand | fini| * WW
// popcounts a node, the leaf test's (|R| + 1) * ceil(indeg / 32) words a
// leaf) is kept beside it as a note. What the walk spends beyond it: its
// own instructions, ~170 a step of the register walk (shuffles, selects
// and bit moves on uniform registers), the cover rows' loads from L1/L2,
// and warps waiting for a few roots' work at the end of a launch.

#include <cuda_runtime.h>

#include "bk_walk.cuh"

namespace {

// The chunk's cover, transposed: T[b, j] (j < W) is the bitset over w of
// "bit j of M[b, w] and wvalid[b, w]", T[b, W] that of wvalid[b, w]; each
// row in_words = ceil(in_w / 32) words.
__global__ void bk_stack_cover_t(const unsigned* __restrict__ m,
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

__global__ void bk_stack_root(const unsigned* __restrict__ adj,
                              const unsigned* __restrict__ s0,
                              const unsigned char* __restrict__ live0, int ww,
                              unsigned* __restrict__ rext,
                              long long* __restrict__ roff) {
  root_items(adj, s0, nullptr, live0, ww, rext, roff);
}

__global__ void bk_stack_init(const long long* roff, long long c, Ctl* ctl,
                              long long warps) {
  walk_init_ctl(roff, c, ctl, warps);
}

// Two blocks an SM, at most 128 registers a thread: with three (at most
// 85) the W = 128 walk spilled, and the fused RMAT-14 call took 1,041.65
// ms of K9 against 568.04 with two (H100, gms_tpu_torch/bench/bk_walk.py).
template <int WW, bool kStats>
__global__ void __launch_bounds__(kThreads, 2) bk_stack_kernel(WalkArgs a) {
  walk_warps<WW, true, kStats>(a);
}

template <bool kStats>
void (*stack_kernel(int ww))(WalkArgs) {
  switch (ww) {
    case 1: return bk_stack_kernel<1, kStats>;
    case 2: return bk_stack_kernel<2, kStats>;
    case 3: return bk_stack_kernel<3, kStats>;
    case 4: return bk_stack_kernel<4, kStats>;
    default: return bk_stack_kernel<0, kStats>;
  }
}

}  // namespace

// roff: int64[c + 2] (root offsets); rext: int32[c * ww]; cover_t:
// int32[c * (32*ww + 1) * ceil(in_w / 32)]; ctl: int64[64] zeros; queue:
// int32[cap * (3*ww + 2)]; ready: int32[cap] zeros. Count pass: out_rows
// null. Emit pass: out_rows int32[out_cap, ww + 1], out_cap the count pass's
// count. stats != 0 launches the instantiation that counts the warps' items
// and cycles into ctl. The launch shape is chosen by launch_walk.
extern "C" int bk_stack(const void* adj, const void* s0, const void* live0,
                        long long c, int ww, const void* m, const void* wvalid,
                        int in_w, void* roff, void* rext, void* cover_t,
                        void* ctl, void* queue, void* ready, long long cap,
                        void* out_rows, long long out_cap, int stats,
                        void* total, void* stream) {
  if (c <= 0 || ww <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  long long* offsets = (long long*)roff;
  bk_stack_cover_t<<<(unsigned)c, kThreads, 0, st>>>(
      (const unsigned*)m, (const unsigned char*)wvalid, ww, in_w,
      (unsigned*)cover_t);
  bk_stack_root<<<(unsigned)c, kThreads, 0, st>>>(
      (const unsigned*)adj, (const unsigned*)s0,
      (const unsigned char*)live0, ww, (unsigned*)rext, offsets);
  root_offsets_kernel<<<1, kScanThreads, 0, st>>>(
      c, offsets, (unsigned long long*)(offsets + c + 1));
  const int in_words = (in_w + 31) >> 5;
  WalkArgs a{};
  a.adj = (const unsigned*)adj;
  a.cand0 = (const unsigned*)s0;
  a.fini0 = nullptr;
  a.rext = (const unsigned*)rext;
  a.roff = offsets;
  a.c = c;
  a.ww = ww;
  a.cover_t = (const unsigned*)cover_t;
  a.in_words = in_words;
  a.out_rows = (unsigned*)out_rows;
  a.out_cap = (unsigned long long)out_cap;
  a.depth = 32 * ww + 1;  // a node at depth d has |R| = d + 1 <= W
  a.ctl = (Ctl*)ctl;
  a.queue = (unsigned*)queue;
  a.ready = (int*)ready;
  a.cap = (unsigned long long)cap;
  a.total = (unsigned long long*)total;
  a.levels = 32 * ww + 1;
  a.stride = 4 * ww + 1 + in_words;
  a.scratch = ww > 64 ? 2 * ww : 0;  // pivot_sparse's list
  return (int)launch_walk(stats ? stack_kernel<true>(ww)
                                : stack_kernel<false>(ww),
                          bk_stack_init, a, st);
}
