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
// Design: the walk of bk_walk.cuh, shared with K9, without R and the leaf
// filter. Four launches:
//   bk_direct_root, one block per root: the root's pivot and ext_b; its
//     items, the root's children (b, i in ext_b), or one leaf item for a
//     live root with cand0 = fini0 = 0;
//   root_offsets_kernel (block_scan.cuh): the roots' items scanned;
//   bk_direct_init: the count of unfinished items, the warps of the grid;
//   bk_direct_kernel, as many blocks as can be resident at once: the walk.
//     W <= 128 takes the register walk (the root's rows in the warp's
//     registers), W = 256 ... 1024 the memory walk, whose pivot adds the
//     rows of cand's members into bit-sliced counters: fini holds the
//     root's lower-ranked neighbours, so at W = 1024 a node has ~1,000
//     candidates to score while cand holds a few members.
// A node at absolute level d (the root's children at 0; a queued node
// carries its level) holds d + 1 higher-ranked neighbours of the root in R,
// so d < the orientation's largest out-degree. A node that would search a
// child at level `depth` sets the overflow word and abandons its item: the
// count is then short and the caller retries with a deeper path (the plain
// version flags the same). A depth of min(W, core bound) + 2 never
// overflows.
//
// Bound on an H100: operations, the function's own: the pivot scores'
// words by the cheaper of two ways a node (each candidate on cand's
// nonzero words, or each member of cand's row added to every score) and
// 2 * WW bitwise words per child (chip_smoke.py counts them from the plain
// version's tree; the old figure, |cand | fini| * WW popcounts per
// expanded node, is kept beside it as a note), at 16 popcounts and 64
// bitwise results per clock per SM (compute capability 9.0) x 132 SMs x
// the SM clock. What the walk spends beyond it: the dependent
// instructions of the serial walk of a node's children and of the
// bit-sliced adds (a carry chain a member and word), which more warps an SM
// hide (three blocks an SM for the memory walk, below). Its rows' loads
// from L1/L2 are not what binds it at W = 512 and 1024: with the heaviest
// root alone, every warp reading the root's rows from a copy in shared
// memory took as long as reading them from L1/L2 at the same warps an SM
// (W = 1024: 76.04 against 76.07 ms at one block an SM; W = 512: 9.68
// against 10.56 at two; gms_tpu_torch/bench/bk_walk.py on an H100).

#include <cuda_runtime.h>

#include "bk_walk.cuh"

namespace {

__global__ void bk_direct_root(const unsigned* __restrict__ adj,
                               const unsigned* __restrict__ cand0,
                               const unsigned* __restrict__ fini0,
                               const unsigned char* __restrict__ live0,
                               int ww, unsigned* __restrict__ rext,
                               long long* __restrict__ roff) {
  root_items(adj, cand0, fini0, live0, ww, rext, roff);
}

__global__ void bk_direct_init(const long long* roff, long long c, Ctl* ctl,
                               long long warps) {
  walk_init_ctl(roff, c, ctl, warps);
}

// The register walk (WW > 0) two blocks an SM, as K9's (bk_stack.cu): with
// three for every walk the direct RMAT-14 call took 590.78 ms of K36
// against 462.61 with two. The memory walk (WW = 0) three: its steps wait
// on their own dependent instructions, which more warps hide, and at 80
// registers it does not spill. Three against two: K36 267.26 and 268.25 ms
// against 338.13 and 339.45 over the warm direct call; a block's shared
// copy of the root's rows measured no faster (H100,
// gms_tpu_torch/bench/bk_walk.py).
template <int WW, bool kStats>
__global__ void __launch_bounds__(kThreads, WW == 0 ? 3 : 2)
    bk_direct_kernel(WalkArgs a) {
  walk_warps<WW, false, kStats>(a);
}

template <bool kStats>
void (*direct_kernel(int ww))(WalkArgs) {
  switch (ww) {
    case 1: return bk_direct_kernel<1, kStats>;
    case 2: return bk_direct_kernel<2, kStats>;
    case 3: return bk_direct_kernel<3, kStats>;
    case 4: return bk_direct_kernel<4, kStats>;
    default: return bk_direct_kernel<0, kStats>;
  }
}

}  // namespace

// adj: int32[c, 32*ww, ww] (the undirected local adjacency, K4); cand0,
// fini0: int32[c, ww] (K35); live0: bool[c]; depth >= 1 levels; roff:
// int64[c + 2]; rext: int32[c * ww]; ctl: int64[64] zeros; queue:
// int32[cap * (2*ww + 2)]; ready: int32[cap] zeros; stats != 0 launches the
// instantiation that counts the warps' items and cycles into ctl; total:
// int64, added to. The launch shape is chosen by launch_walk.
extern "C" int bk_direct_stack(const void* adj, const void* cand0,
                               const void* fini0, const void* live0,
                               long long c, int ww, int depth, void* roff,
                               void* rext, void* ctl, void* queue, void* ready,
                               long long cap, int stats, void* total,
                               void* stream) {
  if (c <= 0 || ww <= 0 || depth <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  long long* offsets = (long long*)roff;
  bk_direct_root<<<(unsigned)c, kThreads, 0, st>>>(
      (const unsigned*)adj, (const unsigned*)cand0, (const unsigned*)fini0,
      (const unsigned char*)live0, ww, (unsigned*)rext, offsets);
  root_offsets_kernel<<<1, kScanThreads, 0, st>>>(
      c, offsets, (unsigned long long*)(offsets + c + 1));
  WalkArgs a{};
  a.adj = (const unsigned*)adj;
  a.cand0 = (const unsigned*)cand0;
  a.fini0 = (const unsigned*)fini0;
  a.rext = (const unsigned*)rext;
  a.roff = offsets;
  a.c = c;
  a.ww = ww;
  a.depth = depth;
  a.ctl = (Ctl*)ctl;
  a.queue = (unsigned*)queue;
  a.ready = (int*)ready;
  a.cap = (unsigned long long)cap;
  a.total = (unsigned long long*)total;
  a.levels = depth + 1;  // the last for a child that would overflow
  a.stride = 3 * ww;
  a.scratch = ww > 64 ? 2 * ww : 0;  // pivot_sparse's list
  return (int)launch_walk(stats ? direct_kernel<true>(ww)
                                : direct_kernel<false>(ww),
                          bk_direct_init, a, st);
}
