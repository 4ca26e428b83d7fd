// The walk shared by the two Bron–Kerbosch searches: K9 (bk_stack.cu, the
// globally maximal cliques of each root's DAG universe, with R and the leaf
// filter) and K36 (bk_direct.cu, the maximal cliques of each root's full
// neighbourhood). Both walk the same Tomita tree depth-first over bitsets of
// a root's W = 32*ww slots:
//   a node (cand, fini[, R]) with cand != 0 takes as pivot the first u of
//     cand | fini with the largest popcount(cand & adj_u); its children are
//     the i of todo = cand & ~adj_pivot, in ascending order, each moved from
//     cand to fini once its child is formed: cand' = cand & adj_i, fini' =
//     fini & adj_i (R' = R | {i});
//   a child is searched iff cand' != 0, and is a leaf iff cand' = fini' = 0.
// K9's leaf R counts iff no valid lower neighbour w of the root covers it:
// with T the transposed cover (T[j] the bitset over w of "slot j lies in
// N+(w)", T[W] that of the valid w), iff T[W] & AND_{j in R} T[j] = 0. The
// walk keeps that AND, the running cover C, on each path level: a child
// ANDs one row of T into its parent's C, and a subtree under an empty C
// takes no leaf test at all (every leaf there counts).
//
// What bounded the walk it replaces on an H100 (its cycle split over
// RMAT-14, chip_smoke.py phases 15 and 52): every step read its rows from device memory, with most
// lanes idle at W <= 128, where all of RMAT-14's fused jobs lie. K9's
// largest job spent 0.49 of its warp cycles in the leaf filter (|R| + 1
// dependent cover rows a leaf) and 0.16 in the pivot; K36's W = 1024 job
// 0.79 in the pivot (every candidate of cand | fini, ~1,000 of them, read
// on all 32 words). Here:
//   W <= 128 (ww <= 4, a template argument): the register walk. Lane l holds
//     the root's rows l + 32k, k < ww (at most 16 words); cand, fini and
//     todo are warp-uniform registers. A pivot is one popcount a held word
//     and one __reduce_max_sync of (score + 1, ~u) in 32 bits; a child's row
//     comes from its lane by __shfl_sync. A step loads from device memory
//     only the cover row of its child (K9, while C is not empty), ahead of
//     the shuffles. The walk is then bound by its own instructions, ~170 a
//     step.
//   W > 128: the memory walk. The current node lies on the path, lanes split
//     its words; rows come from device memory (L1/L2: a block's copy of one
//     root's rows in shared memory measured no faster, and at W = 1024 it
//     leaves one block an SM). Up to W = 2048 the
//     pivot scores every u at once: bit-sliced counters (12 planes, a word
//     of each a lane) add the row of each member of cand, one coalesced row
//     load a member, and the first member of cand | fini with the largest
//     count is found plane by plane. Below a root cand holds a few
//     members while fini holds hundreds, so this reads |cand| rows where
//     scoring each candidate read |cand | fini| of them. Wider universes
//     score each candidate on cand's nonzero words only.
// Both keep todo on each level, so no step reloads the pivot's row.
//
// The path: level d holds cand, fini and todo of the node at depth d (K9: R,
// whether C is not empty, and C). Levels below smem_levels lie in shared
// memory (8 KB a warp), deeper ones in a per-warp slice of device memory
// taken from the stream's pool for the launch; a warp reaches them only on
// paths deeper than the shared part.
//
// Work moves between warps as in the walk it replaces: tickets from an atomic counter
// are first the root items (b, i in ext_b, or one leaf item for a live root
// with cand0 = fini0 = 0), then slots of a queue of donated nodes (cand |
// fini [| R] | b | level) in device memory that a warp waits for, polling
// with a growing sleep, until it is filled or nothing is left unfinished.
// Every kDonateEvery steps a warp looks whether tickets wait for slots and,
// if so, donates the unexplored children of its shallowest open level. The control words sit on separate 128-byte lines.
#pragma once

#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "block_sum.cuh"
#include "reg_rows.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
// DFS steps between a warp's looks at whether other warps wait for work: a
// donation costs the donor and each taker a restart (the taker's rows,
// cover and pivot), so with the faster walk 256 beat 16, 32, 64 and 128
// (RMAT-14 on an H100, gms_tpu_torch/bench/bk_walk.py: K9 took 549, 349,
// 277, 239 and 223 ms over a warm fused call for 16 ... 256)
constexpr int kDonateEvery = 256;
// shared memory a warp takes for its scratch and the top of its path (8 KB:
// up to three blocks an SM). RMAT-14's deepest paths fit it but for 1 % of
// K36's W = 1024 steps, and 14 KB measured no faster.
constexpr int kSmemWarpWords = 2048;
// device memory for the deeper path levels of the whole grid, at most
constexpr size_t kPathScratch = size_t(1) << 30;

// The parts of a warp's time: walking (the rest), pivot, forming children,
// the leaf filter (K9: the running cover) and waiting for work or donating.
enum WalkPart { kWalk = 0, kPivot, kChild, kLeaf, kWait, kParts };

// Kept only in a kernel's kOn instantiation, so that the normal launch
// carries no counters. charge(p) adds the cycles since the last mark to p:
// the parts sum to the warp's time. steps counts the children formed,
// nodes the pivots taken, deep the children formed on a level in device
// memory.
template <bool kOn>
struct Cycles {
  long long part[kParts];
  long long mark;
  unsigned long long steps, nodes, deep;
  __device__ __forceinline__ void init() {
    if (kOn) {
      for (int p = 0; p < kParts; ++p) part[p] = 0;
      steps = nodes = deep = 0;
      mark = clock64();
    }
  }
  // a child formed; in_smem: whether its level lies in shared memory
  __device__ __forceinline__ void step(bool in_smem) {
    if (kOn) {
      ++steps;
      deep += !in_smem;
    }
  }
  __device__ __forceinline__ void node() {
    if (kOn) ++nodes;
  }
  // dep: a value the part computed last; the clock is read once it is
  // ready, so a part's latency is charged to it and not to the next
  __device__ __forceinline__ void charge(int p, unsigned dep = 0u) {
    if (kOn) {
      unsigned sink;
      asm volatile("mov.b32 %0, %1;" : "=r"(sink) : "r"(dep));
      const long long now = clock64();
      part[p] += now - mark;
      mark = now;
    }
  }
  // lane 0 adds the warp's parts into out[0..kParts), then its steps,
  // nodes and deep steps into out[kParts..kParts + 3)
  __device__ __forceinline__ void flush(unsigned long long* out, int lane) {
    if (kOn && lane == 0) {
      for (int p = 0; p < kParts; ++p)
        atomicAdd(out + p, (unsigned long long)part[p]);
      atomicAdd(out + kParts, steps);
      atomicAdd(out + kParts + 1, nodes);
      atomicAdd(out + kParts + 2, deep);
    }
  }
};

// Work shared by a launch's warps (int64[64], zeroed by the caller; pending
// and warps set by walk_init): tickets taken, queue slots reserved, items
// not yet finished, then on the fourth line aux (K9: rows emitted; K36: the
// overflow word), the items taken, the most one warp took, the warps and,
// under stats, the cycles by part. The first three words have a 128-byte
// line each, so that the waiting warps' polls of `pending` do not queue
// behind the atomics.
struct Ctl {
  alignas(128) unsigned long long head;
  alignas(128) unsigned long long tail;
  alignas(128) unsigned long long pending;
  alignas(128) unsigned long long aux;
  unsigned long long items;
  unsigned long long max_items;
  unsigned long long warps;
  unsigned long long cycles[kParts + 3];  // the parts, steps, nodes, deep
};

struct WalkArgs {
  const unsigned* adj;    // [c, W, ww] symmetric rows of each root's slots
  const unsigned* cand0;  // [c, ww] each root's cand (K9: S0)
  const unsigned* fini0;  // [c, ww] each root's fini (K36), null for K9
  const unsigned* rext;   // [c, ww] each root's children (its ext)
  const long long* roff;  // [c + 2] the roots' item offsets
  long long c;
  int ww;
  const unsigned* cover_t;  // K9: [c, W + 1, in_words]
  int in_words;
  unsigned* out_rows;       // K9 emit pass: [out_cap, ww + 1], else null
  unsigned long long out_cap;
  int depth;  // K36: a node at absolute level >= depth overflows
  Ctl* ctl;
  unsigned* queue;  // [cap, qstride]
  int* ready;       // [cap]
  unsigned long long cap;
  unsigned* gpath;  // per-warp device slices of levels >= smem_levels
  int levels, smem_levels, stride, scratch;
  unsigned long long* total;
};

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

// Bit v within word w.
__device__ __forceinline__ unsigned bit_word(int v, int w) {
  return w == (v >> 5) ? 1u << (v & 31) : 0u;
}

// Per root: the pivot of (cand0, fini0) and ext_b = cand0 & ~adj_pivot into
// rext; roff[b] = the root's items (|ext_b|, 1 for a live root with cand0 =
// fini0 = 0, 0 for a dead root). One block a root; fini0 may be null.
__device__ __forceinline__ void root_items(const unsigned* __restrict__ adj,
                                           const unsigned* __restrict__ cand0,
                                           const unsigned* __restrict__ fini0,
                                           const unsigned char* __restrict__ live0,
                                           int ww, unsigned* __restrict__ rext,
                                           long long* __restrict__ roff) {
  __shared__ unsigned long long best;
  const int W = 32 * ww;
  const long long b = blockIdx.x;
  const unsigned* C0 = cand0 + b * ww;
  const unsigned* F0 = fini0 ? fini0 + b * ww : nullptr;
  const unsigned* A = adj + b * W * ww;
  const bool live = live0[b] != 0;
  if (threadIdx.x == 0) best = 0ull;
  __syncthreads();
  if (live) {
    for (int u = threadIdx.x; u < W; u += blockDim.x) {
      const unsigned mem = C0[u >> 5] | (F0 ? F0[u >> 5] : 0u);
      if (!((mem >> (u & 31)) & 1u)) continue;
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

__device__ __forceinline__ void walk_init_ctl(const long long* roff,
                                              long long c, Ctl* ctl,
                                              long long warps) {
  ctl->pending = (unsigned long long)roff[c];
  ctl->warps = (unsigned long long)warps;
}

// ---------------------------------------------------------------------------
// the work shared between warps
// ---------------------------------------------------------------------------

// The warp's next ticket; for a queued node (t >= n_root) waits until its
// slot is filled. Returns ~0 when no work will come.
__device__ __forceinline__ unsigned long long next_item(
    const WalkArgs& a, unsigned long long n_root, int lane) {
  unsigned long long t = 0;
  if (lane == 0) t = atomicAdd(&a.ctl->head, 1ull);
  t = __shfl_sync(kFull, t, 0);
  if (t < n_root) return t;
  const unsigned long long slot = t - n_root;
  int ok = 0;
  if (lane == 0 && slot < a.cap) {
    const volatile int* flag = a.ready + slot;
    const volatile Ctl* v = a.ctl;
    for (unsigned ns = 64;; ns = ns < 4096 ? 2 * ns : ns) {
      if (*flag) {
        ok = 1;
        break;
      }
      if (v->pending == 0ull) break;
      __nanosleep(ns);
    }
  }
  if (!__shfl_sync(kFull, ok, 0)) return ~0ull;
  __threadfence();
  return t;
}

__device__ __forceinline__ void finish_item(Ctl* ctl, int lane) {
  __threadfence();
  if (lane == 0) atomicAdd(&ctl->pending, ~0ull);
  __syncwarp();
}

// Whether tickets wait for queue slots; warp-uniform. (Reading the words
// one look ahead left a launch's few heavy items undonated.)
__device__ __forceinline__ bool hungry(const Ctl* ctl,
                                       unsigned long long n_root, int lane) {
  int h = 0;
  if (lane == 0) {
    const volatile Ctl* v = ctl;
    h = v->head > n_root + v->tail;
  }
  return __shfl_sync(kFull, h, 0) != 0;
}

// Reserves n > 0 queue slots: the first, or ~0 if the queue has no room.
__device__ __forceinline__ unsigned long long reserve_slots(
    Ctl* ctl, int n, unsigned long long cap, int lane) {
  unsigned long long base = 0;
  int ok = 1;
  if (lane == 0) {
    unsigned long long cur = *(volatile unsigned long long*)&ctl->tail;
    for (;;) {
      if (cur + n > cap) {
        ok = 0;
        break;
      }
      const unsigned long long prev = atomicCAS(&ctl->tail, cur, cur + n);
      if (prev == cur) break;
      cur = prev;
    }
    base = cur;
    if (ok) atomicAdd(&ctl->pending, (unsigned long long)n);
  }
  if (!__shfl_sync(kFull, ok, 0)) return ~0ull;
  return __shfl_sync(kFull, base, 0);
}

__device__ __forceinline__ void publish_slots(int* ready,
                                              unsigned long long base, int n,
                                              int lane) {
  __threadfence();
  __syncwarp();
  if (lane == 0)
    for (int i = 0; i < n; ++i) *(volatile int*)(ready + base + i) = 1;
}

// The next row of out for an accepted leaf (K9's emit pass), or ~0 when
// there is none; warp-uniform.
__device__ __forceinline__ unsigned long long emit_row(const WalkArgs& a,
                                                       int lane) {
  if (!a.out_rows) return ~0ull;
  unsigned long long pos = 0;
  if (lane == 0) pos = atomicAdd(&a.ctl->aux, 1ull);
  pos = __shfl_sync(kFull, pos, 0);
  return pos < a.out_cap ? pos : ~0ull;
}

// ---------------------------------------------------------------------------
// K9's running cover: lane x holds words x, x + 32, ... of a level's C
// ---------------------------------------------------------------------------

// C = src & Tv, stored to dst unless null; whether C != 0 (warp-uniform).
// With ahead, t0 is Tv[lane], loaded ahead by the caller.
__device__ __forceinline__ bool cover_and(const unsigned* src,
                                          const unsigned* __restrict__ Tv,
                                          unsigned* dst, int in_words,
                                          int lane, bool ahead = false,
                                          unsigned t0 = 0u) {
  unsigned any = 0u;
  for (int x = lane; x < in_words; x += 32) {
    const unsigned c = src[x] & (ahead && x == lane ? t0 : __ldg(Tv + x));
    if (dst) dst[x] = c;
    any |= c;
  }
  return __any_sync(kFull, any != 0u);
}

// C = T[W] & AND_{j in R} T[j] into dst, R's words by r_word(w); whether
// C != 0. A queued node's cover, once an item.
template <class RWord>
__device__ __forceinline__ bool cover_of(RWord r_word, int ww,
                                         const unsigned* __restrict__ T,
                                         unsigned* dst, int in_words,
                                         int lane) {
  const int W = 32 * ww;
  unsigned any = 0u;
  for (int x = lane; x < in_words; x += 32) {
    unsigned acc = __ldg(T + (long long)W * in_words + x);
    for (int w = 0; w < ww; ++w)
      for (unsigned bits = r_word(w); bits; bits &= bits - 1)
        acc &= __ldg(T + (long long)(32 * w + __ffs(bits) - 1) * in_words + x);
    dst[x] = acc;
    any |= acc;
  }
  return __any_sync(kFull, any != 0u);
}

// ---------------------------------------------------------------------------
// the register walk, W = 32*WW <= 128
// ---------------------------------------------------------------------------

// todo = cand & ~adj_pivot (cand | fini != 0); every lane
template <int WW>
__device__ __forceinline__ void reg_pivot(const RegRows<WW>& rows,
                                          const unsigned (&cand)[WW],
                                          const unsigned (&fini)[WW],
                                          unsigned (&todo)[WW], int lane) {
  unsigned best = 0u;  // (score + 1) << 16 | ~u, u < 128
#pragma unroll
  for (int k = 0; k < WW; ++k) {
    if (((cand[k] | fini[k]) >> lane) & 1u) {
      int s = 0;
#pragma unroll
      for (int x = 0; x < WW; ++x) s += __popc(cand[x] & rows.r[k][x]);
      const unsigned key =
          ((unsigned)(s + 1) << 16) | (0xffffu - (unsigned)(32 * k + lane));
      best = key > best ? key : best;
    }
  }
  best = __reduce_max_sync(kFull, best);
  unsigned rp[WW];
  rows.row((int)(0xffffu - (best & 0xffffu)), rp);
#pragma unroll
  for (int x = 0; x < WW; ++x) todo[x] = cand[x] & ~rp[x];
}

// A path level of the register walk: cand | fini | todo [| R | C live | C].
// cand, fini and todo live in registers while the level is the walk's
// node, and are saved here when it descends; R and C stay here.
template <int WW, bool kK9>
struct RegLevel {
  static constexpr int kNode = (kK9 ? 4 : 3) * WW;

  // lane 0 stores the warp-uniform words, by compile-time indices
  __device__ static __forceinline__ void save(
      unsigned* L, const unsigned (&cand)[WW], const unsigned (&fini)[WW],
      const unsigned (&todo)[WW], bool live, int lane) {
    if (lane == 0) {
#pragma unroll
      for (int x = 0; x < WW; ++x) {
        L[x] = cand[x];
        L[WW + x] = fini[x];
        L[2 * WW + x] = todo[x];
      }
      if (kK9) L[kNode] = live ? 1u : 0u;
    }
    __syncwarp();
  }

  __device__ static __forceinline__ void load(
      const unsigned* L, unsigned (&cand)[WW], unsigned (&fini)[WW],
      unsigned (&todo)[WW], bool& live) {
#pragma unroll
    for (int x = 0; x < WW; ++x) {
      cand[x] = L[x];
      fini[x] = L[WW + x];
      todo[x] = L[2 * WW + x];
    }
    live = kK9 && L[kNode] != 0u;
  }

  // K9: level d + 1's R = level d's | {v}
  __device__ static __forceinline__ void extend_r(const unsigned* L,
                                                  unsigned* N, int v,
                                                  int lane) {
    if (lane < WW) N[3 * WW + lane] = L[3 * WW + lane] | bit_word(v, lane);
    __syncwarp();
  }
};

template <int WW, bool kK9, bool kStats>
struct RegWalk {
  static constexpr int W = 32 * WW;
  static constexpr int kNode = (kK9 ? 4 : 3) * WW;
  static constexpr int kQNode = (kK9 ? 3 : 2) * WW;
  using Level = RegLevel<WW, kK9>;

  const WalkArgs& a;
  int lane;
  unsigned* spath;
  unsigned* gpath;
  unsigned long long n_root;
  Cycles<kStats> cy;
  RegRows<WW> rows;
  int held;  // the root whose rows are in `rows`
  int b;
  const unsigned* T;  // K9: the root's transposed cover
  long long k;        // accepted leaves, warp-uniform
  int since;
  bool full;  // the queue had no room: donate no more

  __device__ __forceinline__ RegWalk(const WalkArgs& args, unsigned* smem)
      : a(args), held(-1), b(-1), T(nullptr), k(0), since(0), full(false) {
    lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    spath = smem + (size_t)warp * (a.scratch + a.smem_levels * a.stride) +
            a.scratch;
    gpath = a.gpath ? a.gpath + ((size_t)blockIdx.x * kWarps + warp) *
                                    (size_t)(a.levels - a.smem_levels) *
                                    a.stride
                    : nullptr;
    n_root = (unsigned long long)a.roff[a.c];
    cy.init();
  }

  __device__ __forceinline__ unsigned* level(int d) const {
    return d < a.smem_levels
               ? spath + d * a.stride
               : gpath + (size_t)(d - a.smem_levels) * a.stride;
  }

  __device__ __forceinline__ void take_root(int root) {
    b = root;
    if (held != root) {
      rows.load(a.adj + (long long)root * W * WW, lane);
      held = root;
    }
    if (kK9) T = a.cover_t + (long long)root * (W + 1) * a.in_words;
  }

  // an accepted leaf R | {v} (v < 0: R), R on level L: counted, and
  // written in the emit pass
  __device__ __forceinline__ void accept(const unsigned* L, int v) {
    const unsigned long long pos = emit_row(a, lane);
    if (pos != ~0ull) {
      unsigned* row = a.out_rows + pos * (WW + 1);
      if (lane < WW)
        row[lane] = L[3 * WW + lane] | (v >= 0 ? bit_word(v, lane) : 0u);
      if (lane == WW) row[WW] = (unsigned)b;
    }
    ++k;
  }

  // the child of (cand, fini) along v with `done` moved: its cand' and
  // fini' from row v
  __device__ __forceinline__ void child(const unsigned (&cand)[WW],
                                        const unsigned (&fini)[WW],
                                        const unsigned (&done)[WW], int v,
                                        unsigned (&cc)[WW],
                                        unsigned (&cf)[WW]) const {
    unsigned rv[WW];
    rows.row(v, rv);
#pragma unroll
    for (int x = 0; x < WW; ++x) {
      cc[x] = (cand[x] & ~done[x]) & rv[x];
      cf[x] = (fini[x] | done[x]) & rv[x];
    }
  }

  // Moves the unexplored children of the shallowest open level (d: the
  // current node, in registers) to the queue if the queue has room; counts
  // those that are leaves and closes the level.
  __device__ __forceinline__ void donate(int d, int base,
                                         unsigned (&cand)[WW],
                                         unsigned (&fini)[WW],
                                         unsigned (&todo)[WW], bool live) {
    int e = 0;
    unsigned ec[WW], ef[WW], et[WW];
    bool elive = live;
    for (; e < d; ++e) {
      Level::load(level(e), ec, ef, et, elive);
      if (any_bit(et)) break;
    }
    if (e == d) {
      if (!any_bit(todo)) return;
#pragma unroll
      for (int x = 0; x < WW; ++x) {
        ec[x] = cand[x];
        ef[x] = fini[x];
        et[x] = todo[x];
      }
      elive = live;
    }
    const unsigned* Le = level(e);
    if (!kK9 && base + e + 1 >= a.depth) return;  // the walk will overflow
    unsigned cc[WW], cf[WW], done[WW], rest[WW];
    int n = 0;
#pragma unroll
    for (int x = 0; x < WW; ++x) rest[x] = et[x];
    for (int v = first_bit(rest); v >= 0; v = first_bit(rest)) {
      clear_bit(rest, v);
#pragma unroll
      for (int x = 0; x < WW; ++x) done[x] = et[x] & below_word(v, x);
      child(ec, ef, done, v, cc, cf);
      n += any_bit(cc);
    }
    unsigned long long slot = 0;
    if (n > 0) {
      slot = reserve_slots(a.ctl, n, a.cap, lane);
      if (slot == ~0ull) {  // no room: keep the work
        full = true;
        return;
      }
    }
    int q = 0;
#pragma unroll
    for (int x = 0; x < WW; ++x) rest[x] = et[x];
    for (int v = first_bit(rest); v >= 0; v = first_bit(rest)) {
      clear_bit(rest, v);
#pragma unroll
      for (int x = 0; x < WW; ++x) done[x] = et[x] & below_word(v, x);
      child(ec, ef, done, v, cc, cf);
      if (any_bit(cc)) {
        unsigned* dst = a.queue + (slot + q++) * (size_t)(kQNode + 2);
        if (lane == 0) {
#pragma unroll
          for (int x = 0; x < WW; ++x) {
            __stcg(dst + x, cc[x]);
            __stcg(dst + WW + x, cf[x]);
          }
          __stcg(dst + kQNode, (unsigned)b);
          __stcg(dst + kQNode + 1, (unsigned)(base + e + 1));
        }
        if (kK9 && lane < WW)
          __stcg(dst + 2 * WW + lane, Le[3 * WW + lane] | bit_word(v, lane));
      } else if (!any_bit(cf)) {
        const bool covered =
            kK9 && elive &&
            cover_and(Le + kNode + 1, T + (long long)v * a.in_words,
                      nullptr, a.in_words, lane);
        if (!covered) {
          if (kK9) accept(Le, v); else ++k;
        }
      }
    }
    if (n > 0) publish_slots(a.ready, slot, n, lane);
    if (e == d) {
#pragma unroll
      for (int x = 0; x < WW; ++x) todo[x] = 0u;
    } else {
      if (lane < WW) level(e)[2 * WW + lane] = 0u;
      __syncwarp();
    }
  }

  // Walks the subtree of the node (cand, fini, R) at absolute level base;
  // its cover (K9) lies on level 0, `live` whether it is not empty.
  __device__ __forceinline__ void walk(int base, unsigned (&cand)[WW],
                                       unsigned (&fini)[WW], bool live) {
    unsigned todo[WW], cc[WW], cf[WW];
    const unsigned zero[WW] = {};
    cy.charge(kWalk, cand[0]);
    reg_pivot(rows, cand, fini, todo, lane);
    cy.node();
    cy.charge(kPivot, todo[WW - 1]);
    int d = 0;
    for (;;) {
      const int v = first_bit(todo);
      if (v < 0) {
        if (d == 0) return;
        --d;
        Level::load(level(d), cand, fini, todo, live);
        continue;
      }
      unsigned m[WW];  // bit v
#pragma unroll
      for (int x = 0; x < WW; ++x) {
        m[x] = bit_word(v, x);
        todo[x] &= ~m[x];
      }
      // the child's cover row, loaded while its row is shuffled
      const unsigned* Tv = kK9 ? T + (long long)v * a.in_words : nullptr;
      unsigned t0 = 0u;
      if (kK9 && live && lane < a.in_words) t0 = __ldg(Tv + lane);
      cy.charge(kWalk, todo[0]);
      child(cand, fini, zero, v, cc, cf);
      cy.step(d + 1 < a.smem_levels);
      cy.charge(kChild, cc[0] | cf[WW - 1]);
#pragma unroll
      for (int x = 0; x < WW; ++x) {
        cand[x] &= ~m[x];
        fini[x] |= m[x];
      }
      const bool search = any_bit(cc);
      if (search || !any_bit(cf)) {
        bool clive = false;
        if (kK9 && live) {
          cy.charge(kWalk, cand[0]);
          clive = cover_and(level(d) + kNode + 1, Tv,
                            search ? level(d + 1) + kNode + 1 : nullptr,
                            a.in_words, lane, true, t0);
          cy.charge(kLeaf, clive);
        }
        if (!search) {
          if (!clive) {
            if (kK9) accept(level(d), v); else ++k;
          }
        } else if (!kK9 && base + d + 1 >= a.depth) {
          // no level left: flag the overflow and abandon the item
          if (lane == 0) atomicExch(&a.ctl->aux, 1ull);
          return;
        } else {
          Level::save(level(d), cand, fini, todo, live, lane);
          if (kK9) Level::extend_r(level(d), level(d + 1), v, lane);
#pragma unroll
          for (int x = 0; x < WW; ++x) {
            cand[x] = cc[x];
            fini[x] = cf[x];
          }
          live = clive;
          ++d;
          cy.charge(kWalk, fini[0]);
          reg_pivot(rows, cand, fini, todo, lane);
          cy.node();
          cy.charge(kPivot, todo[WW - 1]);
        }
      }
      if (++since >= kDonateEvery) {
        since = 0;
        if (!full && hungry(a.ctl, n_root, lane)) {
          cy.charge(kWalk, todo[0]);
          donate(d, base, cand, fini, todo, live);
          cy.charge(kWait, todo[0]);
        }
      }
    }
  }

  __device__ __forceinline__ void run() {
    unsigned long long taken = 0;
    for (;;) {
      const unsigned long long t = next_item(a, n_root, lane);
      if (t == ~0ull) break;
      ++taken;
      cy.charge(kWait);
      unsigned cand[WW], fini[WW];
      unsigned* L0 = level(0);
      int base = 0;
      bool search = false, live = false;
      if (t < n_root) {  // item (b, i) of the root offsets
        take_root((int)item_root(a.roff, a.c, t));
#pragma unroll
        for (int x = 0; x < WW; ++x) {
          cand[x] = __ldg(a.cand0 + b * WW + x);
          fini[x] = a.fini0 ? __ldg(a.fini0 + b * WW + x) : 0u;
        }
        if (!any_bit(cand)) {  // a live root with cand0 = fini0 = 0
          if (!kK9) {
            ++k;
          } else {
            if (lane < WW) L0[3 * WW + lane] = 0u;
            __syncwarp();
            if (!cover_of([](int) { return 0u; }, WW, T, L0 + kNode + 1,
                          a.in_words, lane))
              accept(L0, -1);  // R = 0, no valid lower neighbour
          }
        } else {
          // the root node's child along the i-th bit of its ext
          unsigned ext[WW], done[WW], cc[WW], cf[WW];
#pragma unroll
          for (int x = 0; x < WW; ++x) ext[x] = __ldg(a.rext + b * WW + x);
          int n = (int)(t - (unsigned long long)a.roff[b]), i = -1;
#pragma unroll
          for (int x = 0; x < WW; ++x) {
            const int p = __popc(ext[x]);
            if (i < 0 && n < p) {
              unsigned e = ext[x];
              for (; n > 0; --n) e &= e - 1;
              i = 32 * x + __ffs(e) - 1;
            } else if (i < 0) {
              n -= p;
            }
          }
#pragma unroll
          for (int x = 0; x < WW; ++x) done[x] = ext[x] & below_word(i, x);
          child(cand, fini, done, i, cc, cf);
          cy.charge(kChild);
          search = any_bit(cc);
          if (kK9 && (search || !any_bit(cf))) {
            live = cover_and(T + (long long)W * a.in_words,
                             T + (long long)i * a.in_words,
                             search ? L0 + kNode + 1 : nullptr, a.in_words,
                             lane);
            if (lane < WW) L0[3 * WW + lane] = bit_word(i, lane);
            __syncwarp();
            cy.charge(kLeaf);
          }
          if (search) {
#pragma unroll
            for (int x = 0; x < WW; ++x) {
              cand[x] = cc[x];
              fini[x] = cf[x];
            }
          } else if (!any_bit(cf) && !live) {
            if (kK9) accept(L0, -1); else ++k;
          }
        }
      } else {  // a queued node
        const unsigned* Q = a.queue + (t - n_root) * (size_t)(kQNode + 2);
#pragma unroll
        for (int x = 0; x < WW; ++x) {
          cand[x] = __ldcg(Q + x);
          fini[x] = __ldcg(Q + WW + x);
        }
        take_root((int)__ldcg(Q + kQNode));
        base = (int)__ldcg(Q + kQNode + 1);
        search = true;
        if (kK9) {
          if (lane < WW) L0[3 * WW + lane] = __ldcg(Q + 2 * WW + lane);
          __syncwarp();
          cy.charge(kWait);
          const unsigned* R = L0 + 3 * WW;
          live = cover_of([&](int w) { return R[w]; }, WW, T,
                          L0 + kNode + 1, a.in_words, lane);
          cy.charge(kLeaf);
        }
      }
      if (search) walk(base, cand, fini, live);
      cy.charge(kWalk);
      finish_item(a.ctl, lane);
    }
    cy.charge(kWait);
    if (kStats && lane == 0) {
      atomicAdd(&a.ctl->items, taken);
      atomicMax(&a.ctl->max_items, taken);
    }
    cy.flush(a.ctl->cycles, lane);
    block_sum_add(lane == 0 ? k : 0, a.total);
  }
};

// ---------------------------------------------------------------------------
// the memory walk, any W
// ---------------------------------------------------------------------------

// First set bit of S's ww words, or -1; warp-uniform.
__device__ __forceinline__ int first_set(const unsigned* S, int ww, int lane) {
  for (int wb = 0; wb < ww; wb += 32) {
    const int w = wb + lane;
    const unsigned x = w < ww ? S[w] : 0u;
    const unsigned hit = __ballot_sync(kFull, x != 0u);
    if (hit) {
      const int f = __ffs(hit) - 1;
      const unsigned xf = __shfl_sync(kFull, x, f);
      return 32 * (wb + f) + __ffs(xf) - 1;
    }
  }
  return -1;
}

// Whether any of S's ww words is set; warp-uniform.
__device__ __forceinline__ bool any_set(const unsigned* S, int ww, int lane) {
  unsigned o = 0u;
  for (int w = lane; w < ww; w += 32) o |= S[w];
  return __any_sync(kFull, o != 0u);
}

template <bool kK9, bool kStats>
struct MemWalk {
  const WalkArgs& a;
  int lane, ww, W, node, qnode;
  unsigned* spath;
  unsigned* gpath;
  unsigned* nzi;  // scratch: the nonzero words of a node's cand
  unsigned* nzc;
  unsigned long long n_root;
  Cycles<kStats> cy;
  const unsigned* A;
  const unsigned* T;
  long long b;
  long long k;
  int since;
  bool full;

  __device__ __forceinline__ MemWalk(const WalkArgs& args, unsigned* smem)
      : a(args), A(nullptr), T(nullptr), b(-1), k(0), since(0), full(false) {
    lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    ww = a.ww;
    W = 32 * ww;
    node = (kK9 ? 4 : 3) * ww;
    qnode = (kK9 ? 3 : 2) * ww;
    unsigned* mine =
        smem + (size_t)warp * (a.scratch + a.smem_levels * a.stride);
    nzi = mine;
    nzc = mine + ww;
    spath = mine + a.scratch;
    gpath = a.gpath ? a.gpath + ((size_t)blockIdx.x * kWarps + warp) *
                                    (size_t)(a.levels - a.smem_levels) *
                                    a.stride
                    : nullptr;
    n_root = (unsigned long long)a.roff[a.c];
    cy.init();
  }

  __device__ __forceinline__ unsigned* level(int d) const {
    return d < a.smem_levels
               ? spath + d * a.stride
               : gpath + (size_t)(d - a.smem_levels) * a.stride;
  }

  __device__ __forceinline__ void take_root(long long root) {
    b = root;
    A = a.adj + root * W * ww;
    if (kK9) T = a.cover_t + root * (W + 1) * a.in_words;
  }

  // an accepted leaf R | {v} (v < 0: R), R on level L
  __device__ __forceinline__ void accept(const unsigned* L, int v) {
    const unsigned long long pos = emit_row(a, lane);
    if (pos != ~0ull) {
      unsigned* row = a.out_rows + pos * (ww + 1);
      for (int w = lane; w < ww; w += 32)
        row[w] = L[3 * ww + w] | (v >= 0 ? bit_word(v, w) : 0u);
      if (lane == 0) row[ww] = (unsigned)b;
    }
    ++k;
  }

  // N's todo = cand & ~adj_pivot
  __device__ __forceinline__ void pivot(unsigned* N) {
    if (ww <= 32) {
      pivot_planes<1>(N);
    } else if (ww <= 64) {
      pivot_planes<2>(N);
    } else {
      pivot_sparse(N);
    }
  }

  // W <= 2048: every u's score at once, as bit-sliced counters that add
  // the row of each member of cand (lane x holds words x and x + 32 of
  // every plane; one coalesced row load a member, the next one's in flight,
  // a carry chain of ~2 steps on average), then the first member of cand |
  // fini with the largest score, plane by plane from the top.
  template <int kC>
  __device__ __forceinline__ void pivot_planes(unsigned* N) {
    constexpr int kP = 12;  // scores < 4096
    unsigned pl[kC][kP], cw[kC], nzw[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int w = lane + 32 * j;
      cw[j] = w < ww ? N[w] : 0u;
      nzw[j] = __ballot_sync(kFull, cw[j] != 0u);
#pragma unroll
      for (int k = 0; k < kP; ++k) pl[j][k] = 0u;
    }
    // cand's members in ascending order (warp-uniform)
    int j = 0, q = 0;
    unsigned bits = 0u;
    auto next = [&]() -> int {  // -1 once they are all taken
      while (!bits) {
        while (j < kC && !(j == 0 ? nzw[0] : nzw[kC - 1])) ++j;
        if (j == kC) return -1;
        if (j == 0) {
          q = __ffs(nzw[0]) - 1;
          nzw[0] &= nzw[0] - 1;
        } else {
          q = __ffs(nzw[kC - 1]) - 1;
          nzw[kC - 1] &= nzw[kC - 1] - 1;
        }
        bits = __shfl_sync(kFull, j == 0 ? cw[0] : cw[kC - 1], q);
      }
      const int c = 32 * (32 * j + q) + __ffs(bits) - 1;
      bits &= bits - 1;
      return c;
    };
    auto load = [&](int c, unsigned (&r)[kC]) {
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const int w = lane + 32 * i;
        r[i] = c >= 0 && w < ww ? __ldg(A + (long long)c * ww + w) : 0u;
      }
    };
    // the next member's row in flight while one is added (eight in flight
    // measured slower)
    unsigned r[kC], r2[kC];
    int c = next();
    load(c, r);
    while (c >= 0) {
      const int c2 = next();
      load(c2, r2);
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        unsigned carry = r[i];
#pragma unroll
        for (int k = 0; k < kP; ++k) {
          if (!carry) break;
          const unsigned t = pl[i][k] & carry;
          pl[i][k] ^= carry;
          carry = t;
        }
        r[i] = r2[i];
      }
      c = c2;
    }
    // the members of cand | fini with the largest score
    unsigned mk[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int w = lane + 32 * i;
      mk[i] = w < ww ? N[w] | N[ww + w] : 0u;
    }
#pragma unroll
    for (int k = kP - 1; k >= 0; --k) {
      unsigned t[kC], o = 0u;
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        t[i] = mk[i] & pl[i][k];
        o |= t[i];
      }
      if (__any_sync(kFull, o != 0u)) {
#pragma unroll
        for (int i = 0; i < kC; ++i) mk[i] = t[i];
      }
    }
    int p = 0;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const unsigned h = __ballot_sync(kFull, mk[i] != 0u);
      if (h) {
        const int f = __ffs(h) - 1;
        p = 32 * (32 * i + f) + __ffs(__shfl_sync(kFull, mk[i], f)) - 1;
        break;
      }
    }
    const unsigned* Ap = A + (long long)p * ww;
    for (int w = lane; w < ww; w += 32) N[2 * ww + w] = N[w] & ~__ldg(Ap + w);
    __syncwarp();
  }

  // W > 2048: each member of cand | fini scored, a lane a member, on cand's
  // nonzero words only
  __device__ __forceinline__ void pivot_sparse(unsigned* N) {
    int nz = 0;
    for (int wb = 0; wb < ww; wb += 32) {
      const int w = wb + lane;
      const unsigned cw = w < ww ? N[w] : 0u;
      const unsigned m = __ballot_sync(kFull, cw != 0u);
      if (cw) {
        const int pos = nz + __popc(m & ((1u << lane) - 1u));
        nzi[pos] = (unsigned)w;
        nzc[pos] = cw;
      }
      nz += __popc(m);
    }
    __syncwarp();
    unsigned long long best = 0ull;
    for (int wb = 0; wb < ww; wb += 32) {
      // lane j holds the membership word wb + j of cand | fini
      const unsigned mw =
          wb + lane < ww ? N[wb + lane] | N[ww + wb + lane] : 0u;
      const int n = ww - wb < 32 ? ww - wb : 32;
      for (int j = 0; j < n; ++j) {
        const unsigned mem = __shfl_sync(kFull, mw, j);
        if (!((mem >> lane) & 1u)) continue;
        const int u = 32 * (wb + j) + lane;
        const unsigned* Au = A + (long long)u * ww;
        int s = 0;
#pragma unroll 4
        for (int t = 0; t < nz; ++t) s += __popc(nzc[t] & __ldg(Au + nzi[t]));
        const unsigned long long key = pivot_key(s, u);
        if (key > best) best = key;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long other = __shfl_xor_sync(kFull, best, o);
      if (other > best) best = other;
    }
    const unsigned* Ap = A + (long long)key_vertex(best) * ww;
    for (int w = lane; w < ww; w += 32) N[2 * ww + w] = N[w] & ~__ldg(Ap + w);
    __syncwarp();
  }

  // the child of L along v, `done` the unexplored children below v moved
  // (L's todo below v when donating, none in the walk), into dst's cand and
  // fini (R not set); returns 2 if cand' != 0, 1 if a leaf, 0 if dead
  __device__ __forceinline__ int child(unsigned* dst, const unsigned* L,
                                       bool donating, int v) {
    const unsigned* Av = A + (long long)v * ww;
    unsigned nc = 0u, nf = 0u;
    for (int w = lane; w < ww; w += 32) {
      const unsigned av = __ldg(Av + w);
      const unsigned dn = donating ? L[2 * ww + w] & below_word(v, w) : 0u;
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

  // Moves the unexplored children of the shallowest open level to the
  // queue, if it has room; counts those that are leaves; closes the level.
  // The children are formed in level d + 1 (free: the walk forms its next
  // child there anew).
  __device__ __forceinline__ void donate(int d, int base) {
    int e = 0;
    for (; e <= d; ++e)
      if (any_set(level(e) + 2 * ww, ww, lane)) break;
    if (e > d || (!kK9 && base + e + 1 >= a.depth)) return;
    unsigned* L = level(e);
    unsigned* tmp = level(d + 1);
    int n = 0;
    for (int v = first_set(L + 2 * ww, ww, lane); v >= 0;) {
      n += child(tmp, L, true, v) == 2;
      v = next_bit(L + 2 * ww, ww, v + 1, lane);
      v = v < W ? v : -1;
    }
    unsigned long long slot = 0;
    if (n > 0) {
      slot = reserve_slots(a.ctl, n, a.cap, lane);
      if (slot == ~0ull) {
        full = true;
        return;
      }
    }
    const bool elive = kK9 && L[node] != 0u;
    int q = 0;
    for (int v = first_set(L + 2 * ww, ww, lane); v >= 0;) {
      const int kind = child(tmp, L, true, v);
      if (kind == 2) {
        unsigned* dst = a.queue + (slot + q++) * (size_t)(qnode + 2);
        for (int w = lane; w < 2 * ww; w += 32) __stcg(dst + w, tmp[w]);
        if (kK9)
          for (int w = lane; w < ww; w += 32)
            __stcg(dst + 2 * ww + w, L[3 * ww + w] | bit_word(v, w));
        if (lane == 0) {
          __stcg(dst + qnode, (unsigned)b);
          __stcg(dst + qnode + 1, (unsigned)(base + e + 1));
        }
      } else if (kind == 1) {
        const bool covered =
            kK9 && elive &&
            cover_and(L + node + 1, T + (long long)v * a.in_words, nullptr,
                      a.in_words, lane);
        if (!covered) {
          if (kK9) accept(L, v); else ++k;
        }
      }
      v = next_bit(L + 2 * ww, ww, v + 1, lane);
      v = v < W ? v : -1;
    }
    if (n > 0) publish_slots(a.ready, slot, n, lane);
    for (int w = lane; w < ww; w += 32) L[2 * ww + w] = 0u;
    __syncwarp();
  }

  // Walks the subtree of level 0's node (cand, fini, R, C set) at absolute
  // level base.
  __device__ __forceinline__ void walk(int base) {
    cy.charge(kWalk);
    pivot(level(0));
    cy.node();
    cy.charge(kPivot);
    int d = 0;
    for (;;) {
      unsigned* L = level(d);
      const int v = first_set(L + 2 * ww, ww, lane);
      if (v < 0) {
        if (d == 0) return;
        --d;
        continue;
      }
      unsigned* N = level(d + 1);
      cy.charge(kWalk);
      const int kind = child(N, L, false, v);
      cy.step(d + 1 < a.smem_levels);
      cy.charge(kChild, kind);
      for (int w = lane; w < ww; w += 32) {  // v moves from cand to fini
        if (w == (v >> 5)) {
          const unsigned bit = 1u << (v & 31);
          L[w] &= ~bit;
          L[ww + w] |= bit;
          L[2 * ww + w] &= ~bit;
        }
      }
      __syncwarp();
      if (kind != 0) {
        bool clive = false;
        if (kK9 && L[node] != 0u) {
          cy.charge(kWalk);
          clive = cover_and(L + node + 1, T + (long long)v * a.in_words,
                            kind == 2 ? N + node + 1 : nullptr, a.in_words,
                            lane);
          cy.charge(kLeaf, clive);
        }
        if (kind == 1) {
          if (!clive) {
            if (kK9) accept(L, v); else ++k;
          }
        } else if (!kK9 && base + d + 1 >= a.depth) {
          if (lane == 0) atomicExch(&a.ctl->aux, 1ull);
          return;
        } else {
          if (kK9) {
            for (int w = lane; w < ww; w += 32)
              N[3 * ww + w] = L[3 * ww + w] | bit_word(v, w);
            if (lane == 0) N[node] = clive ? 1u : 0u;
          }
          __syncwarp();
          ++d;
          cy.charge(kWalk);
          pivot(N);
          cy.node();
          cy.charge(kPivot);
        }
      }
      if (++since >= kDonateEvery) {
        since = 0;
        if (!full && hungry(a.ctl, n_root, lane)) {
          cy.charge(kWalk);
          donate(d, base);
          cy.charge(kWait);
        }
      }
    }
  }

  __device__ __forceinline__ void run() {
    unsigned long long taken = 0;
    for (;;) {
      const unsigned long long t = next_item(a, n_root, lane);
      if (t == ~0ull) break;
      ++taken;
      cy.charge(kWait);
      unsigned* L0 = level(0);
      int base = 0;
      bool search = false;
      if (t < n_root) {  // item (b, i) of the root offsets
        take_root(item_root(a.roff, a.c, t));
        const unsigned* C0 = a.cand0 + b * ww;
        if (!any_set(C0, ww, lane)) {  // a live root with cand0 = fini0 = 0
          if (!kK9) {
            ++k;
          } else {
            for (int w = lane; w < ww; w += 32) L0[3 * ww + w] = 0u;
            __syncwarp();
            if (!cover_of([](int) { return 0u; }, ww, T, L0 + node + 1,
                          a.in_words, lane))
              accept(L0, -1);
          }
        } else {
          // the root node (cand0, fini0) in level 1, with its todo the
          // ext bits from i on, and its child along i in level 0
          const unsigned* E = a.rext + b * ww;
          const int i = nth_bit(E, ww, (int)(t - (unsigned long long)a.roff[b]));
          unsigned* P = level(1);
          for (int w = lane; w < ww; w += 32) {
            P[w] = C0[w];
            P[ww + w] = a.fini0 ? a.fini0[b * ww + w] : 0u;
            P[2 * ww + w] = E[w];
            if (kK9) {
              P[3 * ww + w] = 0u;
              L0[3 * ww + w] = bit_word(i, w);
            }
          }
          __syncwarp();
          const int kind = child(L0, P, true, i);
          cy.charge(kChild);
          bool live = false;
          if (kK9 && kind != 0) {
            live = cover_and(T + (long long)W * a.in_words,
                             T + (long long)i * a.in_words,
                             kind == 2 ? L0 + node + 1 : nullptr, a.in_words,
                             lane);
            if (lane == 0) L0[node] = live ? 1u : 0u;
            __syncwarp();
            cy.charge(kLeaf);
          }
          search = kind == 2;
          if (kind == 1 && !live) {
            if (kK9) accept(L0, -1); else ++k;
          }
        }
      } else {  // a queued node
        const unsigned* Q = a.queue + (t - n_root) * (size_t)(qnode + 2);
        for (int w = lane; w < qnode; w += 32) L0[w < 2 * ww ? w : w + ww] =
            __ldcg(Q + w);
        take_root((long long)__ldcg(Q + qnode));
        base = (int)__ldcg(Q + qnode + 1);
        __syncwarp();
        search = true;
        if (kK9) {
          cy.charge(kWait);
          const unsigned* R = L0 + 3 * ww;
          const bool live = cover_of([&](int w) { return R[w]; }, ww, T,
                                     L0 + node + 1, a.in_words, lane);
          if (lane == 0) L0[node] = live ? 1u : 0u;
          __syncwarp();
          cy.charge(kLeaf);
        }
      }
      if (search) walk(base);
      cy.charge(kWalk);
      finish_item(a.ctl, lane);
    }
    cy.charge(kWait);
    if (kStats && lane == 0) {
      atomicAdd(&a.ctl->items, taken);
      atomicMax(&a.ctl->max_items, taken);
    }
    cy.flush(a.ctl->cycles, lane);
    block_sum_add(lane == 0 ? k : 0, a.total);
  }
};

// The walk of one warp: the register walk for WW = 1..4, else (WW = 0) the
// memory walk at a.ww.
template <int WW, bool kK9, bool kStats>
__device__ __forceinline__ void walk_warps(const WalkArgs& a) {
  extern __shared__ unsigned smem[];
  if constexpr (WW > 0) {
    RegWalk<WW, kK9, kStats> w(a, smem);
    w.run();
  } else {
    MemWalk<kK9, kStats> w(a, smem);
    w.run();
  }
}

// ---------------------------------------------------------------------------
// the launch
// ---------------------------------------------------------------------------

// Path levels a.levels of a.stride words, scratch a.scratch words a warp:
// the levels that fit kSmemWarpWords lie in shared memory, the rest in
// device memory taken from the stream's pool for this launch. The grid is
// the blocks that can be resident at once (waiting warps never hold back a
// block that has work). Launches init (the unfinished items, the warps)
// and the walk.
inline cudaError_t launch_walk(void (*kernel)(WalkArgs),
                               void (*init)(const long long*, long long, Ctl*,
                                            long long),
                               WalkArgs a, cudaStream_t st) {
  int fit = (kSmemWarpWords - a.scratch) / a.stride;
  if (fit < 0) fit = 0;
  if (fit > a.levels) fit = a.levels;
  a.smem_levels = fit;
  const size_t smem =
      (size_t)kWarps * (a.scratch + (size_t)fit * a.stride) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  a.gpath = nullptr;
  if (fit < a.levels) {
    const size_t block_bytes = (size_t)kWarps * (a.levels - fit) *
                               (size_t)a.stride * sizeof(unsigned);
    const long long most = (long long)(kPathScratch / block_bytes);
    if (blocks > most) blocks = most > 0 ? most : 1;
    e = cudaMallocAsync((void**)&a.gpath, (size_t)blocks * block_bytes, st);
    if (e != cudaSuccess) return e;
  }
  init<<<1, 1, 0, st>>>(a.roff, a.c, a.ctl, blocks * kWarps);
  kernel<<<(unsigned)blocks, kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (a.gpath) {
    const cudaError_t f = cudaFreeAsync(a.gpath, st);
    if (e == cudaSuccess) e = f;
  }
  return e;
}

}  // namespace
