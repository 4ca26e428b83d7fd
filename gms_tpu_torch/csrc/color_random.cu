// K24 color_random: the randomized coloring rounds.
//
//   johansson        — gms_tpu/algorithms/coloring.py `_johansson_round_tiered`
//                      (:127): an uncolored row picks draws[v] mod deg1[v]
//                      (a color in [0, deg v]) and keeps it unless a
//                      neighbour holds it or picked it (a neighbour's pick is
//                      its color when colored, else its own draw mod deg1);
//   one_shot pick    — `_one_shot_round` (:404), the pick: nfree = the colors
//                      of the palette [0, L) (L = deg1[v] for Elkin, delta + 1
//                      for Barenboim) absent from the committed neighbours'
//                      colors, r = jax's randint of the row's two 64-bit
//                      words into [0, max(nfree, 1)), pick = the r-th free
//                      color (0 when nfree is 0); a colored row's pick is
//                      its color and its nfree 0;
//   one_shot resolve — its conflict rule: an uncolored row keeps its pick
//                      when nfree > 0 and no uncolored neighbour of higher
//                      id picked the same color (coloring_barenboim.h:44-47).
// The draws are an input, so the kernel and its plain version give the same
// colors on the same draws: Johansson's are gms_tpu's picks (non-negative
// int32, already below deg1); the one-shot's are jax.random's two 64-bit
// words a vertex (draws[v] and draws[n1 + v]), which jax_randint reduces as
// jax's `_randint` does (gms_tpu's int64 randint with x64 on) once the row's
// span, max(nfree, 1), is known. Every pass reads the round-start colors
// (and picks) and writes a fresh buffer, so neither the order of rows nor
// that of buckets within a pass matters.
//
// Two kinds of entry:
//  * johansson_round, one_shot_round: a whole round over every bucket of
//    the table (ids pointer, nbrt pointer, Vt, Dt), as color_spec_run takes
//    it: Johansson two launches (each vertex's pick word, then the round),
//    the one-shot two (the pick pass, then the resolve pass) (johansson_round
//    and one_shot_round in coloring.py, which the entry points run);
//  * johansson, one_shot_pick, one_shot_resolve: one bucket, a warp a row
//    (johansson_bucket, one_shot_pick, one_shot_resolve in coloring.py; no
//    entry point runs them).
//
// round_kernel splits the work by width. A row of more than kWideRow
// entries (the first rounds' tail: the few rows of the widest buckets,
// thousands of entries each) takes a whole block, one block a row: the
// blocks [0, n_wide) of the grid; its test is a block-wide OR, its palette
// counted and selected block-wide. The rest of the grid's warps stride over
// one flat index of every narrow bucket's rows, the buckets in descending
// width: in Johansson's pass and the resolve a warp takes kGroupRows rows of
// the 32-wide bucket at once (most rows of an RMAT graph, average degree
// 16), a group of kGroupLanes lanes a row; a wider row takes the warp,
// which loads its next row's id and first 32 entries while it decides the
// current one, kRowUnroll chunks of 32 entries at a time, their neighbours'
// words gathered together. A row whose vertex is colored (or, in the
// resolve, has no free color) and a row that loses write nothing: the
// caller's outputs start as the round-start colors. Johansson's neighbour
// pick is one word, written for every vertex by a pass of its own; the
// resolve gathers only the entries above the row's id. The one-shot pick
// of a row of at most 32 entries sorts the row's used colors across the
// warp and takes the r-th free color from their ranks, where the used-color
// mask would clear, count and scan the whole palette (Barenboim: delta + 1
// colors for every row); a wider row marks a mask of ceil(L / 32) words in
// shared memory (csrc/color_pick.cuh).
//
// Bound on an H100 (3.35 TB/s): bytes — each row up to the entry that
// decides it, each neighbour's state words that the function needs there,
// the ids and the writes.

#include <cuda_runtime.h>

#include "color_pick.cuh"

namespace {

constexpr int kThreads = 512;      // round_kernel's block, at most
constexpr int kWideRow = 1024;     // wider rows take a block
constexpr int kMaxBuckets = 64;    // buckets a round takes
constexpr int kRowUnroll = 4;      // 32-entry chunks of a row in flight
constexpr int kRowsPerWarp = 4;    // narrow rows a warp (the grid's size)
constexpr int kSortRow = 32;       // the sorted pick's widest bucket (a warp)
constexpr int kMaxSmem = 227 * 1024;
constexpr int kNoColor = 0x7fffffff;
// The rows of a narrow bucket of width at most kGroupDt that a warp takes
// together in Johansson's pass and the resolve, a group of kGroupLanes
// lanes a row, so that a row of a few entries (most rows of an RMAT graph)
// does not hold a whole warp.
constexpr int kGroupDt = 32;
constexpr int kGroupLanes = 8;
constexpr int kGroupRows = 32 / kGroupLanes;

// jax.random.randint's reduction of two 64-bit words into [0, span), span
// below 2^31: ((higher % span) * ((2^32 % span)^2 % span) + lower % span) %
// span, exact in 64 bits.
__device__ __forceinline__ int jax_randint(unsigned long long higher,
                                           unsigned long long lower,
                                           int span) {
  const unsigned long long s = (unsigned long long)span;
  const unsigned long long m = (1ull << 32) % s;
  const unsigned long long mult = (m * m) % s;
  return (int)(((higher % s) * mult + lower % s) % s);
}

// ---------------------------------------------------------------------------
// one bucket a launch, a warp a row
// ---------------------------------------------------------------------------

__global__ void johansson_kernel(const int* __restrict__ ids,
                                 const int* __restrict__ nbrt, long long Vt,
                                 int Dt, const int* __restrict__ colors,
                                 const int* __restrict__ deg1,
                                 const int* __restrict__ draws,
                                 int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (r >= Vt) return;
  const int id = ids[r];
  const int vcol = colors[id];
  if (vcol != -1) {
    if (lane == 0) out[id] = vcol;
    return;
  }
  const int vpick = draws[id] % deg1[id];
  const int* row = nbrt + r * Dt;
  bool clash = false;
  for (int j = lane; j < Dt && !clash; j += 32) {
    const int w = row[j];
    if (w == color::kSentinel) break;
    const int c = colors[w];
    clash = (c == -1 ? draws[w] % deg1[w] : c) == vpick;
  }
  const bool any = __any_sync(color::kFull, clash);
  if (lane == 0) out[id] = any ? -1 : vpick;
}

__global__ void one_shot_pick_kernel(const int* __restrict__ ids,
                                     const int* __restrict__ nbrt,
                                     long long Vt, int Dt,
                                     const int* __restrict__ colors,
                                     const int* __restrict__ deg1,
                                     const unsigned long long* __restrict__ draws,
                                     long long n1, int palette_deg,
                                     int delta, int cw,
                                     int wpb, int* __restrict__ pick,
                                     int* __restrict__ nfree) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * wpb + warp;
  if (r >= Vt) return;
  const int id = ids[r];
  const int vcol = colors[id];
  if (vcol != -1) {
    if (lane == 0) {
      pick[id] = vcol;
      nfree[id] = 0;
    }
    return;
  }
  const int limit = palette_deg ? deg1[id] : delta + 1;
  unsigned* mask = smem + (long long)warp * cw;
  color::mask_clear(mask, cw, lane);
  const int* row = nbrt + r * Dt;
  for (int j = lane; j < Dt; j += 32) {
    const int w = row[j];
    if (w == color::kSentinel) break;
    color::mask_mark(mask, colors[w], limit);
  }
  __syncwarp();
  const int nf = color::free_count(mask, cw, limit, lane);
  int p = 0;
  if (nf > 0) {
    p = color::kth_free(mask, cw, limit,
                        jax_randint(draws[id], draws[n1 + id], nf), lane);
  }
  if (lane == 0) {
    pick[id] = p;
    nfree[id] = nf;
  }
}

__global__ void one_shot_resolve_kernel(const int* __restrict__ ids,
                                        const int* __restrict__ nbrt,
                                        long long Vt, int Dt,
                                        const int* __restrict__ colors,
                                        const int* __restrict__ pick,
                                        const int* __restrict__ nfree,
                                        int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (r >= Vt) return;
  const int id = ids[r];
  const int vcol = colors[id];
  if (vcol != -1) {
    if (lane == 0) out[id] = vcol;
    return;
  }
  const int vpick = pick[id];
  const int* row = nbrt + r * Dt;
  bool lose = false;
  for (int j = lane; j < Dt && !lose; j += 32) {
    const int w = row[j];
    if (w == color::kSentinel) break;
    lose = w > id && colors[w] == -1 && pick[w] == vpick;
  }
  const bool any = __any_sync(color::kFull, lose);
  if (lane == 0) out[id] = (nfree[id] > 0 && !any) ? vpick : -1;
}

// ---------------------------------------------------------------------------
// a round over every bucket
// ---------------------------------------------------------------------------

// A bucket of the round, cached in shared memory by every block: start is
// its first row's flat index among the rows of its kind (wide: Dt >
// kWideRow; narrow: the rest), the buckets of a kind in descending width.
struct Bucket {
  const int* ids;
  const int* nbrt;
  long long vt, start, units;   // units: ceil(vt / per)
  int dt, per;                  // per: rows a unit of the flat index
};

__device__ __forceinline__ bool is_wide(int dt) { return dt > kWideRow; }

// tab: a bucket a row of 4 int64 (ids, nbrt, Vt, Dt), nb <= kMaxBuckets.
// A unit of a narrow bucket no wider than kGroupDt holds `group_rows` rows
// (one for a wide bucket or a wider one).
__device__ __forceinline__ void load_buckets(const long long* tab, int nb,
                                             Bucket* bk, int group_rows) {
  if (threadIdx.x < nb) {
    const long long* e = tab + 4 * threadIdx.x;
    const int dt = (int)e[3];
    const int per = dt <= kGroupDt ? group_rows : 1;
    bk[threadIdx.x] = {reinterpret_cast<const int*>(e[0]),
                       reinterpret_cast<const int*>(e[1]), e[2], 0,
                       (e[2] + per - 1) / per, dt, per};
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long wide = 0, narrow = 0;
    for (int t = nb - 1; t >= 0; --t) {
      long long& s = is_wide(bk[t].dt) ? wide : narrow;
      bk[t].start = s;
      s += bk[t].units;
    }
  }
  __syncthreads();
}

// The bucket of flat index i among the units of one kind, searched from
// bucket t down (i only grows along a caller's walk); -1 past the last.
__device__ __forceinline__ int find_bucket(const Bucket* bk, int t,
                                           long long i, bool wide) {
  while (t >= 0 && (is_wide(bk[t].dt) != wide ||
                    i >= bk[t].start + bk[t].units))
    --t;
  return t;
}

// A row's id and its first 32 entries (lane-wise), loaded ahead.
struct RowHead {
  int id, w;
  __device__ __forceinline__ void load(const Bucket& b, long long r,
                                       int lane) {
    id = b.ids[r];
    w = lane < b.dt ? b.nbrt[r * b.dt + lane] : color::kSentinel;
  }
};

// One warp's walk of a row (its first 32 entries w0, lane-wise): kRowUnroll
// chunks of 32 load at a time, get(w) gathers each entry's words for the
// chunks together, then use(w, got) says whether the entry is a hit. The
// walk ends at the row's first SENTINEL, or (kEarly) after the step that
// holds a hit. Returns whether any entry was a hit; all lanes alike.
template <bool kEarly, class Get, class Use>
__device__ __forceinline__ bool warp_row(int w0, const int* row, int Dt,
                                         int lane, const Get& get,
                                         const Use& use) {
  bool hit = false;
  for (int base = 0; base < Dt; base += 32 * kRowUnroll) {
    int w[kRowUnroll];
#pragma unroll
    for (int q = 0; q < kRowUnroll; ++q) {
      const int j = base + 32 * q + lane;
      w[q] = base == 0 && q == 0 ? w0
                                 : (j < Dt ? row[j] : color::kSentinel);
    }
    decltype(get(0)) v[kRowUnroll];
    bool end = false;
#pragma unroll
    for (int q = 0; q < kRowUnroll; ++q) {
      const bool ok = w[q] != color::kSentinel;
      if (ok) v[q] = get(w[q]);
      end |= !ok;
    }
#pragma unroll
    for (int q = 0; q < kRowUnroll; ++q)
      if (w[q] != color::kSentinel) hit |= use(w[q], v[q]);
    if (__any_sync(color::kFull, (kEarly && hit) || end)) break;
  }
  return __any_sync(color::kFull, hit);
}

// warp_row for the whole block: blockDim entries a chunk; every thread
// returns the answer.
template <bool kEarly, class Get, class Use>
__device__ __forceinline__ bool block_row(const int* row, int Dt,
                                          const Get& get, const Use& use) {
  bool hit = false;
  for (int base = 0; base < Dt; base += blockDim.x * kRowUnroll) {
    int w[kRowUnroll];
#pragma unroll
    for (int q = 0; q < kRowUnroll; ++q) {
      const int j = base + q * blockDim.x + threadIdx.x;
      w[q] = j < Dt ? row[j] : color::kSentinel;
    }
    decltype(get(0)) v[kRowUnroll];
    bool end = false;
#pragma unroll
    for (int q = 0; q < kRowUnroll; ++q) {
      const bool ok = w[q] != color::kSentinel;
      if (ok) v[q] = get(w[q]);
      end |= !ok;
    }
#pragma unroll
    for (int q = 0; q < kRowUnroll; ++q)
      if (w[q] != color::kSentinel) hit |= use(w[q], v[q]);
    if (__syncthreads_or((kEarly && hit) || end)) break;
  }
  return __syncthreads_or(hit);
}

// Johansson's row: out[id] = the pick unless a neighbour holds or picked
// it. A row is open while its vertex is uncolored; the caller's out holds
// the round-start colors, so a closed row, or one that loses (-1), writes
// nothing. warp: a warp a row; group: kGroupLanes lanes a row of at most
// kGroupDt entries; block: the block a row. A vertex's pick is its word of
// pw, written by pick_words_kernel before the pass (one gather a neighbour
// where colors, draws and deg1 would take three and a modulo).
struct JohanssonRow {
  static constexpr int kRowsPerGroupWarp = kGroupRows;
  const int* __restrict__ colors;
  const int* __restrict__ pw;
  int* __restrict__ out;

  // a vertex's pick: its color, else its draw mod deg1
  __device__ __forceinline__ int pick(int v) const { return pw[v]; }

  __device__ __forceinline__ bool open(int id) const {
    return colors[id] == -1;
  }

  __device__ __forceinline__ void warp(const RowHead& h, const int* row,
                                       int Dt, unsigned*, int lane) const {
    const int vcol = colors[h.id], vpick = pick(h.id);
    if (vcol != -1) return;
    const bool clash = warp_row<true>(
        h.w, row, Dt, lane, [&](int w) { return pick(w); },
        [&](int, int p) { return p == vpick; });
    if (!clash && lane == 0) out[h.id] = vpick;
  }

  __device__ __forceinline__ void group(const Bucket& b, long long r,
                                        int gl, unsigned gmask) const {
    const int id = r < b.vt ? b.ids[r] : -1;
    const int vcol = id >= 0 ? colors[id] : 0;
    const int own = id >= 0 ? pick(id) : 0;
    const bool live = vcol == -1;
    const int vpick = live ? own : -2;   // picks are >= 0
    const int* row = b.nbrt + r * b.dt;
    int w[kGroupDt / kGroupLanes];
#pragma unroll
    for (int k = 0; k < kGroupDt / kGroupLanes; ++k) {
      const int j = gl + kGroupLanes * k;
      w[k] = live && j < b.dt ? row[j] : color::kSentinel;
    }
    bool clash = false;
#pragma unroll
    for (int k = 0; k < kGroupDt / kGroupLanes; ++k)
      if (w[k] != color::kSentinel) clash |= pick(w[k]) == vpick;
    const bool any = (__ballot_sync(color::kFull, clash) & gmask) != 0;
    if (live && !any && gl == 0) out[id] = vpick;
  }

  __device__ __forceinline__ void block(int id, const int* row, int Dt,
                                        unsigned*) const {
    if (!open(id)) return;   // block-uniform
    const int vpick = pick(id);
    const bool clash = block_row<true>(
        row, Dt, [&](int w) { return pick(w); },
        [&](int, int p) { return p == vpick; });
    if (!clash && threadIdx.x == 0) out[id] = vpick;
  }
};

// Johansson's pick words: pw[v] = colors[v], else draws[v] mod deg1[v].
__global__ void pick_words_kernel(const int* __restrict__ colors,
                                  const int* __restrict__ deg1,
                                  const int* __restrict__ draws, long long n1,
                                  int* __restrict__ pw) {
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < n1; v += (long long)gridDim.x * blockDim.x) {
    const int c = colors[v], d = draws[v], m = deg1[v];
    pw[v] = c == -1 ? d % m : c;
  }
}

// The one-shot pick of a row of at most 32 entries (one a lane, c its
// committed color or -1) by ranks: the distinct used colors below `limit`
// sorted across the warp, nf = limit less their count, and the r-th free
// color r + #{i : s_i - i <= r} (s_i the i-th smallest). All lanes alike.
__device__ __forceinline__ void sorted_pick(int c, int limit,
                                            unsigned long long hi,
                                            unsigned long long lo, int lane,
                                            int* nf, int* pick) {
  int v = c >= 0 && c < limit ? c : kNoColor;
  // bitonic sort across the warp, ascending
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int o = __shfl_xor_sync(color::kFull, v, j);
      const bool up = (lane & k) == 0, low = (lane & j) == 0;
      v = low == up ? min(v, o) : max(v, o);
    }
  }
  const int prev = __shfl_up_sync(color::kFull, v, 1);
  const bool first = v != kNoColor && (lane == 0 || v != prev);
  const unsigned distinct = __ballot_sync(color::kFull, first);
  *nf = limit - __popc(distinct);
  *pick = 0;
  if (*nf > 0) {
    const int r = jax_randint(hi, lo, *nf);
    const int rank = __popc(distinct & ((1u << lane) - 1u));
    *pick = r + __popc(__ballot_sync(color::kFull, first && v - rank <= r));
  }
}

// The one-shot pick's row (open: uncolored; the caller's pick holds the
// round-start colors and nfree zeros, a closed row's outputs), a warp or
// the block: pick[id], nfree[id].
struct PickRow {
  static constexpr int kRowsPerGroupWarp = 1;
  const int* __restrict__ colors;
  const int* __restrict__ deg1;
  const unsigned long long* __restrict__ draws;
  long long n1;
  int palette_deg, delta;
  int* __restrict__ pick;
  int* __restrict__ nfree;

  __device__ __forceinline__ int limit(int id) const {
    return palette_deg ? deg1[id] : delta + 1;
  }

  __device__ __forceinline__ bool open(int id) const {
    return colors[id] == -1;
  }

  __device__ __forceinline__ void warp(const RowHead& h, const int* row,
                                       int Dt, unsigned* mask,
                                       int lane) const {
    const int id = h.id;
    const int vcol = colors[id], lim = limit(id);
    const unsigned long long hi = draws[id], lo = draws[n1 + id];
    if (vcol != -1) return;
    int nf, p;
    if (Dt <= kSortRow) {
      sorted_pick(h.w != color::kSentinel ? colors[h.w] : -1, lim, hi, lo,
                  lane, &nf, &p);
    } else {
      const int cw = (lim + 31) >> 5;
      __syncwarp();   // the last row's scan is done with the mask
      color::mask_clear(mask, cw, lane);
      warp_row<false>(
          h.w, row, Dt, lane, [&](int w) { return colors[w]; },
          [&](int, int c) {
            color::mask_mark(mask, c, lim);
            return false;
          });
      __syncwarp();
      nf = color::free_count(mask, cw, lim, lane);
      p = nf > 0 ? color::kth_free(mask, cw, lim, jax_randint(hi, lo, nf),
                                   lane)
                 : 0;
    }
    if (lane == 0) {
      pick[id] = p;
      nfree[id] = nf;
    }
  }

  __device__ __forceinline__ void block(int id, const int* row, int Dt,
                                        unsigned* mask) const {
    if (!open(id)) return;   // block-uniform
    const unsigned long long hi = draws[id], lo = draws[n1 + id];
    const int lim = limit(id);
    const int cw = (lim + 31) >> 5;
    for (int i = threadIdx.x; i < cw; i += blockDim.x) mask[i] = 0u;
    __syncthreads();
    block_row<false>(
        row, Dt, [&](int w) { return colors[w]; },
        [&](int, int c) {
          color::mask_mark(mask, c, lim);
          return false;
        });
    const int nf = color::block_free_count(mask, cw, lim);
    const int p = nf > 0 ? color::block_kth_free(mask, cw, lim,
                                                 jax_randint(hi, lo, nf))
                         : 0;
    if (threadIdx.x == 0) {
      pick[id] = p;
      nfree[id] = nf;
    }
  }
};

// The one-shot resolve's row: out[id] = the pick when no uncolored
// neighbour of higher id picked it. Open: uncolored with nfree > 0; the
// caller's out holds the round-start colors, so a closed row, or one that
// loses (-1), writes nothing. Only the entries above id are gathered. A
// warp, a group (as JohanssonRow's) or the block a row.
struct ResolveRow {
  static constexpr int kRowsPerGroupWarp = kGroupRows;
  const int* __restrict__ colors;
  const int* __restrict__ pick;
  const int* __restrict__ nfree;
  int* __restrict__ out;

  __device__ __forceinline__ bool open(int id) const {
    return colors[id] == -1 && nfree[id] > 0;
  }

  // whether neighbour w > id, uncolored, picked vpick
  __device__ __forceinline__ bool rival(int w, int id, int vpick) const {
    return w > id && colors[w] == -1 && pick[w] == vpick;
  }

  __device__ __forceinline__ void warp(const RowHead& h, const int* row,
                                       int Dt, unsigned*, int lane) const {
    const int id = h.id, vcol = colors[id], vpick = pick[id], nf = nfree[id];
    if (vcol != -1 || nf == 0) return;
    const bool lose = warp_row<true>(
        h.w, row, Dt, lane,
        [&](int w) {
          return w > id ? make_int2(colors[w], pick[w]) : make_int2(0, 0);
        },
        [&](int w, int2 s) { return w > id && s.x == -1 && s.y == vpick; });
    if (!lose && lane == 0) out[id] = vpick;
  }

  __device__ __forceinline__ void group(const Bucket& b, long long r,
                                        int gl, unsigned gmask) const {
    const int id = r < b.vt ? b.ids[r] : -1;
    const int vcol = id >= 0 ? colors[id] : 0, nf = id >= 0 ? nfree[id] : 0;
    const int own = id >= 0 ? pick[id] : 0;
    const bool live = vcol == -1 && nf > 0;
    const int vpick = live ? own : -1;
    const int* row = b.nbrt + r * b.dt;
    int w[kGroupDt / kGroupLanes];
#pragma unroll
    for (int k = 0; k < kGroupDt / kGroupLanes; ++k) {
      const int j = gl + kGroupLanes * k;
      w[k] = live && j < b.dt ? row[j] : color::kSentinel;
    }
    bool lose = false;
#pragma unroll
    for (int k = 0; k < kGroupDt / kGroupLanes; ++k)
      if (w[k] != color::kSentinel) lose |= rival(w[k], id, vpick);
    const bool any = (__ballot_sync(color::kFull, lose) & gmask) != 0;
    if (live && !any && gl == 0) out[id] = vpick;
  }

  __device__ __forceinline__ void block(int id, const int* row, int Dt,
                                        unsigned*) const {
    if (!open(id)) return;   // block-uniform
    const int vpick = pick[id];
    const bool lose = block_row<true>(
        row, Dt,
        [&](int w) {
          return w > id ? make_int2(colors[w], pick[w]) : make_int2(0, 0);
        },
        [&](int w, int2 s) { return w > id && s.x == -1 && s.y == vpick; });
    if (!lose && threadIdx.x == 0) out[id] = vpick;
  }
};

// One pass of a round over every bucket: blocks [0, n_wide) a wide row
// each; the rest of the grid's warps (wpb a block) the narrow rows,
// grid-stride over one flat index of units: kRowsPerGroupWarp rows of a
// bucket no wider than kGroupDt (a lane group each), else one row (the
// warp; its next row's head loaded while it decides this one). Only open
// rows are decided. mask: cw words a warp, or the wide row's palette
// words, in dynamic shared memory.
template <class Row>
__global__ void __launch_bounds__(kThreads)
    round_kernel(const long long* __restrict__ tab, int nb, long long n_wide,
                 int wpb, int cw, Row fn) {
  extern __shared__ unsigned smem[];
  __shared__ Bucket bk[kMaxBuckets];
  load_buckets(tab, nb, bk, Row::kRowsPerGroupWarp);
  if (blockIdx.x < n_wide) {
    const int t = find_bucket(bk, nb - 1, blockIdx.x, true);
    const long long r = blockIdx.x - bk[t].start;
    fn.block(bk[t].ids[r], bk[t].nbrt + r * bk[t].dt, bk[t].dt, smem);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nwarps = (gridDim.x - n_wide) * (long long)wpb;
  long long i = (blockIdx.x - n_wide) * (long long)wpb + warp;
  unsigned* mask = smem + warp * cw;
  int t = find_bucket(bk, nb - 1, i, false);
  RowHead next;
  if (t >= 0 && bk[t].per == 1) next.load(bk[t], i - bk[t].start, lane);
  while (t >= 0) {
    const Bucket& b = bk[t];
    const long long u = i - b.start;
    i += nwarps;
    t = find_bucket(bk, t, i, false);
    const RowHead head = next;
    if (t >= 0 && bk[t].per == 1) next.load(bk[t], i - bk[t].start, lane);
    if constexpr (Row::kRowsPerGroupWarp > 1) {
      if (b.per > 1) {
        const int g = lane / kGroupLanes;
        fn.group(b, u * b.per + g, lane % kGroupLanes,
                 (unsigned)((1ull << kGroupLanes) - 1) << (g * kGroupLanes));
        continue;
      }
    }
    fn.warp(head, b.nbrt + u * b.dt, b.dt, mask, lane);
  }
}

// A pass's grid: n_wide blocks, then enough blocks of wpb warps to give
// each narrow row's warp kRowsPerWarp rows; shared memory for wpb warps'
// masks of cw words or one wide mask of cw_wide words.
template <class Row>
int launch_round(const void* tab, int nb, long long n_wide, long long n_narrow,
                 int cw, int cw_wide, const Row& fn, cudaStream_t stream) {
  if (nb < 0 || nb > kMaxBuckets) return (int)cudaErrorInvalidValue;
  if (n_wide + n_narrow == 0) return (int)cudaGetLastError();
  int wpb = kThreads / 32;
  if (cw > 0 && wpb * 4LL * cw > kMaxSmem) wpb = (int)(kMaxSmem / (4LL * cw));
  const long long words =
      (long long)wpb * cw > cw_wide ? (long long)wpb * cw : cw_wide;
  if (wpb < 1 || 4 * words > kMaxSmem) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)words;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        round_kernel<Row>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long per_block = (long long)wpb * kRowsPerWarp;
  const long long blocks = n_wide + (n_narrow + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  round_kernel<Row><<<(unsigned)blocks, 32 * wpb, smem, stream>>>(
      (const long long*)tab, nb, n_wide, wpb, cw, fn);
  return (int)cudaGetLastError();
}

}  // namespace

// ids int32[Vt], nbrt int32[Vt, Dt]; colors, deg1 and the outputs int32[n +
// 1]; draws int32[n + 1] (johansson) or uint64[2, n1 = n + 1] (one_shot_pick).
extern "C" int johansson(const void* ids, const void* nbrt, long long Vt,
                         int Dt, const void* colors, const void* deg1,
                         const void* draws, void* out, void* stream) {
  if (Vt > 0) {
    johansson_kernel<<<(unsigned)((32 * Vt + 255) / 256), 256, 0,
                       (cudaStream_t)stream>>>(
        (const int*)ids, (const int*)nbrt, Vt, Dt, (const int*)colors,
        (const int*)deg1, (const int*)draws, (int*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int one_shot_pick(const void* ids, const void* nbrt, long long Vt,
                             int Dt, const void* colors, const void* deg1,
                             const void* draws, long long n1,
                             int palette_deg, int delta, int cw, void* pick,
                             void* nfree, void* stream) {
  if (Vt > 0) {
    int wpb = 0;
    const int smem = color::prepare_smem(one_shot_pick_kernel, cw, &wpb);
    if (smem < 0) return (int)cudaErrorInvalidValue;
    one_shot_pick_kernel<<<(unsigned)((Vt + wpb - 1) / wpb), 32 * wpb, smem,
                           (cudaStream_t)stream>>>(
        (const int*)ids, (const int*)nbrt, Vt, Dt, (const int*)colors,
        (const int*)deg1, (const unsigned long long*)draws, n1, palette_deg,
        delta, cw, wpb,
        (int*)pick, (int*)nfree);
  }
  return (int)cudaGetLastError();
}

extern "C" int one_shot_resolve(const void* ids, const void* nbrt,
                                long long Vt, int Dt, const void* colors,
                                const void* pick, const void* nfree,
                                void* out, void* stream) {
  if (Vt > 0) {
    one_shot_resolve_kernel<<<(unsigned)((32 * Vt + 255) / 256), 256, 0,
                              (cudaStream_t)stream>>>(
        (const int*)ids, (const int*)nbrt, Vt, Dt, (const int*)colors,
        (const int*)pick, (const int*)nfree, (int*)out);
  }
  return (int)cudaGetLastError();
}

// tab int64[nb, 4] on the card (ids pointer, nbrt pointer, Vt, Dt), nb <=
// 64; n_wide / n_narrow the rows of the buckets wider / not wider than
// 1,024 entries; colors, deg1, draws and out int32[n1 = n + 1] (draws
// non-negative; out holding the round-start colors, which a row that is
// colored or loses keeps); pw int32[n1] scratch for the pick words. Two
// launches: the pick words, then the round.
extern "C" int johansson_round(const void* tab, int nb, long long n_wide,
                               long long n_narrow, const void* colors,
                               const void* deg1, const void* draws,
                               long long n1, void* pw, void* out,
                               void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n1 > 0) {
    const long long blocks = (n1 + 255) / 256;
    pick_words_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                        s>>>((const int*)colors, (const int*)deg1,
                             (const int*)draws, n1, (int*)pw);
  }
  const JohanssonRow fn{(const int*)colors, (const int*)pw, (int*)out};
  return launch_round(tab, nb, n_wide, n_narrow, 0, 0, fn, s);
}

// The table and counts as johansson_round's; draws uint64[2, n1]; pick,
// nfree and out int32[n1], pick and out holding the round-start colors and
// nfree zeros (a colored row's outputs, and out's of a row that loses);
// cw / cw_wide: the palette words of the widest narrow / wide row (ceil(L /
// 32), L = deg1 <= Dt + 1 for Elkin, delta + 1 for Barenboim). The rows of
// buckets of Dt <= kSortRow pick by ranks, the rest in a mask. Two
// launches: the pick pass, then the resolve pass.
extern "C" int one_shot_round(const void* tab, int nb, long long n_wide,
                              long long n_narrow, const void* colors,
                              const void* deg1, const void* draws,
                              long long n1, int palette_deg, int delta,
                              int cw, int cw_wide, void* pick, void* nfree,
                              void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const PickRow pk{(const int*)colors, (const int*)deg1,
                   (const unsigned long long*)draws, n1, palette_deg, delta,
                   (int*)pick, (int*)nfree};
  const int e = launch_round(tab, nb, n_wide, n_narrow, cw, cw_wide, pk, s);
  if (e) return e;
  const ResolveRow rs{(const int*)colors, (const int*)pick,
                      (const int*)nfree, (int*)out};
  return launch_round(tab, nb, n_wide, n_narrow, 0, 0, rs, s);
}
