// K21, the tile scorers of vertex similarity.
//
// tile_all_pairs replaces all_pairs_scores (gms_tpu/algorithms/
// similarity.py:115): out[u, v] for u < Bu, v < Vn, no mask, from id-space
// bitmap rows (bit v of word v >> 5 of row u set iff (u, v) is an edge;
// int32 words carrying gms_tpu's uint32 bits). c[u, v] = Σ_k
// popcount(row_u[k] & row_v[k]); AA and RA sum wcol[w] over the set bits w
// of the AND, in ascending w; the metric's finish is metric.cuh's. A 64×64
// tile of pairs per CTA, 256 threads each holding a 4×4 micro-tile, the
// bitmap words staged through shared memory 32 at a time, one AND+popcount
// a word pair.
//
// tile_topq replaces the body of _topq_ublock (gms_tpu/algorithms/
// link_prediction.py:471) for the u-rows [u_base, u_base + nu) against the
// vertices [v_base, v_base + nv) (v_base a strip start): it masks v > u,
// v < n, u < n and the edges (u, v), turns NaN into -inf (dropped), and
// keeps the best q by the key (-score, ⌊v/block⌋, u, v), the order in which
// gms_tpu's strip-by-strip top_k with incumbents winning ties keeps them
// (tests/test_torch_link_prediction.py holds the tie rule to gms_tpu). It
// reads the graph's CSR and its transpose (rows sorted ascending, no entry
// twice), not bitmap rows: c[u, v] = |N(u) ∩ N(v)| over out-neighbours, as
// gms_tpu's row-by-row product, also on a directed graph.
//
// Design: work in proportion to the wedges u - x - v, not to the words of
// a bitmap row. A unit is 32 u-rows × a chunk of 1,024 v; its common counts
// (or AA/RA sums) live in shared memory (128 KB). The unit walks x ∈ N(u)
// for each of its rows (the CSR) and then the v with x ∈ N(v) inside the
// chunk (row x of the transpose), found from the strip table (strips[x, c]
// = the first position of the transpose's row x whose entry is >= c·1024,
// two loads) or, without one, by binary search.
// Counts: the (u, x) items are spread over the warps and the wedges of a
// warp's 32 items over its lanes (a shuffle search), each adding 1 with a
// shared atomicAdd (order-free, exact). AA/RA: a warp takes one row at a
// time and walks its x in ascending order, adding wcol[x] to the row's
// sums, a __syncwarp between successive x, so each (u, v) sums its common
// neighbours' weights in ascending order, as tile_all_pairs does. Then every
// pair of the unit is finished (a pair with c = 0 can still score: Jaccard
// of two empty rows is 1, PA and TN ignore c); an edge is a bit the walk set
// where x itself falls in the chunk. A pair that can enter the CTA's list
// is buffered as a 64-bit key (descending score bits, then strip, u, v
// within the unit); a full buffer, and the unit's end, sorts the buffer
// (bitonic) and merges its first q into the CTA's list by merge-path ranks.
// The lists (two of q a CTA, ping-pong) lie in global scratch, so q has no
// limit. The CTAs are persistent, one an SM, and take units (chunk-major,
// so each CTA meets its units in strip order) from an atomic counter; the
// wrapper merges their lists with one sort on the key.
//
// Bound on an H100: operations or bytes — the wedges (shared atomics), the
// pair finishes (a few operations each, every pair with u < v < n), the
// CSR rows each unit reads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "metric.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kChunk = 32;
constexpr int kPad = kChunk + 1;
constexpr int kThreads = 256;

struct Stage {
  unsigned a[kTile][kPad];
  unsigned b[kTile][kPad];
};

struct Cand {
  float s;
  int u;
  int v;
};

// c (and s) of the nu × nv pairs of rows U[0, nu) × V[0, nv) (row stride W),
// this thread's 4×4 of them. Every thread of the CTA calls it.
template <bool WEIGHTED>
__device__ __forceinline__ void tile_counts(const unsigned* __restrict__ U,
                                            int nu,
                                            const unsigned* __restrict__ V,
                                            int nv, long long W,
                                            const float* __restrict__ wcol,
                                            Stage& st, int (&c)[4][4],
                                            float (&s)[4][4]) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[i][j] = 0;
      s[i][j] = 0.0f;
    }
  for (long long k0 = 0; k0 < W; k0 += kChunk) {
    for (int idx = tid; idx < kTile * kChunk; idx += kThreads) {
      const int r = idx / kChunk, k = idx % kChunk;
      const bool in_k = k0 + k < W;
      st.a[r][k] = (r < nu && in_k) ? U[r * W + k0 + k] : 0u;
      st.b[r][k] = (r < nv && in_k) ? V[r * W + k0 + k] : 0u;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      unsigned a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = st.a[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = st.b[tx + 16 * j][k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          unsigned x = a[i] & b[j];
          c[i][j] += __popc(x);
          if (WEIGHTED) {
            const float* w = wcol + (k0 + k) * 32;
            while (x) {
              s[i][j] += w[__ffs(x) - 1];
              x &= x - 1;
            }
          }
        }
    }
    __syncthreads();
  }
}

template <bool WEIGHTED>
__global__ void __launch_bounds__(kThreads)
    all_pairs_kernel(const unsigned* __restrict__ U, long long Bu,
                     const unsigned* __restrict__ V, long long Vn, long long W,
                     const int* __restrict__ deg_u,
                     const int* __restrict__ deg_v,
                     const float* __restrict__ wcol, int metric,
                     float* __restrict__ out) {
  __shared__ Stage st;
  const long long u0 = (long long)blockIdx.y * kTile;
  const long long v0 = (long long)blockIdx.x * kTile;
  const int nu = (int)min((long long)kTile, Bu - u0);
  const int nv = (int)min((long long)kTile, Vn - v0);
  int c[4][4];
  float s[4][4];
  tile_counts<WEIGHTED>(U + u0 * W, nu, V + v0 * W, nv, W, wcol, st, c, s);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ul = ty + 16 * i;
    if (ul >= nu) continue;
    const float ca = (float)deg_u[u0 + ul];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int vl = tx + 16 * j;
      if (vl >= nv) continue;
      out[(u0 + ul) * Vn + v0 + vl] = metric_finish(
          metric, (float)c[i][j], ca, (float)deg_v[v0 + vl], s[i][j]);
    }
  }
}

// key bits that sort a score descending (no NaN, -0.0 folded into +0.0)
__device__ __forceinline__ unsigned desc_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return ~((u & 0x80000000u) ? ~u : (u | 0x80000000u));
}

__device__ __forceinline__ float from_desc_bits(unsigned d) {
  const unsigned o = ~d;
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// the key order (-score, ⌊v/block⌋, u, v)
__device__ __forceinline__ bool cand_less(const Cand& a, const Cand& b,
                                          int block) {
  if (a.s != b.s) return a.s > b.s;
  const int sa = a.v / block, sb = b.v / block;
  if (sa != sb) return sa < sb;
  if (a.u != b.u) return a.u < b.u;
  return a.v < b.v;
}

namespace topq {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTU = 32;            // u-rows a unit
constexpr int kCW = 1024;          // v a unit (the strip table's width)
constexpr int kEdgeWords = kTU * kCW / 32;
constexpr int kThreads = 512;
constexpr int kSlab = 2048;        // pairs finished between buffer checks
constexpr int kBuf = 4096;         // keys buffered before a merge

struct Smem {
  unsigned acc[kTU * kCW];         // counts, or the float bits of AA/RA sums
  unsigned edge[kEdgeWords];       // bit (u, v): (u, v) is an edge
  int degv[kCW];
  unsigned long long buf[kBuf];
};

struct Unit {                      // the same in every thread of the CTA
  int u0, nut, cbase, vlo, vhi, vmin, strip0;
};

// Shared scalars of a CTA.
struct State {
  long long rs[kTU], re[kTU];      // the unit's rows in indices
  int pre[kTU + 1];                // exclusive offsets of their lengths
  int degu[kTU];
  int unit, cnt, rn, flip, next_row;
  Cand worst;
};

// [lo, hi): positions of the transpose's row x whose entries may lie in
// [vmin, vhi) (a superset with the table; the walk filters).
__device__ __forceinline__ void row_range(
    const long long* __restrict__ tptr, const int* __restrict__ tidx,
    const long long* __restrict__ strips, int cols, int x, const Unit& U,
    long long& lo, long long& hi) {
  if (strips) {
    const long long* r = strips + (long long)x * cols + U.cbase / kCW;
    lo = r[0];
    hi = r[1];
    return;
  }
  long long a = tptr[x], b = tptr[x + 1];
  long long l = a, h = b;  // first position with neighbour >= vmin
  while (l < h) {
    const long long m = (l + h) >> 1;
    if (tidx[m] < U.vmin) l = m + 1; else h = m;
  }
  lo = l;
  h = b;  // first position with neighbour >= vhi
  while (l < h) {
    const long long m = (l + h) >> 1;
    if (tidx[m] < U.vhi) l = m + 1; else h = m;
  }
  hi = l;
}

__device__ __forceinline__ void mark_edge(Smem& sm, int ul, int x,
                                          const Unit& U) {
  if (x >= U.vlo && x < U.vhi) {
    const int vl = x - U.cbase;
    atomicOr(&sm.edge[ul * (kCW / 32) + (vl >> 5)], 1u << (vl & 31));
  }
}

// Counts: the unit's (row, position) items 32 a warp, their wedges spread
// over the lanes.
__device__ void fill_counts(Smem& sm, State& st,
                            const int* __restrict__ indices,
                            const long long* __restrict__ tptr,
                            const int* __restrict__ tidx,
                            const long long* __restrict__ strips, int cols,
                            const Unit& U) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int P = st.pre[kTU];
  for (int g = warp * 32; g < P; g += kThreads) {
    const int k = g + lane;
    int ul = 0;
    long long lo = 0, hi = 0;
    if (k < P) {
      for (int step = 16; step > 0; step >>= 1)  // the last ul with pre <= k
        if (st.pre[ul + step] <= k) ul += step;
      const int x = indices[st.rs[ul] + (k - st.pre[ul])];
      mark_edge(sm, ul, x, U);
      row_range(tptr, tidx, strips, cols, x, U, lo, hi);
    }
    const int len = (int)(hi - lo);
    int incl = len;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int excl = incl - len;
    const int total = __shfl_sync(kFull, incl, 31);
    for (int t0 = 0; t0 < total; t0 += 32) {
      const int t = t0 + lane;
      int j = 0;  // the first lane whose wedges end past t
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(kFull, incl, j + step - 1) <= t) j += step;
      const long long lo_j = __shfl_sync(kFull, lo, j & 31);
      const int ex_j = __shfl_sync(kFull, excl, j & 31);
      const int ul_j = __shfl_sync(kFull, ul, j & 31);
      if (t < total) {
        const int v = tidx[lo_j + (t - ex_j)];
        if (v >= U.vmin && v < U.vhi)
          atomicAdd(&sm.acc[ul_j * kCW + (v - U.cbase)], 1u);
      }
    }
  }
}

// AA/RA: a warp a row, its x in ascending order, wcol[x] added to the sum
// of every v of the transpose's row x in the chunk; v are distinct within
// one x (no entry twice), and the __syncwarp orders successive x.
__device__ void fill_weighted(Smem& sm, State& st,
                              const int* __restrict__ indices,
                              const long long* __restrict__ tptr,
                              const int* __restrict__ tidx,
                              const long long* __restrict__ strips, int cols,
                              const float* __restrict__ wcol,
                              const Unit& U) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    int ul = 0;
    if (lane == 0) ul = atomicAdd(&st.next_row, 1);
    ul = __shfl_sync(kFull, ul, 0);
    if (ul >= kTU) break;
    float* sums = reinterpret_cast<float*>(sm.acc) + ul * kCW;
    const long long rs = st.rs[ul], re = st.re[ul];
    for (long long p0 = rs; p0 < re; p0 += 32) {
      const long long p = p0 + lane;
      long long lo = 0, hi = 0;
      float w = 0.0f;
      if (p < re) {
        const int x = indices[p];
        mark_edge(sm, ul, x, U);
        row_range(tptr, tidx, strips, cols, x, U, lo, hi);
        w = wcol[x];
      }
      const int m = (int)min(32LL, re - p0);
      for (int j = 0; j < m; ++j) {
        const long long a = __shfl_sync(kFull, lo, j);
        const long long b = __shfl_sync(kFull, hi, j);
        const float wj = __shfl_sync(kFull, w, j);
        for (long long t = a + lane; t < b; t += 32) {
          const int v = tidx[t];
          if (v >= U.vmin && v < U.vhi)
            sums[v - U.cbase] = __fadd_rn(sums[v - U.cbase], wj);
        }
        __syncwarp();
      }
    }
  }
}

__device__ __forceinline__ void bitonic_sort(unsigned long long* keys,
                                             int size) {
  for (int k = 2; k <= size; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < size; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = keys[i], b = keys[ixj];
          if (((i & k) == 0) == (a > b)) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
}

// a buffered key's candidate: (desc score bits, strip, u, v within the unit)
__device__ __forceinline__ Cand decode(unsigned long long key,
                                       const Unit& U) {
  const unsigned local = (unsigned)key;
  return Cand{from_desc_bits((unsigned)(key >> 32)),
              U.u0 + (int)((local >> 10) & (kTU - 1)),
              U.cbase + (int)(local & (kCW - 1))};
}

// Sorts the buffer and merges its first q keys into the CTA's list. Every
// thread calls it, after a barrier.
__device__ void flush(Smem& sm, State& st, Cand* lists, int q, int block,
                      const Unit& U) {
  const int tid = threadIdx.x;
  const int cnt = st.cnt;
  int size = 64;
  while (size < cnt) size <<= 1;
  for (int i = cnt + tid; i < size; i += kThreads) sm.buf[i] = ~0ull;
  __syncthreads();
  bitonic_sort(sm.buf, size);
  const int tn = min(cnt, q), rn = st.rn;
  const Cand* R = lists + (long long)st.flip * q;
  Cand* R2 = lists + (long long)(st.flip ^ 1) * q;
  // keys are distinct: no pair is in both lists
  for (int i = tid; i < rn; i += kThreads) {
    const Cand r = R[i];
    int lo = 0, hi = tn;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cand_less(decode(sm.buf[mid], U), r, block)) lo = mid + 1;
      else hi = mid;
    }
    if (i + lo < q) R2[i + lo] = r;
  }
  for (int j = tid; j < tn; j += kThreads) {
    const Cand t = decode(sm.buf[j], U);
    int lo = 0, hi = rn;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cand_less(R[mid], t, block)) lo = mid + 1; else hi = mid;
    }
    if (j + lo < q) R2[j + lo] = t;
  }
  __syncthreads();
  if (tid == 0) {
    st.rn = min(q, rn + tn);
    st.flip ^= 1;
    st.cnt = 0;
    if (st.rn == q) st.worst = R2[q - 1];
  }
  __syncthreads();
}

template <bool WEIGHTED>
__global__ void __launch_bounds__(kThreads, 1)
    topq_kernel(const long long* __restrict__ indptr,
                const int* __restrict__ indices,
                const long long* __restrict__ tptr,
                const int* __restrict__ tidx,
                const long long* __restrict__ strips, int cols,
                const int* __restrict__ deg_p,
                const float* __restrict__ wcol, int n, int u_base, int nu,
                int v_base, int nv, int block, int metric, int q,
                int n_units, int n_ut, int c0, int* __restrict__ work,
                Cand* __restrict__ scratch, float* __restrict__ out_s,
                int* __restrict__ out_u, int* __restrict__ out_v,
                int* __restrict__ out_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& sm = *reinterpret_cast<Smem*>(smem);
  __shared__ State st;
  const int tid = threadIdx.x, lane = tid & 31;
  Cand* lists = scratch + (long long)blockIdx.x * 2 * q;
  if (tid == 0) {
    st.rn = 0;
    st.flip = 0;
    st.cnt = 0;
  }
  for (;;) {
    __syncthreads();  // the previous unit is done with the shared state
    if (tid == 0) st.unit = atomicAdd(work, 1);
    __syncthreads();
    const int unit = st.unit;
    if (unit >= n_units) break;
    Unit U;
    const int ut = unit % n_ut;
    U.u0 = u_base + ut * kTU;
    U.nut = min(kTU, u_base + nu - U.u0);
    U.cbase = (c0 + unit / n_ut) * kCW;
    U.vlo = max(U.cbase, v_base);
    U.vhi = min(min(U.cbase + kCW, v_base + nv), n);
    U.vmin = max(U.vlo, U.u0 + 1);  // no pair of the unit has a v below
    U.strip0 = U.cbase / block;
    if (U.u0 >= n || U.vmin >= U.vhi) continue;
    if (tid < kTU) {
      const int u = U.u0 + tid;
      const bool live = tid < U.nut && u < n;
      st.rs[tid] = live ? indptr[u] : 0;
      st.re[tid] = live ? indptr[u + 1] : 0;
      st.degu[tid] = live ? deg_p[u] : 0;
    }
    for (int i = tid; i < kCW; i += kThreads)
      sm.degv[i] = deg_p[min(U.cbase + i, n - 1)];
    uint4* acc4 = reinterpret_cast<uint4*>(sm.acc);
    for (int i = tid; i < kTU * kCW / 4; i += kThreads)
      acc4[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < kEdgeWords; i += kThreads) sm.edge[i] = 0u;
    if (tid == 0) st.next_row = 0;
    __syncthreads();
    if (tid < 32) {  // the rows' exclusive offsets
      const int len = (int)(st.re[tid] - st.rs[tid]);
      int incl = len;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      st.pre[tid + 1] = incl;
      if (tid == 0) st.pre[0] = 0;
    }
    __syncthreads();
    if (WEIGHTED)
      fill_weighted(sm, st, indices, tptr, tidx, strips, cols, wcol, U);
    else
      fill_counts(sm, st, indices, tptr, tidx, strips, cols, U);
    __syncthreads();
    for (int s0 = 0; s0 < kTU * kCW; s0 += kSlab) {
      const int rn = st.rn;
      const Cand worst = st.worst;
      for (int idx = s0 + tid; idx < s0 + kSlab; idx += kThreads) {
        const int ul = idx / kCW, vl = idx % kCW;
        const int u = U.u0 + ul, v = U.cbase + vl;
        bool ok = ul < U.nut && u < n && v >= U.vmin && v < U.vhi && v > u &&
                  !((sm.edge[idx >> 5] >> (idx & 31)) & 1u);
        float f = 0.0f;
        if (ok) {
          const unsigned a = sm.acc[idx];
          f = metric_finish(metric, WEIGHTED ? 0.0f : (float)a,
                            (float)st.degu[ul], (float)sm.degv[vl],
                            WEIGHTED ? __uint_as_float(a) : 0.0f);
          if (f == 0.0f) f = 0.0f;
          ok = !isnan(f) && f != -INFINITY;
          if (ok && rn == q) ok = cand_less(Cand{f, u, v}, worst, block);
        }
        const unsigned hit = __ballot_sync(kFull, ok);
        if (hit) {
          int base = 0;
          if (lane == 0) base = atomicAdd(&st.cnt, __popc(hit));
          base = __shfl_sync(kFull, base, 0);
          if (ok)
            sm.buf[base + __popc(hit & ((1u << lane) - 1u))] =
                ((unsigned long long)desc_bits(f) << 32) |
                ((unsigned)(v / block - U.strip0) << 15) |
                ((unsigned)ul << 10) | (unsigned)vl;
        }
      }
      __syncthreads();
      if (st.cnt > kBuf - kSlab) flush(sm, st, lists, q, block, U);
    }
    if (st.cnt) flush(sm, st, lists, q, block, U);
  }
  __syncthreads();
  const int rn = st.rn;
  const Cand* R = lists + (long long)st.flip * q;
  const long long at = (long long)blockIdx.x * q;
  for (int i = tid; i < rn; i += kThreads) {
    out_s[at + i] = R[i].s;
    out_u[at + i] = R[i].u;
    out_v[at + i] = R[i].v;
  }
  if (tid == 0) out_n[blockIdx.x] = rn;
}

}  // namespace topq

}  // namespace

extern "C" int tile_all_pairs(const void* U, long long Bu, const void* V,
                              long long Vn, long long W, const void* deg_u,
                              const void* deg_v, const void* wcol, int metric,
                              void* out, void* stream) {
  if (Bu > 0 && Vn > 0) {
    const dim3 grid((unsigned)((Vn + kTile - 1) / kTile),
                    (unsigned)((Bu + kTile - 1) / kTile));
    const cudaStream_t s = (cudaStream_t)stream;
    if (metric_weighted(metric))
      all_pairs_kernel<true><<<grid, kThreads, 0, s>>>(
          (const unsigned*)U, Bu, (const unsigned*)V, Vn, W,
          (const int*)deg_u, (const int*)deg_v, (const float*)wcol, metric,
          (float*)out);
    else
      all_pairs_kernel<false><<<grid, kThreads, 0, s>>>(
          (const unsigned*)U, Bu, (const unsigned*)V, Vn, W,
          (const int*)deg_u, (const int*)deg_v, (const float*)wcol, metric,
          (float*)out);
  }
  return (int)cudaGetLastError();
}

// indptr int64[n + 1], indices int32 and their transpose tptr, tidx (rows
// sorted, no entry twice), strips int64[n, cols] (the transpose's) or null, deg_p int32 (>= n entries), wcol float32[n] or null; the units
// are 32 u-rows of [u_base, u_base + nu) × 1,024-vertex chunks c0 ... of
// [v_base, v_base + nv), chunk-major; work int32[1] zero; scratch 2q
// candidates (12 bytes) a CTA; out_s, out_u, out_v [ctas, q], out_n [ctas].
extern "C" int tile_topq(const void* indptr, const void* indices,
                         const void* tptr, const void* tidx,
                         const void* strips, int cols, const void* deg_p,
                         const void* wcol, int n, int u_base, int nu,
                         int v_base, int nv, int block, int metric, int q,
                         int n_units, int n_ut, int c0, int ctas, void* work,
                         void* scratch, void* out_s, void* out_u,
                         void* out_v, void* out_n, void* stream) {
  if (q < 1 || block < 1 || n_ut < 1) return (int)cudaErrorInvalidValue;
  if (n_units > 0 && ctas > 0) {
    const int smem = (int)sizeof(topq::Smem);
    const cudaStream_t s = (cudaStream_t)stream;
    auto kernel = metric_weighted(metric) ? topq::topq_kernel<true>
                                          : topq::topq_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<ctas, topq::kThreads, smem, s>>>(
        (const long long*)indptr, (const int*)indices,
        (const long long*)tptr, (const int*)tidx,
        (const long long*)strips, cols, (const int*)deg_p,
        (const float*)wcol, n, u_base, nu, v_base, nv, block, metric, q,
        n_units, n_ut, c0, (int*)work, (Cand*)scratch, (float*)out_s,
        (int*)out_u, (int*)out_v, (int*)out_n);
  }
  return (int)cudaGetLastError();
}
