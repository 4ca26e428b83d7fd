// K21, the tile scorer: vertex-similarity scores of every (u, v) in a block
// of rows against a range of vertices, from id-space bitmap rows (bit v of
// word v >> 5 of row u set iff (u, v) is an edge; int32 words carrying
// gms_tpu's uint32 bits). c[u, v] = Σ_k popcount(row_u[k] & row_v[k]); AA and
// RA sum wcol[w] over the set bits w of the AND, in ascending w; the metric's
// finish is metric.cuh's.
//
// tile_all_pairs replaces all_pairs_scores (gms_tpu/algorithms/
// similarity.py:115): out[u, v] for u < Bu, v < Vn, no mask.
// tile_topq replaces the body of _topq_ublock (gms_tpu/algorithms/
// link_prediction.py:471) for one u-block and the v-strips from v_base: it
// masks v > u, v < n, u < n and the edges (u, v) (one bit test of row_u), and
// turns NaN into -inf (dropped); each CTA keeps its best min(q, its
// candidates) by the key (-score, ⌊v/block⌋, u, v), the order in which
// gms_tpu's strip-by-strip top_k with incumbents winning ties keeps them
// (tests/test_torch_link_prediction.py holds the tie rule to gms_tpu). The
// wrapper merges the CTAs' lists with one sort on the same key.
//
// Design: a 64×64 tile of pairs per CTA step, 256 threads each holding a 4×4
// micro-tile (rows ty + 16i, columns tx + 16j), the bitmap words staged
// through shared memory 32 at a time as the k dimension, one AND+popcount a
// word pair. tile_topq walks `group` v-tiles of its u-tile, skipping tiles
// wholly on or below the diagonal or past n, and keeps a running list of its
// best q in shared memory: a tile whose scores cannot enter the list costs no
// selection; otherwise its candidates are bitonic-sorted as 64-bit keys
// (descending score bits, then the in-tile index, which orders (u, v) since a
// tile never crosses a strip) and merged into the list by merge-path ranks.
// Tensor cores (b1 AND+popc) and skipping zero words are later work.
//
// Bound on an H100: operations, one AND+popcount per word per pair, at 16
// popcounts per clock per SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "metric.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kChunk = 32;
constexpr int kPad = kChunk + 1;
constexpr int kThreads = 256;
constexpr int kTileSize = kTile * kTile;
constexpr int kMaxQ = kTileSize;

struct Stage {
  unsigned a[kTile][kPad];
  unsigned b[kTile][kPad];
};

struct Cand {
  float s;
  int u;
  int v;
};

constexpr int kUnionBytes =
    sizeof(Stage) > kTileSize * 8 ? (int)sizeof(Stage) : kTileSize * 8;

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
                                          long long block) {
  if (a.s != b.s) return a.s > b.s;
  const long long sa = a.v / block, sb = b.v / block;
  if (sa != sb) return sa < sb;
  if (a.u != b.u) return a.u < b.u;
  return a.v < b.v;
}

__device__ __forceinline__ void bitonic_sort(unsigned long long* keys) {
  for (int k = 2; k <= kTileSize; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < kTileSize; i += kThreads) {
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

struct TileRef {  // decodes a sorted tile key into its candidate
  long long u0, v0;
  __device__ __forceinline__ Cand operator()(unsigned long long key) const {
    const int local = (int)(key & 0xffffffffu);
    return Cand{from_desc_bits((unsigned)(key >> 32)),
                (int)(u0 + local / kTile), (int)(v0 + local % kTile)};
  }
};

template <bool WEIGHTED>
__global__ void __launch_bounds__(kThreads)
    topq_kernel(const unsigned* __restrict__ U, int nu,
                const unsigned* __restrict__ V, long long nv, long long W,
                const int* __restrict__ deg_p, long long n, long long u_base,
                long long v_base, long long block,
                const float* __restrict__ wcol, int metric, int q,
                int tiles_per_strip, long long n_vtiles, long long group,
                float* __restrict__ out_s, int* __restrict__ out_u,
                int* __restrict__ out_v, int* __restrict__ out_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage& st = *reinterpret_cast<Stage*>(smem);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  Cand* R = reinterpret_cast<Cand*>(smem + kUnionBytes);
  Cand* R2 = R + q;
  __shared__ int rn_s, tn_s;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ut = blockIdx.x;
  const long long u0 = u_base + (long long)ut * kTile;
  const int nut = min(kTile, nu - ut * kTile);
  const unsigned* Urows = U + (long long)ut * kTile * W;
  if (tid == 0) rn_s = 0;
  const long long g0 = (long long)blockIdx.y * group;
  const long long g1 = min(n_vtiles, g0 + group);
  for (long long g = g0; g < g1; ++g) {
    const long long strip = v_base / block + g / tiles_per_strip;
    const long long vs = strip * block + (g % tiles_per_strip) * kTile;
    const long long ve =
        min(min(vs + kTile, (strip + 1) * block), v_base + nv);
    // the same for every thread: no barrier is skipped by some threads only
    if (vs >= ve || vs >= n || u0 >= n || ve - 1 <= u0) continue;
    __syncthreads();  // the previous tile's merge is done with rn_s, tn_s
    if (tid == 0) tn_s = 0;
    int c[4][4];
    float s[4][4];
    tile_counts<WEIGHTED>(Urows, nut, V + (vs - v_base) * W, (int)(ve - vs),
                          W, wcol, st, c, s);
    const int rn = rn_s;
    Cand worst{0.0f, 0, 0};
    if (rn == q) worst = R[q - 1];
    float sc[4][4];
    int mine = 0;
    unsigned ok_bits = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ul = ty + 16 * i;
      const long long u = u0 + ul;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int vl = tx + 16 * j;
        const long long v = vs + vl;
        bool ok = ul < nut && v < ve && v > u && v < n && u < n;
        float f = -INFINITY;
        if (ok) ok = !((Urows[ul * W + (v >> 5)] >> (v & 31)) & 1u);
        if (ok) {
          f = metric_finish(metric, (float)c[i][j], (float)deg_p[u],
                            (float)deg_p[v], s[i][j]);
          if (f == 0.0f) f = 0.0f;
          ok = !isnan(f) && f != -INFINITY;
        }
        if (ok && rn == q) ok = cand_less(Cand{f, (int)u, (int)v}, worst, block);
        sc[i][j] = f;
        if (ok) {
          ok_bits |= 1u << (4 * i + j);
          ++mine;
        }
      }
    }
    if (mine) atomicAdd(&tn_s, mine);
    if (!__syncthreads_or(mine)) continue;
    // the tile's candidates as sort keys; everything else sorts last
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int local = (ty + 16 * i) * kTile + tx + 16 * j;
        keys[local] = (ok_bits >> (4 * i + j)) & 1u
                          ? ((unsigned long long)desc_bits(sc[i][j]) << 32) |
                                (unsigned)local
                          : ~0ull;
      }
    __syncthreads();
    bitonic_sort(keys);
    const int tn = min(tn_s, q);
    const TileRef tile{u0, vs};
    // merge R[0, rn) and the tile's first tn into R2 by merge-path ranks
    // (keys are distinct: no pair is in both lists)
    for (int i = tid; i < rn; i += kThreads) {
      int lo = 0, hi = tn;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cand_less(tile(keys[mid]), R[i], block)) lo = mid + 1; else hi = mid;
      }
      if (i + lo < q) R2[i + lo] = R[i];
    }
    for (int j = tid; j < tn; j += kThreads) {
      const Cand t = tile(keys[j]);
      int lo = 0, hi = rn;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cand_less(R[mid], t, block)) lo = mid + 1; else hi = mid;
      }
      if (j + lo < q) R2[j + lo] = t;
    }
    __syncthreads();
    const int m = min(q, rn + tn);
    for (int i = tid; i < m; i += kThreads) R[i] = R2[i];
    if (tid == 0) rn_s = m;
  }
  __syncthreads();
  const int rn = rn_s;
  const long long cta = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  for (int i = tid; i < rn; i += kThreads) {
    out_s[cta * q + i] = R[i].s;
    out_u[cta * q + i] = R[i].u;
    out_v[cta * q + i] = R[i].v;
  }
  if (tid == 0) out_n[cta] = rn;
}

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

extern "C" int tile_topq(const void* U, int nu, const void* V, long long nv,
                         long long W, const void* deg_p, long long n,
                         long long u_base, long long v_base, long long block,
                         const void* wcol, int metric, int q,
                         int tiles_per_strip, long long n_vtiles,
                         long long group, int ctas_v, void* out_s, void* out_u,
                         void* out_v, void* out_n, void* stream) {
  if (q < 1 || q > kMaxQ || block < 1 || tiles_per_strip < 1)
    return (int)cudaErrorInvalidValue;
  if (nu > 0 && ctas_v > 0) {
    const int smem = kUnionBytes + 2 * q * (int)sizeof(Cand);
    const dim3 grid((unsigned)((nu + kTile - 1) / kTile), (unsigned)ctas_v);
    const cudaStream_t s = (cudaStream_t)stream;
    auto kernel = metric_weighted(metric) ? topq_kernel<true> : topq_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, s>>>(
        (const unsigned*)U, nu, (const unsigned*)V, nv, W, (const int*)deg_p,
        n, u_base, v_base, block, (const float*)wcol, metric, q,
        tiles_per_strip, n_vtiles, group, (float*)out_s, (int*)out_u,
        (int*)out_v, (int*)out_n);
  }
  return (int)cudaGetLastError();
}
