// K18 pair_scores_merge and K19 pair_scores_hub: one vertex-similarity score
// per pair (u, v), float32.
//
// K18 replaces pair_scores (gms_tpu/algorithms/similarity.py:51): c =
// |N(u) ∩ N(v)| over padded rows (u's row from nbr_a, v's from nbr_b;
// SENTINEL never counts), then the metric (metric.cuh). For AA and RA it sums
// the weight of each common neighbour w, 1/logf(deg w) or 1/deg w, with deg
// looked up in deg1 at min(w, len(deg1) - 1). Row and deg1 indices clip into
// range, as gms_tpu's mode="clip" takes do.
// K19 replaces pair_scores_hub (:94), for pairs whose v is a hub: each
// element a of u's row is one bit test, bit (a & 31) of word
// hub_idx[v] * vw + (a >> 5) of the hub bitmaps, each index clipped as
// gms_tpu clips it.
// Both write out[out_pos[i]] (out[i] without out_pos), so that a caller that
// splits its pairs between the two kernels gets its scores in pair order.
//
// Contract (K1's): each row strictly ascending with a SENTINEL tail
// (checks.validate_sorted_rows under GMS_TPU_PARANOID=1). gms_tpu's
// broadcast compare takes any order; on such rows the two agree.
//
// Design: a warp per pair; hub pairs reach about 9,500 row elements, which a
// thread per pair would leave to one lane. K18 finds each row's length (its
// first SENTINEL) by binary search, walks the shorter row with neighbouring
// lanes on neighbouring slots and binary-searches the longer one, each lane
// starting from where its previous search ended (its elements ascend). K19
// walks u's row 32 slots at a time up to its first SENTINEL. The count and the
// weight sum reduce over the warp in a fixed order.
//
// Bound on an H100: bytes. Each pair reads its pair, two deg1 entries, u's
// row up to its first SENTINEL and v's row (K18) or one bitmap word per
// element (K19), and writes one float; the searches' extra reads hit L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "metric.cuh"
#include "row_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// first index of row[0, w) holding a value >= x
__device__ __forceinline__ int lower_bound(const int* row, int lo, int hi,
                                           int x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void finish_pair(int metric, int c, float s, int ca,
                                            int cb, long long p,
                                            const int* out_pos, float* out) {
  for (int o = 16; o > 0; o >>= 1) {
    c += __shfl_down_sync(0xffffffffu, c, o);
    s += __shfl_down_sync(0xffffffffu, s, o);
  }
  if ((threadIdx.x & 31) == 0)
    out[out_pos ? out_pos[p] : p] =
        metric_finish(metric, (float)c, (float)ca, (float)cb, s);
}

template <bool WEIGHTED>
__global__ void merge_kernel(const int* __restrict__ nbr_a, long long va,
                             int wa, const int* __restrict__ nbr_b,
                             long long vb, int wb,
                             const int* __restrict__ deg1, long long nd,
                             const int* __restrict__ pairs, long long B,
                             int metric, const int* __restrict__ out_pos,
                             float* __restrict__ out) {
  const long long p = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (p >= B) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const long long u = pairs[2 * p], v = pairs[2 * p + 1];
  const int* ra = nbr_a + clip_index(u, va) * wa;
  const int* rb = nbr_b + clip_index(v, vb) * wb;
  const int ca = deg1[clip_index(u, nd)], cb = deg1[clip_index(v, nd)];
  const int la = lower_bound(ra, 0, wa, GMS_SENTINEL);
  const int lb = lower_bound(rb, 0, wb, GMS_SENTINEL);
  // membership is symmetric: walk the shorter row, search the longer
  const bool a_short = la <= lb;
  const int* rs = a_short ? ra : rb;
  const int* rl = a_short ? rb : ra;
  const int ls = a_short ? la : lb, ll = a_short ? lb : la;
  int c = 0, lo = 0;
  float s = 0.0f;
  for (int j = lane; j < ls; j += 32) {
    const int x = rs[j];
    lo = lower_bound(rl, lo, ll, x);
    if (lo < ll && rl[lo] == x) {
      ++c;
      if (WEIGHTED) s += metric_weight(metric, deg1[clip_index(x, nd)]);
    }
  }
  finish_pair(metric, c, s, ca, cb, p, out_pos, out);
}

template <bool WEIGHTED>
__global__ void hub_kernel(const int* __restrict__ nbr_a, long long va, int wa,
                           const int* __restrict__ deg1, long long nd,
                           const unsigned* __restrict__ bm, long long n_bm,
                           const int* __restrict__ hub_idx, long long n_hub,
                           long long vw, const int* __restrict__ pairs,
                           long long B, int metric,
                           const int* __restrict__ out_pos,
                           float* __restrict__ out) {
  const long long p = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (p >= B) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const long long u = pairs[2 * p], v = pairs[2 * p + 1];
  const int* ra = nbr_a + clip_index(u, va) * wa;
  const int ca = deg1[clip_index(u, nd)], cb = deg1[clip_index(v, nd)];
  const long long h = hub_idx[clip_index(v, n_hub)];
  const long long top = 32 * vw - 1;
  int c = 0;
  float s = 0.0f;
  for (int base = 0; base < wa; base += 32) {
    const int slot = base + lane;
    const int x = slot < wa ? ra[slot] : GMS_SENTINEL;
    if (x != GMS_SENTINEL) {
      const long long aw = x < 0 ? 0 : (x > top ? top : x);
      const unsigned word = bm[clip_index(h * vw + (aw >> 5), n_bm)];
      if ((word >> (aw & 31)) & 1u) {
        ++c;
        if (WEIGHTED) s += metric_weight(metric, deg1[clip_index(x, nd)]);
      }
    }
    if (__any_sync(0xffffffffu, x == GMS_SENTINEL)) break;
  }
  finish_pair(metric, c, s, ca, cb, p, out_pos, out);
}

unsigned blocks_for(long long B) { return (unsigned)((B + kWarps - 1) / kWarps); }

}  // namespace

extern "C" int pair_scores_merge(const void* nbr_a, long long va, int wa,
                                 const void* nbr_b, long long vb, int wb,
                                 const void* deg1, long long nd,
                                 const void* pairs, long long B, int metric,
                                 const void* out_pos, void* out, void* stream) {
  if (B > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (metric_weighted(metric))
      merge_kernel<true><<<blocks_for(B), kThreads, 0, s>>>(
          (const int*)nbr_a, va, wa, (const int*)nbr_b, vb, wb,
          (const int*)deg1, nd, (const int*)pairs, B, metric,
          (const int*)out_pos, (float*)out);
    else
      merge_kernel<false><<<blocks_for(B), kThreads, 0, s>>>(
          (const int*)nbr_a, va, wa, (const int*)nbr_b, vb, wb,
          (const int*)deg1, nd, (const int*)pairs, B, metric,
          (const int*)out_pos, (float*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int pair_scores_hub(const void* nbr_a, long long va, int wa,
                               const void* deg1, long long nd, const void* bm,
                               long long n_bm, const void* hub_idx,
                               long long n_hub, long long vw, const void* pairs,
                               long long B, int metric, const void* out_pos,
                               void* out, void* stream) {
  if (B > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (metric_weighted(metric))
      hub_kernel<true><<<blocks_for(B), kThreads, 0, s>>>(
          (const int*)nbr_a, va, wa, (const int*)deg1, nd,
          (const unsigned*)bm, n_bm, (const int*)hub_idx, n_hub, vw,
          (const int*)pairs, B, metric, (const int*)out_pos, (float*)out);
    else
      hub_kernel<false><<<blocks_for(B), kThreads, 0, s>>>(
          (const int*)nbr_a, va, wa, (const int*)deg1, nd,
          (const unsigned*)bm, n_bm, (const int*)hub_idx, n_hub, vw,
          (const int*)pairs, B, metric, (const int*)out_pos, (float*)out);
  }
  return (int)cudaGetLastError();
}
