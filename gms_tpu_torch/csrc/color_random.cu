// K24 color_random: the randomized coloring rounds over ONE degree bucket.
//
//   johansson        — gms_tpu/algorithms/coloring.py `_johansson_round_tiered`
//                      (:127): an uncolored row picks draws[v] mod deg1[v]
//                      (a color in [0, deg v]) and keeps it unless a
//                      neighbour holds it or picked it (a neighbour's pick is
//                      its color when colored, else its own draw mod deg1);
//   one_shot_pick    — `_one_shot_round` (:404), the pick: nfree = the colors
//                      of the palette [0, L) (L = deg1[v] for Elkin, delta + 1
//                      for Barenboim) absent from the committed neighbours'
//                      colors, r = jax's randint of the row's two 64-bit
//                      words into [0, max(nfree, 1)), pick = the r-th free
//                      color (0 when nfree is 0); a colored row's pick is
//                      its color and its nfree 0;
//   one_shot_resolve — its conflict rule: an uncolored row keeps its pick
//                      when nfree > 0 and no uncolored neighbour of higher id
//                      picked the same color (coloring_barenboim.h:44-47).
// The draws are an input, so the kernel and its plain version give the same
// colors on the same draws: Johansson's are gms_tpu's picks (non-negative
// int32, already below deg1); the one-shot's are jax.random's two 64-bit
// words a vertex (draws[v] and draws[n1 + v]), which jax_randint reduces as
// jax's `_randint` does (gms_tpu's int64 randint with x64 on) once the row's
// span, max(nfree, 1), is known. Every entry reads the
// round-start colors (and picks) and writes a fresh buffer, so the order of
// rows and buckets does not matter.
//
// A warp a row up to its first SENTINEL; the one-shot pick counts and selects
// in a used-color bitmask of cw words in shared memory (csrc/color_pick.cuh),
// the palette's words only. gms_tpu's one-shot round builds a
// [V, D_pad, cw] one-hot instead, which at RMAT-16 (65,536 x 9,600 x 300
// words) no device holds. Bound on an H100: bytes — the bucket's rows, each
// neighbour's color, draw and deg1 (or pick), the ids and the writes.

#include <cuda_runtime.h>

#include "color_pick.cuh"

namespace {

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
