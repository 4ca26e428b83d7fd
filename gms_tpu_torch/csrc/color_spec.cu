// K23 color_spec: the three passes of one speculative Jones–Plassmann round
// over ONE degree bucket, one entry each.
//
// Replaces gms_tpu/algorithms/coloring.py `_spec_round_tiered` (:202-253):
//   spec_pick  (pass 1, :219-225): an uncolored row's pick0 is the mex of its
//              committed neighbours' colors; a colored row's is -2;
//   spec_rank  (pass 2, :226-240): k = the number of neighbours whose pick0
//              equals the row's and whose priority is strictly higher,
//              capped at 31 (_SPEC_RANK_CAP); an uncolored row's tent is the
//              k-th (0-based) color absent from its committed neighbours';
//   spec_clash (pass 3, :241-253): an uncolored row keeps its tent unless a
//              neighbour with a strictly higher priority holds the same
//              tent; else it stays uncolored.
// Each pass reads only the round-start colors and the previous pass's
// buffer and writes a fresh one (pick0, tent, out), so the order of rows
// and of buckets within a pass does not matter; the wrapper launches each
// entry once per bucket. Colored rows write their color (pass 1: -2), as
// gms_tpu's `where` does.
//
// A warp a row, reading the row once up to its first SENTINEL; the mex and
// the k-th free color come from a used-color bitmask of cw = ceil((Dt + 2) /
// 32) words in shared memory (csrc/color_pick.cuh). Bound on an H100: bytes
// — the bucket's rows, each neighbour's color, pick0 or tent and priority,
// the ids and the writes.

#include <cuda_runtime.h>

#include "color_pick.cuh"

namespace {

constexpr int kRankCap = 31;

__global__ void spec_pick_kernel(const int* __restrict__ ids,
                                 const int* __restrict__ nbrt, long long Vt,
                                 int Dt, const int* __restrict__ colors,
                                 int cw, int wpb, int* __restrict__ pick0) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * wpb + warp;
  if (r >= Vt) return;
  const int id = ids[r];
  if (colors[id] != -1) {
    if (lane == 0) pick0[id] = -2;
    return;
  }
  unsigned* mask = smem + (long long)warp * cw;
  color::mask_clear(mask, cw, lane);
  const int limit = 32 * cw;
  const int* row = nbrt + r * Dt;
  for (int j = lane; j < Dt; j += 32) {
    const int w = row[j];
    if (w == color::kSentinel) break;
    color::mask_mark(mask, colors[w], limit);
  }
  __syncwarp();
  const int pick = color::kth_free(mask, cw, limit, 0, lane);
  if (lane == 0) pick0[id] = pick < 0 ? 0 : pick;
}

__global__ void spec_rank_kernel(const int* __restrict__ ids,
                                 const int* __restrict__ nbrt, long long Vt,
                                 int Dt, const int* __restrict__ colors,
                                 const int* __restrict__ pick0,
                                 const int* __restrict__ prio, int cw,
                                 int wpb, int* __restrict__ tent) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * wpb + warp;
  if (r >= Vt) return;
  const int id = ids[r];
  const int vcol = colors[id];
  if (vcol != -1) {
    if (lane == 0) tent[id] = vcol;
    return;
  }
  unsigned* mask = smem + (long long)warp * cw;
  color::mask_clear(mask, cw, lane);
  const int vpk = pick0[id], vpri = prio[id];
  const int limit = 32 * cw;
  const int* row = nbrt + r * Dt;
  int k = 0;
  for (int j = lane; j < Dt; j += 32) {
    const int w = row[j];
    if (w == color::kSentinel) break;
    k += pick0[w] == vpk && prio[w] > vpri;
    color::mask_mark(mask, colors[w], limit);
  }
  for (int o = 16; o > 0; o >>= 1) k += __shfl_xor_sync(color::kFull, k, o);
  __syncwarp();
  const int pick = color::kth_free(mask, cw, limit, k < kRankCap ? k : kRankCap,
                                   lane);
  if (lane == 0) tent[id] = pick < 0 ? 0 : pick;
}

__global__ void spec_clash_kernel(const int* __restrict__ ids,
                                  const int* __restrict__ nbrt, long long Vt,
                                  int Dt, const int* __restrict__ colors,
                                  const int* __restrict__ tent,
                                  const int* __restrict__ prio,
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
  const int vten = tent[id], vpri = prio[id];
  const int* row = nbrt + r * Dt;
  bool lose = false;
  for (int j = lane; j < Dt && !lose; j += 32) {
    const int w = row[j];
    if (w == color::kSentinel) break;
    lose = tent[w] == vten && prio[w] > vpri;
  }
  if (__any_sync(color::kFull, lose)) {
    if (lane == 0) out[id] = -1;
  } else if (lane == 0) {
    out[id] = vten;
  }
}

}  // namespace

// ids int32[Vt], nbrt int32[Vt, Dt]; colors, prio and the outputs int32[n + 1].
extern "C" int spec_pick(const void* ids, const void* nbrt, long long Vt,
                         int Dt, const void* colors, int cw, void* pick0,
                         void* stream) {
  if (Vt > 0) {
    int wpb = 0;
    const int smem = color::prepare_smem(spec_pick_kernel, cw, &wpb);
    if (smem < 0) return (int)cudaErrorInvalidValue;
    spec_pick_kernel<<<(unsigned)((Vt + wpb - 1) / wpb), 32 * wpb, smem,
                       (cudaStream_t)stream>>>(
        (const int*)ids, (const int*)nbrt, Vt, Dt, (const int*)colors, cw, wpb,
        (int*)pick0);
  }
  return (int)cudaGetLastError();
}

extern "C" int spec_rank(const void* ids, const void* nbrt, long long Vt,
                         int Dt, const void* colors, const void* pick0,
                         const void* prio, int cw, void* tent, void* stream) {
  if (Vt > 0) {
    int wpb = 0;
    const int smem = color::prepare_smem(spec_rank_kernel, cw, &wpb);
    if (smem < 0) return (int)cudaErrorInvalidValue;
    spec_rank_kernel<<<(unsigned)((Vt + wpb - 1) / wpb), 32 * wpb, smem,
                       (cudaStream_t)stream>>>(
        (const int*)ids, (const int*)nbrt, Vt, Dt, (const int*)colors,
        (const int*)pick0, (const int*)prio, cw, wpb, (int*)tent);
  }
  return (int)cudaGetLastError();
}

extern "C" int spec_clash(const void* ids, const void* nbrt, long long Vt,
                          int Dt, const void* colors, const void* tent,
                          const void* prio, void* out, void* stream) {
  if (Vt > 0) {
    spec_clash_kernel<<<(unsigned)((32 * Vt + 255) / 256), 256, 0,
                        (cudaStream_t)stream>>>(
        (const int*)ids, (const int*)nbrt, Vt, Dt, (const int*)colors,
        (const int*)tent, (const int*)prio, (int*)out);
  }
  return (int)cudaGetLastError();
}
