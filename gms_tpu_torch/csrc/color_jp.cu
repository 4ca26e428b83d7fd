// K22 color_jp: one strict Jones–Plassmann round over ONE degree bucket.
//
// Replaces gms_tpu/algorithms/coloring.py `_jp_round_tiered` (:106) for one
// tier, with `_mex_tiered` (:195) and `_pick_tiered` (:162) at k = 0. The
// wrapper launches it once per bucket in ascending width, so a later bucket
// sees this round's earlier commits, as gms_tpu's loop over its tiers does.
//
// Within a bucket every read is of the bucket-start colors: the entry runs
// two kernels on the stream, decide (into `dec`, one slot a row) and then
// commit (colors[ids[r]] = dec[r]). Committing in place would let a row see a
// same-bucket neighbour that has just been colored and win where gms_tpu's
// row loses.
//
// decide: a warp a row (ids[r], its neighbour row nbrt[r, :Dt] with a
// SENTINEL tail). An uncolored row wins iff no uncolored neighbour has a
// strictly higher priority; a winner takes the smallest color absent from
// its committed neighbours' colors, found in a used-color bitmask of
// cw = ceil((Dt + 2) / 32) words in shared memory (csrc/color_pick.cuh).
// The row is read once, up to its first SENTINEL.
//
// Bound on an H100 (3.35 TB/s): bytes — the bucket's rows up to their
// SENTINEL, each neighbour's color and priority, the ids, dec and the
// commit's reads and writes. Each neighbour entry costs a dependent gather
// of two words; the design keeps a warp's lanes on consecutive entries of
// one row so that the row read coalesces.

#include <cuda_runtime.h>

#include "color_pick.cuh"

namespace {

__global__ void jp_decide(const int* __restrict__ ids,
                          const int* __restrict__ nbrt, long long Vt, int Dt,
                          const int* __restrict__ colors,
                          const int* __restrict__ prio, int cw, int wpb,
                          int* __restrict__ dec) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * wpb + warp;
  if (r >= Vt) return;
  const int id = ids[r];
  const int vcol = colors[id];
  if (vcol != -1) {
    if (lane == 0) dec[r] = vcol;
    return;
  }
  unsigned* mask = smem + (long long)warp * cw;
  color::mask_clear(mask, cw, lane);
  const int vpri = prio[id];
  const int limit = 32 * cw;
  const int* row = nbrt + r * Dt;
  bool rival = false;
  for (int j = lane; j < Dt; j += 32) {
    const int w = row[j];
    if (w == color::kSentinel) break;
    const int c = colors[w];
    if (c == -1) {
      rival |= prio[w] > vpri;
    } else {
      color::mask_mark(mask, c, limit);
    }
  }
  __syncwarp();
  if (__any_sync(color::kFull, rival)) {
    if (lane == 0) dec[r] = -1;
    return;
  }
  const int pick = color::kth_free(mask, cw, limit, 0, lane);
  if (lane == 0) dec[r] = pick < 0 ? 0 : pick;
}

__global__ void jp_commit(const int* __restrict__ ids,
                          const int* __restrict__ dec, long long Vt,
                          int* __restrict__ colors) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r < Vt) colors[ids[r]] = dec[r];
}

}  // namespace

// ids int32[Vt], nbrt int32[Vt, Dt], colors and prio int32[n + 1] (the dump
// slot n colored 0 and of priority 0), dec int32[Vt] scratch.
extern "C" int color_jp(const void* ids, const void* nbrt, long long Vt,
                        int Dt, void* colors, const void* prio, int cw,
                        void* dec, void* stream) {
  if (Vt > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    int wpb = 0;
    const int smem = color::prepare_smem(jp_decide, cw, &wpb);
    if (smem < 0) return (int)cudaErrorInvalidValue;
    jp_decide<<<(unsigned)((Vt + wpb - 1) / wpb), 32 * wpb, smem, s>>>(
        (const int*)ids, (const int*)nbrt, Vt, Dt, (const int*)colors,
        (const int*)prio, cw, wpb, (int*)dec);
    jp_commit<<<(unsigned)((Vt + 255) / 256), 256, 0, s>>>(
        (const int*)ids, (const int*)dec, Vt, (int*)colors);
  }
  return (int)cudaGetLastError();
}
