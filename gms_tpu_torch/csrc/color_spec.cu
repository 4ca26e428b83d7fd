// K23 color_spec: the speculative Jones–Plassmann rounds over the degree
// buckets.
//
// Replaces gms_tpu/algorithms/coloring.py `_spec_round_tiered` (:202-253)
// and the loop that runs it, `_spec_run_tiered` (:257-269). A round has
// three passes, each over every bucket:
//   pick  (pass 1, :219-225): an uncolored row's pick0 is the mex of its
//         committed neighbours' colors; a colored row's is -2;
//   rank  (pass 2, :226-240): k = the number of neighbours whose pick0
//         equals the row's and whose priority is strictly higher, capped at
//         31 (_SPEC_RANK_CAP); an uncolored row's tent is the k-th (0-based)
//         color absent from its committed neighbours'; a colored row's its
//         color;
//   clash (pass 3, :241-253): an uncolored row keeps its tent unless a
//         neighbour with a strictly higher priority holds the same tent,
//         else it stays uncolored; a colored row keeps its color.
// Each pass reads only the round-start colors and the previous pass's
// buffer and writes a fresh one (pick0, tent, out), so neither the order of
// rows nor that of buckets within a pass matters.
//
// Two kinds of entry:
//  * spec_pick, spec_rank, spec_clash: one pass over ONE bucket, a warp a
//    row (spec_pick / spec_rank / spec_clash in coloring.py; no entry point
//    runs them, they hold each pass apart);
//  * color_spec_run: a whole dispatch, up to `limit` rounds while a vertex
//    of [0, n) is uncolored, in ONE cooperative launch
//    (cudaLaunchCooperativeKernel, every block resident, the grid from the
//    occupancy calculator, as color_jp.cu's jp_run): pick over all buckets,
//    grid.sync(), rank, grid.sync(), clash, grid.sync(); clash's output is
//    the next round's colors (two buffers in turn). spec_run in
//    coloring.py.
//
// No copies a round: gms_tpu starts pick0, tent and out as the round-start
// colors in every slot (`pick0 = colors`), and a pass writes every tier row,
// colored ones too. So a slot outside the tiers (the dump slot n, and in a
// frontier dispatch every colored vertex) holds the round-start color in
// all of them, and that color never changes within a dispatch: one copy of
// the colors into the three buffers at the launch's start stands for the
// copies of every round.
//
// The loop's condition is gms_tpu's, any(colors[:n] == -1) & (r < limit),
// counted from the colors: the uncolored vertices of [0, n) at the start
// less those that are tier rows (ids below n; the tier rows are distinct
// vertices, as _TierGraph builds them) are the ones no pass writes, a
// constant; each round's clash adds the tier rows still uncolored. Tiers
// that leave an uncolored vertex out run to the limit, as gms_tpu does.
// Every block adds its share to one of three rotating groups of device
// counts and reads the sum after the round's last barrier, so every block
// leaves the loop on the same round.
//
// Rows of at most kWideRow entries take a warp each: a lane loads
// kRowUnroll entries of the row, then gathers their state words, so the
// gathers of a row overlap, and finds the SENTINEL by a ballot after the
// loads; the used-color mask of cw = ceil((Dt + 2) / 32) words is the
// warp's in shared memory (csrc/color_pick.cuh). A row's id and its first
// 32 entries load together. Wider rows (the first rounds' tail: the few
// rows of the widest buckets) take a whole block each in color_spec_run:
// the mask in shared memory, k a block sum, clash a block-wide OR with
// early exit; the blocks take the wide buckets first in each pass, then
// all warps take the narrow rows of the buckets in descending width.
//
// The state buffers are written within the launch and read after a grid
// barrier, so they are read by plain loads, never through the read-only
// (non-coherent) path that a const __restrict__ pointer would allow.
//
// Bound on an H100 (3.35 TB/s): bytes — each pass's rows up to the entry
// that decides them, each neighbour's color, pick0 or tent and priority
// where the function needs it, the ids and the writes, every round.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "block_sum.cuh"
#include "color_pick.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRankCap = 31;
constexpr int kRowUnroll = 4;      // 32-entry chunks of a row in flight
constexpr int kRunThreads = 512;
constexpr int kRunWarps = kRunThreads / 32;
constexpr int kWideRow = 1024;     // wider rows take a block in spec_run
constexpr int kMaxBuckets = 64;    // buckets a spec_run launch takes
constexpr int kRunBlocksPerSm = 2; // resident blocks an SM at most

__host__ __device__ __forceinline__ int color_words(int dt) {
  return (dt + 2 + 31) / 32;
}

// A warp's row: its kRowUnroll chunks from `base`, the first chunk given
// where base is 0 (loaded with the row's id).
__device__ __forceinline__ void row_chunks(const int* row, int Dt, int base,
                                          int w0, int lane,
                                          int (&w)[kRowUnroll]) {
#pragma unroll
  for (int q = 0; q < kRowUnroll; ++q) {
    const int j = base + 32 * q + lane;
    w[q] = base == 0 && q == 0 ? w0
                               : (j < Dt ? row[j] : color::kSentinel);
  }
}

// Pass 1, an uncolored row, one warp: the mex of its neighbours' colors.
__device__ __forceinline__ int pick_warp(const int* row, int Dt, int w0,
                                         const int* colors,
                                         unsigned* mask, int lane) {
  const int cw = color_words(Dt), limit = 32 * cw;
  color::mask_clear(mask, cw, lane);
  for (int base = 0; base < Dt; base += 32 * kRowUnroll) {
    int w[kRowUnroll], c[kRowUnroll];
    row_chunks(row, Dt, base, w0, lane, w);
    bool end = false;
#pragma unroll
    for (int q = 0; q < kRowUnroll; ++q) {
      c[q] = w[q] != color::kSentinel ? colors[w[q]] : -1;
      end |= w[q] == color::kSentinel;
    }
#pragma unroll
    for (int q = 0; q < kRowUnroll; ++q) color::mask_mark(mask, c[q], limit);
    if (__any_sync(color::kFull, end)) break;
  }
  __syncwarp();
  const int pick = color::kth_free(mask, cw, limit, 0, lane);
  return pick < 0 ? 0 : pick;
}

// Pass 2, an uncolored row (pick vpk, priority vpri), one warp: the k-th
// free color, k its higher-priority neighbours with the same pick (<= 31).
__device__ __forceinline__ int rank_warp(const int* row, int Dt, int w0,
                                         const int* colors,
                                         const int* pick0,
                                         const int* __restrict__ prio,
                                         int vpk, int vpri, unsigned* mask,
                                         int lane) {
  const int cw = color_words(Dt), limit = 32 * cw;
  color::mask_clear(mask, cw, lane);
  int k = 0;
  for (int base = 0; base < Dt; base += 32 * kRowUnroll) {
    int w[kRowUnroll], c[kRowUnroll], pk[kRowUnroll];
    row_chunks(row, Dt, base, w0, lane, w);
    bool end = false;
#pragma unroll
    for (int q = 0; q < kRowUnroll; ++q) {
      const bool ok = w[q] != color::kSentinel;
      c[q] = ok ? colors[w[q]] : -1;
      pk[q] = ok ? pick0[w[q]] : vpk - 1;
      end |= !ok;
    }
#pragma unroll
    for (int q = 0; q < kRowUnroll; ++q) {
      k += pk[q] == vpk && prio[w[q]] > vpri;
      color::mask_mark(mask, c[q], limit);
    }
    if (__any_sync(color::kFull, end)) break;
  }
  for (int o = 16; o > 0; o >>= 1) k += __shfl_xor_sync(color::kFull, k, o);
  __syncwarp();
  const int pick = color::kth_free(mask, cw, limit, k < kRankCap ? k
                                                                 : kRankCap,
                                   lane);
  return pick < 0 ? 0 : pick;
}

// Pass 3, an uncolored row (tent vten, priority vpri), one warp: whether a
// higher-priority neighbour holds the same tent. All lanes get the answer.
__device__ __forceinline__ bool clash_warp(const int* row, int Dt, int w0,
                                           const int* tent,
                                           const int* __restrict__ prio,
                                           int vten, int vpri) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < Dt; base += 32 * kRowUnroll) {
    int w[kRowUnroll], t[kRowUnroll];
    row_chunks(row, Dt, base, w0, lane, w);
    bool end = false, lose = false;
#pragma unroll
    for (int q = 0; q < kRowUnroll; ++q) {
      const bool ok = w[q] != color::kSentinel;
      t[q] = ok ? tent[w[q]] : vten - 1;
      end |= !ok;
    }
#pragma unroll
    for (int q = 0; q < kRowUnroll; ++q)
      lose |= t[q] == vten && prio[w[q]] > vpri;
    if (__any_sync(color::kFull, lose)) return true;
    if (__any_sync(color::kFull, end)) break;
  }
  return false;
}

// One pass over row r of a bucket, one warp; the row's head (its id and
// first 32 entries) is loaded here. Returns 1 where a clash leaves a row of
// id below n uncolored (the loop's count), else 0; all lanes alike.
template <int kPass>
__device__ __forceinline__ int pass_warp(const int* ids, const int* nbrt,
                                         long long r, int Dt,
                                         const int* colors,
                                         const int* pick0,
                                         const int* tent,
                                         const int* __restrict__ prio,
                                         int* out, long long n,
                                         unsigned* mask, int lane) {
  const int* row = nbrt + r * Dt;
  const int id = ids[r];
  const int w0 = lane < Dt ? row[lane] : color::kSentinel;
  const int vcol = colors[id];
  if (kPass == 0) {
    const int p = vcol != -1 ? -2 : pick_warp(row, Dt, w0, colors, mask, lane);
    if (lane == 0) out[id] = p;
    return 0;
  } else if (kPass == 1) {
    int t = vcol;
    if (vcol == -1)
      t = rank_warp(row, Dt, w0, colors, pick0, prio, pick0[id], prio[id],
                    mask, lane);
    if (lane == 0) out[id] = t;
    return 0;
  } else {
    if (vcol != -1) {
      if (lane == 0) out[id] = vcol;
      return 0;
    }
    const int vten = tent[id];
    const bool lose = clash_warp(row, Dt, w0, tent, prio, vten, prio[id]);
    if (lane == 0) out[id] = lose ? -1 : vten;
    return lose && id < n;
  }
}

// One pass over row r of a bucket, the whole block (Dt > kWideRow): the
// same answer as pass_warp. mask holds cw words.
template <int kPass>
__device__ __forceinline__ int pass_block(const int* ids, const int* nbrt,
                                          long long r, int Dt,
                                          const int* colors,
                                          const int* pick0,
                                          const int* tent,
                                          const int* __restrict__ prio,
                                          int* out, long long n,
                                          unsigned* mask) {
  __shared__ int rank_k;
  const int* row = nbrt + r * Dt;
  const int id = ids[r];
  const int vcol = colors[id];   // block-uniform
  if (vcol != -1) {
    if (threadIdx.x == 0) out[id] = kPass == 0 ? -2 : vcol;
    return 0;
  }
  const int cw = color_words(Dt), limit = 32 * cw;
  const int vpri = prio[id];
  const int vown = kPass == 1 ? pick0[id] : (kPass == 2 ? tent[id] : 0);
  if (kPass != 2) {
    for (int i = threadIdx.x; i < cw; i += blockDim.x) mask[i] = 0u;
    if (threadIdx.x == 0) rank_k = 0;
    __syncthreads();
  }
  int k = 0;
  bool lose = false;
  const int step = blockDim.x * kRowUnroll;
  for (int base = 0; base < Dt; base += step) {
    int w[kRowUnroll], s[kRowUnroll];
    bool end = false;
#pragma unroll
    for (int q = 0; q < kRowUnroll; ++q) {
      const int j = base + q * blockDim.x + threadIdx.x;
      w[q] = j < Dt ? row[j] : color::kSentinel;
    }
#pragma unroll
    for (int q = 0; q < kRowUnroll; ++q) {
      const bool ok = w[q] != color::kSentinel;
      s[q] = ok ? (kPass == 2 ? tent[w[q]] : colors[w[q]]) : -1;
      end |= !ok;
    }
#pragma unroll
    for (int q = 0; q < kRowUnroll; ++q) {
      if (w[q] == color::kSentinel) continue;
      if (kPass == 2) {
        lose |= s[q] == vown && prio[w[q]] > vpri;
      } else {
        if (kPass == 1) k += pick0[w[q]] == vown && prio[w[q]] > vpri;
        color::mask_mark(mask, s[q], limit);
      }
    }
    if (__syncthreads_or(lose || end)) break;
  }
  int result;
  if (kPass == 2) {
    lose = __syncthreads_or(lose);
    result = lose ? -1 : vown;
  } else {
    if (kPass == 1 && k) atomicAdd(&rank_k, k);
    __syncthreads();
    const int kk = kPass == 1 ? rank_k : 0;
    result = color::block_kth_free(mask, cw, limit,
                                   kk < kRankCap ? kk : kRankCap);
  }
  if (threadIdx.x == 0) out[id] = result;
  return kPass == 2 && lose && id < n;
}

__global__ void spec_pass_kernel(int pass, const int* __restrict__ ids,
                                 const int* __restrict__ nbrt, long long Vt,
                                 int Dt, const int* colors,
                                 const int* pick0,
                                 const int* tent,
                                 const int* __restrict__ prio, int wpb,
                                 int* out) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * wpb + warp;
  if (r >= Vt) return;
  unsigned* mask = smem + (long long)warp * color_words(Dt);
  const long long n = 0;   // no count
  if (pass == 0)
    pass_warp<0>(ids, nbrt, r, Dt, colors, pick0, tent, prio, out, n, mask,
                 lane);
  else if (pass == 1)
    pass_warp<1>(ids, nbrt, r, Dt, colors, pick0, tent, prio, out, n, mask,
                 lane);
  else
    pass_warp<2>(ids, nbrt, r, Dt, colors, pick0, tent, prio, out, n, mask,
                 lane);
}

int launch_pass(int pass, const void* ids, const void* nbrt, long long Vt,
                int Dt, const void* colors, const void* pick0,
                const void* tent, const void* prio, void* out, void* stream) {
  if (Vt > 0) {
    int wpb = 0;
    const int smem = color::prepare_smem(spec_pass_kernel, color_words(Dt),
                                         &wpb);
    if (smem < 0) return (int)cudaErrorInvalidValue;
    spec_pass_kernel<<<(unsigned)((Vt + wpb - 1) / wpb), 32 * wpb, smem,
                       (cudaStream_t)stream>>>(
        pass, (const int*)ids, (const int*)nbrt, Vt, Dt, (const int*)colors,
        (const int*)pick0, (const int*)tent, (const int*)prio, wpb,
        (int*)out);
  }
  return (int)cudaGetLastError();
}

// A bucket of the dispatch, cached in shared memory by every block.
struct Bucket {
  const int* ids;
  const int* nbrt;
  long long vt;
  int dt;
};

// One pass of a round over every bucket: the wide rows (Dt > kWideRow) a
// block each, the widest bucket first; then every warp on the narrow rows,
// the buckets in descending width as one run of rows, grid-stride. Returns
// this thread's count of rows left uncolored (clash only).
template <int kPass>
__device__ long long run_pass(const Bucket* bk, int nb,
                              const int* colors,
                              const int* pick0,
                              const int* tent,
                              const int* __restrict__ prio,
                              int* out, long long n,
                              unsigned* smem, int cw_narrow) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long left = 0;
  // wide rows, one run over the wide buckets, a block a row
  {
    long long start = 0;
    int t = nb - 1;
    for (long long i = blockIdx.x;; i += gridDim.x) {
      while (t >= 0 && (bk[t].dt <= kWideRow || i >= start + bk[t].vt)) {
        if (bk[t].dt > kWideRow) start += bk[t].vt;
        --t;
      }
      if (t < 0) break;
      const int d = pass_block<kPass>(bk[t].ids, bk[t].nbrt, i - start,
                                      bk[t].dt, colors, pick0, tent, prio,
                                      out, n, smem);
      if (threadIdx.x == 0) left += d;
    }
  }
  // narrow rows, a warp a row
  unsigned* mask = smem + warp * cw_narrow;
  long long start = 0;
  int t = nb - 1;
  for (long long i = (long long)blockIdx.x * kRunWarps + warp;;
       i += (long long)gridDim.x * kRunWarps) {
    while (t >= 0 && (bk[t].dt > kWideRow || i >= start + bk[t].vt)) {
      if (bk[t].dt <= kWideRow) start += bk[t].vt;
      --t;
    }
    if (t < 0) break;
    const int d = pass_warp<kPass>(bk[t].ids, bk[t].nbrt, i - start,
                                   bk[t].dt, colors, pick0, tent, prio, out,
                                   n, mask, lane);
    if (lane == 0) left += d;
  }
  return left;
}

// tab: a bucket a row of 4 int64 (ids, nbrt, Vt, Dt), nb <= kMaxBuckets.
// colors int32[n_state] (in place), scratch int32[3, n_state] (the other
// colors buffer, pick0, tent). ctl int64[6], zero on entry: [0] the
// uncolored vertices of [0, n) at the start, [1] the rounds run (written
// at the end), [2] the uncolored tier rows of id below n at the start,
// [3, 6) the tier rows left uncolored by round r in [3 + r % 3].
__global__ void __launch_bounds__(kRunThreads, kRunBlocksPerSm)
    spec_run_kernel(const long long* __restrict__ tab, int nb, int* colors,
                    int* scratch, long long n_state,
                    const int* __restrict__ prio, long long n, int limit,
                    int cw_narrow, long long* ctl) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned smem[];
  __shared__ Bucket bk[kMaxBuckets];
  const long long gtid = (long long)blockIdx.x * kRunThreads + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * kRunThreads;
  int* const other = scratch;
  int* const pick0 = scratch + n_state;
  int* const tent = scratch + 2 * n_state;
  if (threadIdx.x < nb) {
    const long long* e = tab + 4 * threadIdx.x;
    bk[threadIdx.x] = {reinterpret_cast<const int*>(e[0]),
                       reinterpret_cast<const int*>(e[1]), e[2], (int)e[3]};
  }
  // the round-start colors into the other buffer, pick0 and tent (a slot
  // outside the tiers keeps its color there all dispatch, see the header)
  long long unc = 0;
  for (long long v = gtid; v < n_state; v += nthreads) {
    const int c = colors[v];
    other[v] = pick0[v] = tent[v] = c;
    unc += v < n && c == -1;
  }
  add_block_sum(unc, ctl);
  long long tier_unc = 0;
  for (int t = 0; t < nb; ++t)
    for (long long r = gtid; r < bk[t].vt; r += nthreads) {
      const int id = bk[t].ids[r];
      tier_unc += id < n && colors[id] == -1;
    }
  add_block_sum(tier_unc, ctl + 2);
  grid.sync();
  long long left = block_read(ctl);
  const long long outside = left - block_read(ctl + 2);
  int* cur = colors;
  int* nxt = other;
  int r = 0;
  while (r < limit && left > 0) {
    long long* const group = ctl + 3 + r % 3;
    // round r + 1's group: every block read it (as round r - 2's) before
    // round r - 1's first barrier; round r + 1 adds to it after this
    // round's last one
    if (blockIdx.x == 0 && threadIdx.x == 0) ctl[3 + (r + 1) % 3] = 0;
    run_pass<0>(bk, nb, cur, pick0, tent, prio, pick0, n, smem, cw_narrow);
    grid.sync();
    run_pass<1>(bk, nb, cur, pick0, tent, prio, tent, n, smem, cw_narrow);
    grid.sync();
    const long long still =
        run_pass<2>(bk, nb, cur, pick0, tent, prio, nxt, n, smem, cw_narrow);
    add_block_sum(still, group);
    grid.sync();
    left = outside + block_read(group);
    int* const swap = cur;
    cur = nxt;
    nxt = swap;
    ++r;
  }
  if (cur != colors)
    for (long long v = gtid; v < n_state; v += nthreads) colors[v] = cur[v];
  if (blockIdx.x == 0 && threadIdx.x == 0) ctl[1] = r;
}

}  // namespace

// ids int32[Vt], nbrt int32[Vt, Dt]; colors, prio and the outputs int32[n + 1].
extern "C" int spec_pick(const void* ids, const void* nbrt, long long Vt,
                         int Dt, const void* colors, void* pick0,
                         void* stream) {
  return launch_pass(0, ids, nbrt, Vt, Dt, colors, nullptr, nullptr, nullptr,
                     pick0, stream);
}

extern "C" int spec_rank(const void* ids, const void* nbrt, long long Vt,
                         int Dt, const void* colors, const void* pick0,
                         const void* prio, void* tent, void* stream) {
  return launch_pass(1, ids, nbrt, Vt, Dt, colors, pick0, nullptr, prio, tent,
                     stream);
}

extern "C" int spec_clash(const void* ids, const void* nbrt, long long Vt,
                          int Dt, const void* colors, const void* tent,
                          const void* prio, void* out, void* stream) {
  return launch_pass(2, ids, nbrt, Vt, Dt, colors, nullptr, tent, prio, out,
                     stream);
}

// tab int64[nb, 4] on the card (see spec_run_kernel), nb <= 64, colors and
// prio int32[n_state] (the dump slot n colored 0 and of priority 0),
// scratch int32[3, n_state], ctl int64[6] zeroed; max_dt the widest
// bucket's Dt. Returns cudaErrorCooperativeLaunchTooLarge when no block
// fits.
extern "C" int color_spec_run(const void* tab, int nb, void* colors,
                              void* scratch, long long n_state,
                              const void* prio, long long n, int limit,
                              int max_dt, void* ctl, void* stream) {
  if (nb < 0 || nb > kMaxBuckets) return (int)cudaErrorInvalidValue;
  int cw_narrow = color_words(max_dt < kWideRow ? max_dt : kWideRow);
  const int cw_wide = max_dt > kWideRow ? color_words(max_dt) : 0;
  const int words = kRunWarps * cw_narrow;
  const size_t smem =
      sizeof(unsigned) * (size_t)(cw_wide > words ? cw_wide : words);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(spec_run_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, spec_run_kernel, kRunThreads, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm > kRunBlocksPerSm) per_sm = kRunBlocksPerSm;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long* t = (const long long*)tab;
  int* c = (int*)colors;
  int* s = (int*)scratch;
  const int* p = (const int*)prio;
  long long* k = (long long*)ctl;
  void* args[] = {&t, &nb, &c, &s, &n_state, &p, &n, &limit, &cw_narrow, &k};
  e = cudaLaunchCooperativeKernel((const void*)spec_run_kernel,
                                  dim3(per_sm * sms), dim3(kRunThreads), args,
                                  smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
