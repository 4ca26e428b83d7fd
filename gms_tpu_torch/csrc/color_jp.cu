// K22 color_jp: strict Jones–Plassmann rounds over the degree buckets.
//
// Replaces gms_tpu/algorithms/coloring.py `_jp_round_tiered` (:106), with
// `_mex_tiered` (:195) and `_pick_tiered` (:162) at k = 0, and the round
// loop that runs it, `_jp_run_tiered` (:272): up to `limit` rounds while a
// vertex of [0, n) is uncolored, each round the buckets in ascending width,
// a later bucket seeing the round's earlier commits.
//
// Within a bucket every read is of the bucket-start colors. Committing
// plainly in place would let a row see a same-bucket neighbour that has
// just been colored and win where gms_tpu's row loses.
//
// decide, a row (ids[r], its neighbour row nbrt[r, :Dt] with a SENTINEL
// tail): an uncolored row wins iff no uncolored neighbour has a strictly
// higher priority; a winner takes the smallest color absent from its
// committed neighbours' colors, found in a used-color bitmask of
// cw = ceil((Dt + 2) / 32) words in shared memory (csrc/color_pick.cuh).
// The row is read up to its first SENTINEL, or up to the 32 (a warp) or
// blockDim (a block) entries that hold its first rival.
//
// Two entries:
//  * color_jp: one bucket, a decide launch (a warp a row, into `dec`: the
//    winner's color, else -1) and a commit launch (colors[ids[r]] = dec[r]
//    where dec[r] >= 0); jp_bucket in coloring.py.
//  * color_jp_run: a whole dispatch of up to `limit` rounds in ONE
//    cooperative launch (cudaLaunchCooperativeKernel, every block resident,
//    the grid from the occupancy calculator). The colors live in 64-bit
//    words for the launch: a color and the stamp of the bucket that wrote
//    it. A winner writes its word in place, stamped with its bucket; the
//    bucket's own decisions read a word of that stamp as uncolored (the
//    vertex was uncolored at the bucket's start), so one grid.sync() a
//    bucket, and no commit pass, separates the buckets. Rows of at most
//    kWideRow entries take a warp each, grid-stride; wider rows a whole
//    block each, the mask in shared memory and the rival test a block-wide
//    OR (the first rounds' tail is the few rows of the widest buckets).
//    A warp loads a row's own words and its first 32 entries' words
//    together, and its next row's id and first entries while it decides
//    this one. Winners are counted a block and a bucket into one of three
//    rotating groups of device words, so every block keeps the same count
//    of each bucket's uncolored rows, skips a bucket that has none (its
//    barrier too), and leaves the loop on the same count with no extra
//    barrier (at once, the rounds counted to the limit, when no bucket has
//    an uncolored row left); the rounds run go to ctl[1]. jp_run in
//    coloring.py.
//
// Bound on an H100 (3.35 TB/s): bytes — the bucket's rows up to the entry
// that decides them, each neighbour's color and priority, the ids and the
// winners' writes. Each neighbour entry costs a dependent gather of two
// words; a warp's lanes stay on consecutive entries of one row so that the
// row read coalesces. In color_jp_run a round costs one grid barrier a
// bucket that still has an uncolored row, not two launches a bucket.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "block_sum.cuh"
#include "color_pick.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRunThreads = 512;
constexpr int kRunWarps = kRunThreads / 32;
constexpr int kWideRow = 1024;     // wider rows take a block in jp_run
constexpr int kMaxBuckets = 64;    // buckets a jp_run launch takes
// resident blocks an SM at most
constexpr int kRunBlocksPerSm = 2;

__host__ __device__ __forceinline__ int color_words(int dt) {
  return (dt + 2 + 31) / 32;
}

// Bucket-start colors read from an int32 array.
struct PlainColors {
  const int* colors;
  __device__ __forceinline__ int operator()(int v) const { return colors[v]; }
};

// Bucket-start colors read from jp_run's stamped words: the low 32 bits a
// color, the high 32 the bucket that wrote it. A vertex colored during the
// current bucket (stamp == now) was uncolored at its start.
struct StampedColors {
  const unsigned long long* words;
  unsigned now;
  __device__ __forceinline__ int operator()(int v) const {
    const unsigned long long x = words[v];
    return (unsigned)(x >> 32) == now ? -1 : (int)(unsigned)x;
  }
};

// A row's id and its first 32 entries (lane-wise), loaded ahead of
// decide_warp, so that a warp's next row loads while it decides this one.
struct RowHead {
  int id, w;
  __device__ __forceinline__ void load(const int* ids, const int* nbrt,
                                       long long r, int Dt, int lane) {
    id = ids[r];
    w = lane < Dt ? nbrt[r * Dt + lane] : color::kSentinel;
  }
};

// One warp decides row r, whose head is loaded: the winner's color, or -1
// (colored already, or a rival outranks it). All lanes return the same
// value.
template <class Colors>
__device__ __forceinline__ int decide_warp(const RowHead& head,
                                           const int* nbrt, long long r,
                                           int Dt, const Colors& colors,
                                           const int* __restrict__ prio,
                                           unsigned* mask, int lane) {
  // the row's own words and its first 32 entries' words load together: one
  // dependent step before the first rival test
  const int* row = nbrt + r * Dt;
  const int id = head.id;
  int w = head.w;
  const int own = colors(id);
  const int vpri = prio[id];
  int c = -1, wpri = 0;
  if (w != color::kSentinel) {
    c = colors(w);
    wpri = prio[w];
  }
  if (own != -1) return -1;
  const int cw = color_words(Dt);
  color::mask_clear(mask, cw, lane);
  const int limit = 32 * cw;
  bool rival = false;
  for (int base = 0;;) {
    if (w != color::kSentinel) {
      if (c == -1) {
        rival |= wpri > vpri;
      } else {
        color::mask_mark(mask, c, limit);
      }
    }
    if (__any_sync(color::kFull, rival || w == color::kSentinel)) break;
    base += 32;
    if (base >= Dt) break;
    const int j = base + lane;
    w = j < Dt ? row[j] : color::kSentinel;
    if (w != color::kSentinel) {
      c = colors(w);
      wpri = prio[w];
    }
  }
  __syncwarp();
  if (__any_sync(color::kFull, rival)) return -1;
  const int pick = color::kth_free(mask, cw, limit, 0, lane);
  return pick < 0 ? 0 : pick;
}

// The whole block decides row r (Dt > kWideRow): the same answer as
// decide_warp. mask holds cw words; every thread returns the answer.
template <class Colors>
__device__ __forceinline__ int decide_block(const int* ids, const int* nbrt,
                                            long long r, int Dt,
                                            const Colors& colors,
                                            const int* __restrict__ prio,
                                            unsigned* mask) {
  __shared__ int first_free;
  const int id = ids[r];
  if (colors(id) != -1) return -1;   // block-uniform
  const int cw = color_words(Dt);
  const int limit = 32 * cw;
  for (int i = threadIdx.x; i < cw; i += blockDim.x) mask[i] = 0u;
  if (threadIdx.x == 0) first_free = limit;
  __syncthreads();
  const int vpri = prio[id];
  const int* row = nbrt + r * Dt;
  bool rival = false;
  for (int base = 0; base < Dt; base += blockDim.x) {
    const int j = base + threadIdx.x;
    const int w = j < Dt ? row[j] : color::kSentinel;
    if (w != color::kSentinel) {
      const int c = colors(w);
      if (c == -1) {
        rival |= prio[w] > vpri;
      } else {
        color::mask_mark(mask, c, limit);
      }
    }
    if (__syncthreads_or(rival || w == color::kSentinel)) break;
  }
  if (__syncthreads_or(rival)) return -1;
  for (int i = threadIdx.x; i < cw; i += blockDim.x) {
    const unsigned fr = ~mask[i] & color::limit_bits(i, limit);
    if (fr) atomicMin(&first_free, i * 32 + __ffs(fr) - 1);
  }
  __syncthreads();
  const int pick = first_free;
  __syncthreads();   // the mask and first_free are free for the next row
  return pick < limit ? pick : 0;
}

__global__ void jp_decide(const int* __restrict__ ids,
                          const int* __restrict__ nbrt, long long Vt, int Dt,
                          const int* __restrict__ colors,
                          const int* __restrict__ prio, int cw, int wpb,
                          int* __restrict__ dec) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * wpb + warp;
  if (r >= Vt) return;
  RowHead head;
  head.load(ids, nbrt, r, Dt, lane);
  const int d = decide_warp(head, nbrt, r, Dt, PlainColors{colors}, prio,
                            smem + (long long)warp * cw, lane);
  if (lane == 0) dec[r] = d;
}

__global__ void jp_commit(const int* __restrict__ ids,
                          const int* __restrict__ dec, long long Vt,
                          int* __restrict__ colors) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r < Vt && dec[r] >= 0) colors[ids[r]] = dec[r];
}

// tab: a bucket a row of 4 int64 (ids, nbrt, Vt, Dt), ascending width,
// nb <= kMaxBuckets. words uint64[n_state] scratch. ctl int64[5 + 4 nb],
// zero on entry: [0] the uncolored vertices of [0, n) at the start, [1] the
// rounds run (written at the end), [2, 2 + nb) each bucket's uncolored rows
// at the start, then three groups of nb + 1 (round r in group r % 3): each
// bucket's winners and the round's winners below n.
__global__ void __launch_bounds__(kRunThreads)
    jp_run_kernel(const long long* __restrict__ tab, int nb, int* colors,
                  long long n_state, const int* __restrict__ prio,
                  long long n, int limit, unsigned long long* words,
                  long long* ctl) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned smem[];
  __shared__ long long rem[kMaxBuckets];   // each bucket's uncolored rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long gwarp = (long long)blockIdx.x * kRunWarps + warp;
  const long long nwarps = (long long)gridDim.x * kRunWarps;
  const long long gtid = (long long)blockIdx.x * kRunThreads + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * kRunThreads;
  long long* const counts = ctl + 2;
  auto group = [&](int g) { return ctl + 2 + nb + g * (nb + 1); };

  // the colors into stamped words (stamp 0); the uncolored of [0, n) and
  // of each bucket's rows (colors is not written before the end)
  long long unc = 0;
  for (long long v = gtid; v < n_state; v += nthreads) {
    const int c = colors[v];
    words[v] = (unsigned)c;
    unc += v < n && c == -1;
  }
  add_block_sum(unc, ctl);
  for (int t = 0; t < nb; ++t) {
    const int* ids = reinterpret_cast<const int*>(tab[4 * t]);
    long long open = 0;
    for (long long row = gtid; row < tab[4 * t + 2]; row += nthreads)
      open += colors[ids[row]] == -1;
    add_block_sum(open, counts + t);
  }
  grid.sync();
  if (threadIdx.x < nb)
    rem[threadIdx.x] =
        *reinterpret_cast<const volatile long long*>(counts + threadIdx.x);
  long long left = block_read(ctl);

  // bucket (r, t) stamps its winners' words r * nb + t + 1: a commit in
  // place that the bucket's own decisions read as uncolored, so one barrier
  // a bucket separates a bucket's decisions from the next one's reads. A
  // bucket with no uncolored row is skipped, barrier and all, by every
  // block alike (rem is the same in each)
  int r = 0;
  unsigned now = 0;
  while (r < limit && left > 0) {
    int last = -1;
    for (int t = 0; t < nb; ++t)
      if (rem[t] > 0) last = t;
    // no bucket has an uncolored row while a vertex of [0, n) is uncolored
    // (the tiers do not cover it): no later round colors anything, and the
    // plain loop runs on to the limit. Leaving here keeps a barrier in every
    // round run, which the rotation of the groups below relies on
    if (last < 0) {
      r = limit;
      break;
    }
    long long* const wins = group(r % 3);
    // round r + 1's group: every block read it (as round r - 2's) before
    // round r - 1's first barrier, and round r + 1 adds to it after this
    // round's last one
    if (blockIdx.x == 0 && threadIdx.x <= nb)
      group((r + 1) % 3)[threadIdx.x] = 0;
    long long below_n = 0;   // lane 0 (a warp row), thread 0 (a block row)
    for (int t = 0; t < nb; ++t) {
      ++now;
      if (rem[t] == 0) continue;
      const int* ids = reinterpret_cast<const int*>(tab[4 * t]);
      const int* nbrt = reinterpret_cast<const int*>(tab[4 * t + 1]);
      const long long Vt = tab[4 * t + 2];
      const int Dt = (int)tab[4 * t + 3];
      const StampedColors seen{words, now};
      long long won = 0;
      if (Dt > kWideRow) {
        for (long long row = blockIdx.x; row < Vt; row += gridDim.x) {
          const int d = decide_block(ids, nbrt, row, Dt, seen, prio, smem);
          if (threadIdx.x == 0 && d >= 0) {
            const int id = ids[row];
            words[id] = (unsigned long long)now << 32 | (unsigned)d;
            ++won;
            below_n += id < n;
          }
        }
      } else {
        unsigned* mask = smem + warp * color_words(Dt);
        RowHead next;
        if (gwarp < Vt) next.load(ids, nbrt, gwarp, Dt, lane);
        for (long long row = gwarp; row < Vt; row += nwarps) {
          const RowHead head = next;
          if (row + nwarps < Vt) next.load(ids, nbrt, row + nwarps, Dt, lane);
          const int d = decide_warp(head, nbrt, row, Dt, seen, prio, mask,
                                    lane);
          if (lane == 0 && d >= 0) {
            words[head.id] = (unsigned long long)now << 32 | (unsigned)d;
            ++won;
            below_n += head.id < n;
          }
        }
      }
      add_block_sum(won, wins + t);
      if (t == last) add_block_sum(below_n, wins + nb);
      grid.sync();
    }
    if (threadIdx.x < nb && rem[threadIdx.x] > 0)
      rem[threadIdx.x] -=
          *reinterpret_cast<const volatile long long*>(wins + threadIdx.x);
    left -= block_read(wins + nb);
    ++r;
  }
  for (long long v = gtid; v < n_state; v += nthreads)
    colors[v] = (int)(unsigned)words[v];
  if (blockIdx.x == 0 && threadIdx.x == 0) ctl[1] = r;
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

// tab int64[nb, 4] on the card (see jp_run_kernel), nb <= 64, colors and
// prio as above (n_state slots), words uint64[n_state] scratch, ctl
// int64[5 + 4 nb] zeroed; max_dt the widest bucket's Dt. Returns
// cudaErrorCooperativeLaunchTooLarge when no block fits.
extern "C" int color_jp_run(const void* tab, int nb, void* colors,
                            long long n_state, const void* prio, long long n,
                            int limit, int max_dt, void* words, void* ctl,
                            void* stream) {
  if (nb < 0 || nb > kMaxBuckets) return (int)cudaErrorInvalidValue;
  const int cw = color_words(max_dt);
  const int warp_words = kRunWarps * (max_dt > kWideRow ? color_words(kWideRow)
                                                         : cw);
  const size_t smem = sizeof(unsigned) * (size_t)(cw > warp_words ? cw
                                                                  : warp_words);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(jp_run_kernel,
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
           &per_sm, jp_run_kernel, kRunThreads, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm > kRunBlocksPerSm) per_sm = kRunBlocksPerSm;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long* t = (const long long*)tab;
  int* c = (int*)colors;
  const int* p = (const int*)prio;
  unsigned long long* w = (unsigned long long*)words;
  long long* k = (long long*)ctl;
  void* args[] = {&t, &nb, &c, &n_state, &p, &n, &limit, &w, &k};
  e = cudaLaunchCooperativeKernel((const void*)jp_run_kernel,
                                  dim3(per_sm * sms), dim3(kRunThreads), args,
                                  smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
