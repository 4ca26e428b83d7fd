// K2 and_popcount: Σ over hub groups g, slots k of popcount(A[g,k,:W] & B[g,:W])
// for the wide (hub-bitmap) edges of the triangle-count plan.
//
// Replaces two device programs of gms_tpu/algorithms/triangle_count.py:
//   * count_hub_groups_mat (:359) — stream mode: b_mat[G, W] holds each
//     group's head row, a_mat[G, K, W] its K partner rows, pre-gathered;
//   * count_hub_groups (:239)     — gather mode: rows[*, :W] of the hub bitmap
//     table (row stride HW), addressed through b_ids[G] and nbrs[G, K].
// Bit words arrive as int32 tensors holding gms_tpu's uint32 bits and are
// read here as unsigned. gms_tpu's `salt` (a guard against its platform
// memoizing repeated runs) has no purpose under CUDA and is dropped.
//
// Design: a persistent grid (the blocks an SM that fit, times the SMs), a
// warp a group, the warps taking groups by a grid stride and each lane
// keeping its sum in a register across groups; one block reduction and one
// atomicAdd a block at the end. A warp stages its group's head row in shared
// memory, a window of up to 1,024 words at a time, keeping only its non-zero
// chunks (16 bytes, or a word where 16-byte loads do not fit) and their
// offsets, listed by a ballot and a prefix count. It then reads each partner
// row only at those chunks, lanes on consecutive chunks of one row: a zero
// head chunk adds nothing whatever the partner holds, so a group whose head
// is all zero reads no partner. Slots that add nothing are not read: in
// gather mode the slots on the guard row (the table's last row, when its
// prefix is all zero: each block checks), in stream mode the slots at and
// past live[g] (the plan's count of each group's leading non-guard slots;
// their rows are all zero). Chunks are uint4 loads, four __popc a load,
// where W, the row stride and the bases allow 16-byte alignment (every RMAT
// tier: W = 16 ... 256 and hw = 532); otherwise the same kernel reads words.
//
// Bound on an H100 (3.35 TB/s), the function's own: each non-guard head row
// once at W words, each partner slot that is not a guard only at the
// 32-byte sectors where its head is non-zero (gather: each distinct
// (partner row, sector) pair once), and the index arrays.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 32 * 2;  // slots a warp lists at once (gather mode)
constexpr unsigned kFull = 0xffffffffu;

// A chunk of V bit words: one uint4 or one word.
template <int V>
struct Chunk;

template <>
struct Chunk<4> {
  using T = uint4;
  static __device__ __forceinline__ T load(const unsigned* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ bool any(T c) {
    return (c.x | c.y | c.z | c.w) != 0;
  }
  static __device__ __forceinline__ unsigned popc_and(T a, T b) {
    return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
           __popc(a.w & b.w);
  }
};

template <>
struct Chunk<1> {
  using T = unsigned;
  static __device__ __forceinline__ T load(const unsigned* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ bool any(T c) { return c != 0; }
  static __device__ __forceinline__ unsigned popc_and(T a, T b) {
    return __popc(a & b);
  }
};

// Head chunks a warp stages at once: 1,024 words with 16-byte chunks, 512
// with words (5 KB, 4 KB of shared memory a warp).
template <int V>
__host__ __device__ constexpr int window_chunks() {
  return V == 4 ? 256 : 512;
}

// Shared bytes a warp uses, a multiple of 16.
template <int V>
int warp_bytes(int W) {
  const int chunks = (W + V - 1) / V;
  const int win = chunks < window_chunks<V>() ? chunks : window_chunks<V>();
  const int b = win * (int)(sizeof(typename Chunk<V>::T) + sizeof(int)) +
                kSlots * (int)sizeof(int);
  return (b + 15) & ~15;
}

struct Groups {
  const unsigned* head;   // stream: b[G, W]; gather: the row table
  const unsigned* part;   // stream: a[G, K, W]; gather: the row table
  const int* b_ids;       // gather: head row of each group
  const int* nbrs;        // gather: partner rows [G, K]
  const int* live;        // stream: leading non-guard slots a group, or null
  long long G, hw;        // gather: row stride in words
  int K, W, guard;        // gather: the guard row's index
};

// Lists the partner rows of this warp's slots [k0, k0 + kSlots) in `slot`,
// the guard's left out where skip_guard; returns how many.
__device__ __forceinline__ int list_slots(const Groups& p, long long g, int k0,
                                          bool skip_guard, int* slot,
                                          int lane) {
  int n = 0;
  for (int s = 0; s < kSlots; s += 32) {
    const int k = k0 + s + lane;
    const int id = k < p.K ? p.nbrs[g * p.K + k] : p.guard;
    const bool keep = k < p.K && !(skip_guard && id == p.guard);
    const unsigned bal = __ballot_sync(kFull, keep);
    if (keep) slot[n + __popc(bal & ((1u << lane) - 1))] = id;
    n += __popc(bal);
  }
  __syncwarp();
  return n;
}

template <int V, bool kGather>
__global__ void __launch_bounds__(kThreads)
    hub_groups_kernel(Groups p, int warp_stride_bytes,
                      unsigned long long* out) {
  using C = Chunk<V>;
  using T = typename C::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nch = p.W / V;  // the host picks V dividing W
  const int win = nch < window_chunks<V>() ? nch : window_chunks<V>();
  T* head = reinterpret_cast<T*>(smem + warp * warp_stride_bytes);
  int* at = reinterpret_cast<int*>(head + win);
  int* slot = at + win;  // gather: kSlots partner rows

  // gather: slots on the guard row add nothing when its prefix is zero
  bool skip_guard = false;
  if (kGather) {
    const unsigned* grow = p.part + (long long)p.guard * p.hw;
    unsigned any = 0;
    for (int w = threadIdx.x; w < p.W; w += kThreads) any |= grow[w];
    skip_guard = !__syncthreads_or(any != 0);
  }

  unsigned long long acc = 0;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long g = blockIdx.x * (long long)kWarps + warp; g < p.G;
       g += stride) {
    const unsigned* hrow;
    int live = p.K;
    if (kGather) {
      const int b = p.b_ids[g];
      if (skip_guard && b == p.guard) continue;
      hrow = p.head + (long long)b * p.hw;
    } else {
      hrow = p.head + g * p.W;
      if (p.live) live = p.live[g] < p.K ? p.live[g] : p.K;
      if (live <= 0) continue;
    }
    for (int c0 = 0; c0 < nch; c0 += win) {
      const int cn = nch - c0 < win ? nch - c0 : win;
      // the window's non-zero head chunks, in order, and their word offsets
      int nz = 0;
      for (int c = lane; c - lane < cn; c += 32) {
        const T h = c < cn ? C::load(hrow + (long long)(c0 + c) * V) : T{};
        const bool keep = c < cn && C::any(h);
        const unsigned bal = __ballot_sync(kFull, keep);
        if (keep) {
          const int i = nz + __popc(bal & ((1u << lane) - 1));
          head[i] = h;
          at[i] = (c0 + c) * V;
        }
        nz += __popc(bal);
      }
      __syncwarp();
      if (nz == 0) continue;
      // items (slot, chunk), slot-major: lane i takes items i, i + 32, ...
      const int dk = 32 / nz, dj = 32 - dk * nz;
      // gather: the rows of kSlots slots at a time, listed; stream: the
      // live slots, consecutive rows of a
      for (int k0 = 0; k0 < live; k0 += kGather ? kSlots : live) {
        const int ns = kGather ? list_slots(p, g, k0, skip_guard, slot, lane)
                               : live;
        const int items = ns * nz;
        int k = lane / nz, j = lane - k * nz;
        unsigned part = 0;
#pragma unroll 4
        for (int i = lane; i < items; i += 32) {
          const unsigned* prow =
              kGather ? p.part + (long long)slot[k] * p.hw
                      : p.part + (g * p.K + k) * (long long)p.W;
          part += C::popc_and(C::load(prow + at[j]), head[j]);
          j += dj;
          k += dk;
          if (j >= nz) {
            j -= nz;
            ++k;
          }
        }
        acc += part;
        __syncwarp();
      }
    }
  }
  block_sum_add((long long)acc, out);
}

// The persistent grid of hub_groups_kernel<V, kGather> at `smem` bytes:
// its blocks an SM times the current device's SMs, asked of the runtime
// once a (device, smem) pair, as the query costs more host time than the
// launch.
template <int V, bool kGather>
cudaError_t grid_blocks(int smem, long long* fit) {
  struct Known {
    int dev, smem;
    long long fit;
  };
  static Known known[16];
  static int n_known = 0;
  static std::mutex mu;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_known; ++i) {
    if (known[i].dev == dev && known[i].smem == smem) {
      *fit = known[i].fit;
      return cudaSuccess;
    }
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hub_groups_kernel<V, kGather>, kThreads, smem);
  if (e != cudaSuccess) return e;
  *fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (n_known < 16) known[n_known++] = Known{dev, smem, *fit};
  return cudaSuccess;
}

template <int V, bool kGather>
cudaError_t launch_groups(const Groups& p, unsigned long long* out,
                          cudaStream_t stream) {
  const int wb = warp_bytes<V>(p.W);
  const int smem = kWarps * wb;
  long long fit = 0;
  const cudaError_t e = grid_blocks<V, kGather>(smem, &fit);
  if (e != cudaSuccess) return e;
  const long long need = (p.G + kWarps - 1) / kWarps;
  hub_groups_kernel<V, kGather>
      <<<(unsigned)(need < fit ? need : fit), kThreads, smem, stream>>>(
          p, wb, out);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// b: int32[G, W]; a: int32[G, K, W]; live: int32[G] or null (every slot
// read; else slots at and past live[g] are all zero and not read); out:
// int64, added to.
extern "C" int hub_popcount_stream(const void* b, const void* a,
                                   const void* live, long long G, int K, int W,
                                   void* out, void* stream) {
  if (G <= 0 || K <= 0 || W <= 0) return (int)cudaGetLastError();
  const Groups p{(const unsigned*)b, (const unsigned*)a, nullptr, nullptr,
                 (const int*)live, G, 0, K, W, 0};
  unsigned long long* o = (unsigned long long*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = W % 4 == 0 && aligned16(b) && aligned16(a);
  return (int)(vec ? launch_groups<4, false>(p, o, st)
                   : launch_groups<1, false>(p, o, st));
}

// rows: int32[n_rows, hw], its last row the guard; b_ids: int32[G]; nbrs:
// int32[G, K]; W <= hw; out: int64, added to.
extern "C" int hub_popcount_gather(const void* rows, long long n_rows,
                                   long long hw, const void* b_ids,
                                   const void* nbrs, long long G, int K, int W,
                                   void* out, void* stream) {
  if (G <= 0 || K <= 0 || W <= 0) return (int)cudaGetLastError();
  const Groups p{(const unsigned*)rows, (const unsigned*)rows,
                 (const int*)b_ids, (const int*)nbrs, nullptr, G, hw, K, W,
                 (int)(n_rows - 1)};
  unsigned long long* o = (unsigned long long*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = W % 4 == 0 && hw % 4 == 0 && aligned16(rows);
  return (int)(vec ? launch_groups<4, true>(p, o, st)
                   : launch_groups<1, true>(p, o, st));
}
