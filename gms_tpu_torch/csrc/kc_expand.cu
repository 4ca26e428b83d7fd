// K37 expand_level: one breadth-wise expansion of k-clique items, the
// surviving children compacted in (item, i) order into `cap` rows.
//
// Replaces gms_tpu/algorithms/k_clique.py:161 expand_level. For item n with
// bitset S[n] (ww words) and r = clip(R[n], 0, C-1), every set bit i of
// S[n] gives the child S[n] & adj[r, i]; it survives iff its popcount is at
// least `need`. The survivors, in (item, i) order, fill S_out[0..) with
// R_out = R[n], up to `cap` rows; the rows past them are zero. stats[0] =
// the survivors (all of them, also beyond cap), stats[1] = the sum of their
// popcounts. Only the items below min(N, *n_live) are expanded, where the
// caller passes n_live (the previous level's n_children: the rows past it
// are zero by construction); without it, all N.
//
// gms_tpu materialises every child in a dense [N, W, WW] tensor and
// compacts with one argsort. Here no child is stored before its row of
// S_out, and the work is spread over the card by words of S: the live
// items' words, flattened, are cut into tiles of up to 256 words (fewer
// when the level is small, so that a level of 256 roots still makes a tile
// for each of min(N·ww, 8 a SM) blocks), which the blocks take in order
// from a counter. A warp loads 32 words at once and deals their set bits,
// in (word, bit) order, to its lanes, 32 at a time (a shuffle search and
// __fns); a lane ANDs and counts its bit's child, and the bits of a sparse
// or zero row cost no lane. One pass, each child formed and counted once:
//   expand_kernel: a block counts its tile's survivors (a ballot a step,
//     kept in shared memory) and their popcounts, publishes the tile's
//     count, and finds its offset by decoupled look-back (block_scan.cuh's
//     warp_look_back: warp 0 reads the flags of the 32 tiles before it at a
//     time, adding counts back to the first tile that published its
//     inclusive prefix), publishes that prefix, then writes each survivor
//     below cap at its offset (its row ANDed again from S and the adj row,
//     which the count just read); the last tile's prefix is stats[0], the
//     popcounts one 64-bit atomicAdd a block (order-free);
//   clear_kernel: the rows [min(stats[0], cap), cap) zeroed, 16 bytes a
//     store.
//
// Bound on an H100: bytes over 3.35 TB/s (the live rows of S and R read
// once, each adj row the set bits need, every row of S_out and R_out
// written once, the zero rows included), or word operations (ww
// AND+popcounts a set bit of S) at 16 a clock per SM.

#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRound = kWarps * 32;  // the most words a tile, 32 a warp

struct Level {
  const unsigned* S;
  const int* R;
  long long n_items;
  const long long* n_live;  // or null
  const unsigned* adj;
  long long c;
  int ww, need;
};

// the live items' words, and the words a tile (the same in every block)
__device__ __forceinline__ void tiling(const Level& L, long long& words,
                                       long long& tile) {
  long long live = L.n_items;
  if (L.n_live) live = min(live, max(0LL, *L.n_live));
  words = live * L.ww;
  tile = min((long long)kRound,
             max(1LL, (words + gridDim.x - 1) / gridDim.x));
}

// A warp's batch: 32 words from g0 (lane j holds word g0 + j), their set
// bits numbered in (word, bit) order, which is (item, i) order.
struct Batch {
  long long g0;
  unsigned word;
  int incl, bits, r;  // set bits up to this lane's word, in all; R of it
};

__device__ __forceinline__ Batch load_batch(const Level& L, long long g0,
                                            long long hi, int lane) {
  Batch b;
  b.g0 = g0;
  const long long g = g0 + lane;
  b.word = g < hi ? L.S[g] : 0u;
  b.r = b.word ? L.R[g / L.ww] : 0;
  b.incl = __popc(b.word);
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, b.incl, o);
    if (lane >= o) b.incl += y;
  }
  b.bits = __shfl_sync(kFull, b.incl, 31);
  return b;
}

// Set bit t of the batch: its item n, local vertex i and adj row; false if
// t is past the batch's bits. Every lane of the warp calls it.
__device__ __forceinline__ bool batch_bit(const Level& L, const Batch& b,
                                          int t, long long& n, int& i,
                                          const unsigned*& Ai, int& r) {
  int j = 0;  // the first lane whose bits end past t
  for (int step = 16; step > 0; step >>= 1)
    if (__shfl_sync(kFull, b.incl, j + step - 1) <= t) j += step;
  j &= 31;
  const unsigned wj = __shfl_sync(kFull, b.word, j);
  const int before = __shfl_sync(kFull, b.incl, j) - __popc(wj);
  r = __shfl_sync(kFull, b.r, j);
  if (t >= b.bits) return false;
  const long long g = b.g0 + j;
  n = g / L.ww;
  i = 32 * (int)(g - n * L.ww) + (int)__fns(wj, 0, t - before + 1);
  const long long rc = r < 0 ? 0 : (r >= L.c ? L.c - 1 : r);
  Ai = L.adj + (rc * 32 * L.ww + i) * L.ww;
  return true;
}

__device__ __forceinline__ int child_count(const Level& L, long long n,
                                           const unsigned* Ai) {
  const unsigned* Sn = L.S + n * L.ww;
  int pc = 0;
  for (int x = 0; x < L.ww; ++x) pc += __popc(Sn[x] & __ldg(Ai + x));
  return pc;
}

// zero words [a, b) of p, 16 bytes a store where aligned
template <typename T>
__device__ __forceinline__ void clear_words(T* p, long long a, long long b) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (a >= b) return;
  const long long a4 = min((a + 3) & ~3LL, b), b4 = max(b & ~3LL, a4);
  for (long long i = a + t0; i < a4; i += stride) p[i] = 0;
  for (long long i = b4 + t0; i < b; i += stride) p[i] = 0;
  uint4* q = reinterpret_cast<uint4*>(p);
  for (long long i = a4 / 4 + t0; i < b4 / 4; i += stride)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
}

__global__ void __launch_bounds__(kThreads)
    expand_kernel(Level L, unsigned long long* __restrict__ status,
                  unsigned long long* __restrict__ stats, long long cap,
                  unsigned* __restrict__ S_out, int* __restrict__ R_out) {
  __shared__ int warp_cnt[kWarps];
  __shared__ unsigned hits[kWarps][32];  // a warp's ballots, a step each
  __shared__ long long tile_id, tile_off;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  unsigned long long* next = status;  // the tile counter; tiles from 1
  volatile unsigned long long* flags = status + 1;
  long long words, tw;
  tiling(L, words, tw);
  const long long n_tiles = (words + tw - 1) / tw;
  long long pcs = 0;
  for (;;) {
    __syncthreads();  // the previous tile is done with the shared state
    if (threadIdx.x == 0) tile_id = (long long)atomicAdd(next, 1ull);
    __syncthreads();
    const long long t = tile_id;
    if (t >= n_tiles) break;
    const long long lo = t * tw, hi = min(lo + tw, words);
    const Batch b = load_batch(L, lo + 32 * warp, hi, lane);
    int cnt = 0;
    for (int t0 = 0; t0 < b.bits; t0 += 32) {
      long long n;
      int i, r;
      const unsigned* Ai;
      bool ok = false;
      int pc = 0;
      if (batch_bit(L, b, t0 + lane, n, i, Ai, r)) {
        pc = child_count(L, n, Ai);
        ok = pc >= L.need;
      }
      const unsigned h = __ballot_sync(kFull, ok);
      if (lane == 0) hits[warp][t0 >> 5] = h;
      cnt += __popc(h);
      pcs += ok ? pc : 0;
    }
    if (lane == 0) warp_cnt[warp] = cnt;
    __syncthreads();
    if (warp == 0) {
      int agg = lane < kWarps ? warp_cnt[lane] : 0;
      for (int o = 16; o > 0; o >>= 1) agg += __shfl_xor_sync(kFull, agg, o);
      if (t == 0) {
        if (lane == 0) flags[0] = kLookPrefix | (unsigned long long)agg;
      } else {
        if (lane == 0) flags[t] = kLookAggregate | (unsigned long long)agg;
        const long long excl = warp_look_back(flags, t, lane);
        if (lane == 0) {
          flags[t] = kLookPrefix | (unsigned long long)(excl + agg);
          tile_off = excl;
        }
      }
      if (lane == 0) {
        if (t == 0) tile_off = 0;
        if (t == n_tiles - 1) stats[0] = (unsigned long long)(tile_off + agg);
      }
    }
    __syncthreads();
    long long pos = tile_off;
    for (int w = 0; w < warp; ++w) pos += warp_cnt[w];
    for (int t0 = 0; t0 < b.bits && pos < cap; t0 += 32) {
      const unsigned h = hits[warp][t0 >> 5];
      long long n;
      int i, r;
      const unsigned* Ai;
      // every lane takes part in the search; only the survivors write
      if (batch_bit(L, b, t0 + lane, n, i, Ai, r) && ((h >> lane) & 1u)) {
        const long long p = pos + __popc(h & below);
        if (p < cap) {
          const unsigned* Sn = L.S + n * L.ww;
          unsigned* row = S_out + p * L.ww;
          for (int x = 0; x < L.ww; ++x) row[x] = Sn[x] & __ldg(Ai + x);
          R_out[p] = r;
        }
      }
      pos += __popc(h);
    }
  }
  for (int o = 16; o > 0; o >>= 1) pcs += __shfl_down_sync(kFull, pcs, o);
  __shared__ long long red[kWarps];
  if (lane == 0) red[warp] = pcs;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long p = 0;
    for (int x = 0; x < kWarps; ++x) p += red[x];
    if (p) atomicAdd(stats + 1, (unsigned long long)p);
  }
}

// the rows past the survivors
__global__ void __launch_bounds__(kThreads)
    clear_kernel(int ww, const unsigned long long* __restrict__ stats,
                 long long cap, unsigned* __restrict__ S_out,
                 int* __restrict__ R_out) {
  const long long first = min((long long)stats[0], cap);
  clear_words(S_out, first * ww, cap * ww);
  clear_words(R_out, first, cap);
}

}  // namespace

// S: int32[n_items, ww]; R: int32[n_items]; n_live: int64[1] or null; adj:
// int32[c, 32*ww, ww]; grid blocks; status int64[1 + max(grid,
// ceil(n_items*ww / 256))] zeros (the tile counter, then a word a tile);
// S_out: int32[cap, ww] and R_out: int32[cap], every row written here;
// stats: int64[2] zeros.
extern "C" int expand_level(const void* S, const void* R, long long n_items,
                            const void* n_live, const void* adj, long long c,
                            int ww, int need, long long cap, int grid,
                            void* status, void* S_out, void* R_out,
                            void* stats, void* stream) {
  if (n_items <= 0 || ww <= 0 || c <= 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Level L{(const unsigned*)S, (const int*)R, n_items,
                (const long long*)n_live, (const unsigned*)adj, c, ww, need};
  expand_kernel<<<grid, kThreads, 0, st>>>(
      L, (unsigned long long*)status, (unsigned long long*)stats, cap,
      (unsigned*)S_out, (int*)R_out);
  clear_kernel<<<grid, kThreads, 0, st>>>(
      ww, (const unsigned long long*)stats, cap, (unsigned*)S_out,
      (int*)R_out);
  return (int)cudaGetLastError();
}
