// K12 star_stack: the k-clique-stars rooted at a chunk, counted or emitted,
// by a depth-first search over (S, I, R) bitsets in each root's local
// universe, its full neighbourhood (K11 builds it).
//
// Replaces gms_tpu/algorithms/k_clique_star.py:137 star_fused_chunk, less
// its first step, build_local_univ (K11). gms_tpu keeps a LIFO work stack
// of (S | I | R | root*256 + rem) rows in device memory, pops an adaptive
// window each round, compacts the pushes with a band sort and banks leaf
// rows in an output buffer; the window, the stack and output capacities
// with their overflow flag and split-and-retry, and the iter_budget
// segments exist for its platform. Here the same tree is walked
// depth-first, so nothing overflows. The tree, as gms_tpu's (:192-194,
// :273-314):
//   root b: the node (S0, I0, R = 0, rem = k-1), kept iff live0[b] and
//     |S0| >= k-1;
//   the child of (S, I, R, rem) along i in S is (S & adj_dag[i],
//     I & adj_full[i], R | {i}, rem-1);
//   a child of rem 0 is the k-clique {root} + R with star I & ~R; a child
//     of rem r >= 1 is searched iff |S| >= r.
// gms_tpu's count mode counts the leaves below a rem-2 node inline; they
// are the same leaves.
//
// Design. Items are the tree's nodes `depth` levels below the root: depth 1
// (b, i) for k <= 3 and depth 2 (b, i, j) for k >= 4, so that a hub root's
// leaves spread over as many warps as it has items (the lesson of K6). The
// items of k = 2 are leaves, those of k = 3 and k = 4 nodes of rem 1, and
// k >= 5 walks below its items. A run is up to rb consecutive items that
// share their parent, (b) at depth 1 and (b, i) at depth 2: rb = kRunItems,
// or at depth 2 more for a root with over W * kRunItems items, so that a
// root has at most 2W runs and the run table at most 2CW entries.
//   count_kernel, a block a root (taken in order by a ticket): |S0| and, at
//     depth 2, the items of each i in S0 (|S0 & adj_dag[i]| if that is >=
//     k-2, else 0) over S0's words up to its last non-zero one; a pad root
//     ends at once. Its runs' offset by decoupled look-back over the roots
//     (block_scan.cuh's tile_prefix); it writes its runs (b, i, first item,
//     items) into the run table, and the last root the number of runs.
//   stack_kernel: persistent warps take runs from a counter. A warp builds
//     the run's parent node once (the root's, or its child along i), finds
//     the run's first item by a warp-wide select and each next one by
//     next_bit, builds each item's node and, below rem 1, walks its
//     subtree depth-first, a node of 3*WW words and a cursor a level in
//     shared memory (lanes split a child's words). The leaves of a rem-1
//     node: the warp lists the set bits of S (a popcount and a warp prefix
//     a word, kList at a time) and deals them to groups of g = min(32, WW)
//     lanes (rounded up to a power of two), 32/g leaves at a time; a group
//     reads its leaf's adj_full row coalesced, ANDs it with I & ~R (less
//     the leaf) and, in the emit pass, writes the leaf's row (R | {l}, the
//     star, b) coalesced. The count pass writes each run's leaves to
//     leaf_cnt[run] and sums the cliques and star sizes; in emit mode it
//     counts a rem-1 node's leaves as |S| and leaves the star sizes to the
//     emit pass, which computes them for the rows anyway.
//   base_kernel (emit pass): leaf_cnt scanned into each run's first row by
//     decoupled look-back over tiles of kTile runs.
// Emit mode runs the count pass, reads (cliques, stars, runs) back to size
// `out` exactly, then base_kernel and stack_kernel again writing rows: a
// run's rows start at its base, in walk order, so the rows come in the same
// order on every run (runs in table order, roots ascending, i and j
// ascending, then depth-first, leaves ascending).
//
// Bound on an H100: operations. Per child node 2*WW bitwise words (S and I)
// and WW popcounts (|S| for the prune), per leaf WW three-input bitwise
// words and WW popcounts (the star), and WW popcounts per live root (the
// plain version counts them): popcounts at 16 and bitwise operations at 64
// per clock per SM x 132 SMs x the SM clock, against the universe's bytes
// read once at 3.35 TB/s. The emit pass adds its rows, (2*WW + 1) words
// each, written once. A leaf reads its WW-word adj_full row from L2 (a
// row is shared by the root's many leaves), and the walk's node builds are
// chains of dependent shared-memory and L2 loads.

#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "block_sum.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kList = 256;            // leaves listed at a time, a warp
constexpr int kPer = 8;               // runs a thread in base_kernel
constexpr int kTile = kThreads * kPer;
// the least items a run (k_clique_star.py's RUN_ITEMS): of 1, 4, 16 and 64,
// 4 was the fastest over the RMAT-12 k=4 emit pass on an H100
constexpr int kRunItems = 4;

// The control words (int64, zeroed by the caller): the totals, the number
// of runs, the tickets and work counters, then the roots' look-back status
// [c], then base_kernel's tiles' status.
enum {
  kCliques = 0, kStars, kRuns, kRootTicket, kCountNext, kBaseTicket,
  kEmitNext, kCtl = 8
};
// stack_kernel's passes: count the cliques and star sizes, count the
// cliques only (emit mode's first pass), or write the rows and sum the
// star sizes
enum { kCount = 0, kSizes, kEmit };

// The n-th set bit of S (n < |S|), every lane: a popcount a word and a warp
// prefix, 32 words at a time.
__device__ __forceinline__ int warp_nth_bit(const unsigned* S, int ww,
                                            long long n, int lane) {
  long long done = 0;
  for (int wb = 0; wb < ww; wb += 32) {
    const int w = wb + lane;
    const unsigned x = w < ww ? S[w] : 0u;
    const int pc = __popc(x);
    int incl = pc;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int tot = __shfl_sync(kFull, incl, 31);
    if (n < done + tot) {
      const unsigned hit = __ballot_sync(kFull, done + incl > n);
      const int f = __ffs(hit) - 1;
      int bit = 0;
      if (lane == f) {
        unsigned y = x;
        for (long long m = n - done - (incl - pc); m > 0; --m) y &= y - 1;
        bit = 32 * w + __ffs(y) - 1;
      }
      return __shfl_sync(kFull, bit, f);
    }
    done += tot;
  }
  return 32 * ww;
}

// dst = (S & Dv, I & Fv, R | {v}) from the node (S, I, R), R null for 0;
// lanes split the words, and dst lies apart from the node. Returns |dst.S|
// (every lane).
__device__ __forceinline__ int child(unsigned* dst, const unsigned* S,
                                     const unsigned* I, const unsigned* R,
                                     const unsigned* Dv, const unsigned* Fv,
                                     int v, int ww, int lane) {
  int pc = 0;
  for (int w = lane; w < ww; w += 32) {
    const unsigned s = S[w] & __ldg(Dv + w);
    dst[w] = s;
    dst[ww + w] = I[w] & __ldg(Fv + w);
    dst[2 * ww + w] =
        (R ? R[w] : 0u) | (w == (v >> 5) ? 1u << (v & 31) : 0u);
    pc += __popc(s);
  }
  __syncwarp();
  return __reduce_add_sync(kFull, pc);
}

// The leaves below a run, counted and, in the emit pass, written.
struct Leaves {
  const unsigned* F;  // the root's adj_full rows
  long long b;
  int ww, lane, lg;   // lanes a leaf g = 1 << lg
  int* list;          // the warp's kList slots in shared memory
  unsigned* rows;     // the emit pass's out, else null
  unsigned long long cap;
  long long pos;      // the next leaf's row (warp-uniform)
  long long star;     // this lane's share of the star sizes
  bool sizes;         // count the leaves only, by |S|

  // The leaf l of the rem-1 node (I, R): R | {l} with star
  // I & ~R & adj_full[l], less l, by the lane group of `lane`.
  __device__ __forceinline__ void leaf(int l, const unsigned* I,
                                       const unsigned* R, long long p) {
    const int g = 1 << lg, s = lane & (g - 1);
    const unsigned* Fl = F + (long long)l * ww;
    unsigned* row = rows && (unsigned long long)p < cap
                        ? rows + p * (2 * ww + 1) : nullptr;
    const int lw = l >> 5;
    const unsigned lb = 1u << (l & 31);
    int sc = 0;
    for (int v = s; v < ww; v += g) {
      const unsigned m = v == lw ? lb : 0u;
      const unsigned sw = I[v] & ~R[v] & ~m & __ldg(Fl + v);
      sc += __popc(sw);
      if (row) {
        row[v] = R[v] | m;
        row[ww + v] = sw;
      }
    }
    star += sc;
    if (row && s == 0) row[2 * ww] = (unsigned)b;
  }

  // The leaves of the rem-1 node N = (S | I | R), |S| = size, whose rank
  // among S's set bits lies in [lo, hi), rows pos on; returns how many.
  __device__ long long leaves(const unsigned* N, long long lo, long long hi,
                              long long size) {
    if (sizes) {
      const long long n = (hi < size ? hi : size) - lo;
      pos += n > 0 ? n : 0;
      return n > 0 ? n : 0;
    }
    const unsigned *S = N, *I = N + ww, *R = N + 2 * ww;
    const int q = lane >> lg, groups = 32 >> lg;
    long long done = 0, taken = 0;
    for (int wb = 0; wb < ww && done < hi; wb += 32) {
      const int w = wb + lane;
      const unsigned x = w < ww ? S[w] : 0u;
      const int pc = __popc(x);
      int incl = pc;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      const int tot = __shfl_sync(kFull, incl, 31);
      const long long c0 = lo > done ? lo : done;
      const long long c1 = hi < done + tot ? hi : done + tot;
      for (long long a = c0; a < c1; a += kList) {
        const long long e = a + kList < c1 ? a + kList : c1;
        long long rk = done + incl - pc;  // the rank of this lane's first bit
        for (unsigned y = x; y && rk < e; y &= y - 1, ++rk)
          if (rk >= a) list[rk - a] = 32 * w + __ffs(y) - 1;
        __syncwarp();
        const int n = (int)(e - a);
        for (int t = q; t < n; t += groups) leaf(list[t], I, R, pos + t);
        pos += n;
        taken += n;
        __syncwarp();
      }
      done += tot;
    }
    __syncwarp();
    return taken;
  }
};

// ticket-ordered: the run table [b's runs' offset ...), ctl[kRuns]; icnt
// holds each i's items at depth 2.
__global__ void __launch_bounds__(kThreads) count_kernel(
    const unsigned* __restrict__ adj_dag, const unsigned* __restrict__ s0,
    const unsigned char* __restrict__ live0, long long c, int ww, int k,
    int depth, unsigned long long* ctl, int* __restrict__ icnt,
    int4* __restrict__ table) {
  __shared__ long long ticket, carry;
  __shared__ int last_word;
  if (threadIdx.x == 0) {
    ticket = (long long)atomicAdd(ctl + kRootTicket, 1ull);
    last_word = -1;
  }
  __syncthreads();
  const long long b = ticket;
  const int W = 32 * ww;
  const unsigned* S0 = s0 + b * ww;
  int pc = 0;
  for (int w = threadIdx.x; w < ww; w += kThreads) {
    const unsigned x = S0[w];
    pc += __popc(x);
    if (x) atomicMax(&last_word, w);
  }
  const int size = block_total(pc);
  const int nw = last_word + 1, hi = 32 * nw;  // S0 is 0 from bit hi on
  int* cnt = icnt + b * W;
  long long items = 0, runs = 0;
  int rb = kRunItems;
  if (live0[b] && size >= k - 1) {
    if (depth == 1) {
      items = size;
      runs = (items + kRunItems - 1) / kRunItems;
    } else {
      long long mine = 0;
      for (int i = threadIdx.x; i < hi; i += kThreads) {
        int n = 0;
        if ((S0[i >> 5] >> (i & 31)) & 1u) {
          const unsigned* Ai = adj_dag + (b * W + i) * ww;
          for (int w = 0; w < nw; ++w) n += __popc(S0[w] & __ldg(Ai + w));
          if (n < k - 2) n = 0;
        }
        cnt[i] = n;
        mine += n;
      }
      items = block_total(mine);
      const long long per = (items + W - 1) / W;
      rb = per > kRunItems ? (int)per : kRunItems;
      long long r = 0;
      for (int i = threadIdx.x; i < hi; i += kThreads)
        r += (cnt[i] + rb - 1) / rb;
      runs = block_total(r);
    }
  }
  const long long off = tile_prefix(
      (volatile unsigned long long*)(ctl + kCtl), b, runs);
  if (runs > 0) {
    if (depth == 1) {
      for (long long t = threadIdx.x; t < runs; t += kThreads)
        table[off + t] =
            make_int4((int)b, -1, (int)(t * kRunItems),
                      (int)min((long long)kRunItems, items - t * kRunItems));
    } else {
      if (threadIdx.x == 0) carry = off;
      __syncthreads();
      for (int base = 0; base < hi; base += kThreads) {
        const int i = base + threadIdx.x;
        const int n = i < hi ? cnt[i] : 0;
        const int nr = (n + rb - 1) / rb;
        const long long o = block_scan((long long)nr, &carry);
        for (int t = 0; t < nr; ++t)
          table[o + t] = make_int4((int)b, i, t * rb, min(rb, n - t * rb));
      }
    }
  }
  if (b == c - 1 && threadIdx.x == 0) ctl[kRuns] = off + runs;
}

// base[r] = leaf_cnt[0] + ... + leaf_cnt[r-1], tiles of kTile taken in
// order by a ticket.
__global__ void __launch_bounds__(kThreads) base_kernel(
    const long long* __restrict__ leaf_cnt, long long n,
    unsigned long long* ctl, volatile unsigned long long* status,
    long long* __restrict__ base) {
  __shared__ long long ticket, carry;
  if (threadIdx.x == 0) {
    ticket = (long long)atomicAdd(ctl + kBaseTicket, 1ull);
    carry = 0;
  }
  __syncthreads();
  const long long t = ticket;
  const long long lo = t * kTile + (long long)threadIdx.x * kPer;
  long long v[kPer], sum = 0;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    v[p] = lo + p < n ? leaf_cnt[lo + p] : 0;
    sum += v[p];
  }
  long long off = block_scan(sum, &carry);
  const long long agg = carry;
  off += tile_prefix(status, t, agg);
#pragma unroll
  for (int p = 0; p < kPer; ++p)
    if (lo + p < n) {
      base[lo + p] = off;
      off += v[p];
    }
}

__global__ void __launch_bounds__(kThreads)
stack_kernel(const unsigned* __restrict__ adj_full,
             const unsigned* __restrict__ adj_dag,
             const unsigned* __restrict__ s0, const unsigned* __restrict__ i0,
             int ww, int k, int depth, const int4* __restrict__ table,
             unsigned long long* ctl, unsigned long long* next,
             long long* __restrict__ leaf_cnt,
             const long long* __restrict__ leaf_base, unsigned* out_rows,
             unsigned long long out_cap, int mode) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = 32 * ww;
  const int node = 3 * ww;
  const int rem0 = k - 1 - depth;  // the items' rem
  const int slots = 1 + (rem0 > 0 ? rem0 : 0);
  const int per_warp = slots * node + kList + (rem0 > 1 ? rem0 : 1);
  unsigned* path = smem + (long long)warp * per_warp;
  int* list = reinterpret_cast<int*>(path + slots * node);
  int* curs = list + kList;
  int lg = 0;
  while ((1 << lg) < ww && lg < 5) ++lg;
  const long long n_runs = (long long)ctl[kRuns];
  Leaves lv{nullptr, 0, ww, lane, lg, list, out_rows, out_cap, 0, 0,
            mode == kSizes};
  long long cliques = 0;
  for (;;) {
    unsigned long long r = 0;
    if (lane == 0) r = atomicAdd(next, 1ull);
    r = __shfl_sync(kFull, r, 0);
    if ((long long)r >= n_runs) break;
    const int4 e = table[r];
    const long long b = e.x;
    const unsigned* F = adj_full + b * W * ww;
    const unsigned* D = adj_dag + b * W * ww;
    lv.F = F;
    lv.b = b;
    lv.pos = leaf_base ? leaf_base[r] : 0;
    const long long first_row = lv.pos;
    // slot 0: the run's parent, the root's node or its child along i
    unsigned* top = path;
    if (depth == 1) {
      for (int w = lane; w < ww; w += 32) {
        top[w] = s0[b * ww + w];
        top[ww + w] = i0[b * ww + w];
        top[2 * ww + w] = 0u;
      }
      __syncwarp();
    } else {
      child(top, s0 + b * ww, i0 + b * ww, nullptr, D + (long long)e.y * ww,
            F + (long long)e.y * ww, e.y, ww, lane);
    }
    if (rem0 == 0) {
      // the items are leaves
      lv.leaves(top, e.z, (long long)e.z + e.w, (long long)e.z + e.w);
    } else {
      unsigned* item = path + node;  // slot 1
      int v = warp_nth_bit(top, ww, e.z, lane);
      for (int t = 0; t < e.w; ++t) {
        if (t > 0) v = next_bit(top, ww, v + 1, lane);
        const int pc = child(item, top, top + ww, top + 2 * ww,
                             D + (long long)v * ww, F + (long long)v * ww, v,
                             ww, lane);
        if (pc < rem0) continue;  // fewer candidates than members needed
        if (rem0 == 1) {
          lv.leaves(item, 0, W, pc);
          continue;
        }
        if (lane == 0) curs[0] = 0;
        __syncwarp();
        int d = 0;  // the level below the item: slot 1 + d
        while (d >= 0) {
          unsigned* L = item + d * node;
          const int u = next_bit(L, ww, curs[d], lane);
          __syncwarp();
          if (u >= W) {
            --d;
            continue;
          }
          if (lane == 0) curs[d] = u + 1;
          unsigned* ch = L + node;
          const int cp = child(ch, L, L + ww, L + 2 * ww,
                               D + (long long)u * ww, F + (long long)u * ww,
                               u, ww, lane);
          const int crem = rem0 - d - 1;  // the child's
          if (crem == 1) {
            lv.leaves(ch, 0, W, cp);
          } else if (cp >= crem) {
            ++d;
            if (lane == 0) curs[d] = 0;
          }
          __syncwarp();
        }
      }
    }
    if (leaf_cnt && lane == 0) leaf_cnt[r] = lv.pos - first_row;
    cliques += lv.pos - first_row;
    __syncwarp();
  }
  if (mode != kEmit) block_sum_add(lane == 0 ? cliques : 0, ctl + kCliques);
  __syncthreads();
  if (mode != kSizes) block_sum_add(lv.star, ctl + kStars);
}

// The resident grid of stack_kernel and its shared memory; returns 0 or
// the error.
int stack_grid(int ww, int k, int depth, size_t& smem, long long& blocks) {
  const int rem0 = k - 1 - depth;
  const int slots = 1 + (rem0 > 0 ? rem0 : 0);
  smem = (size_t)kWarps *
         (slots * 3 * ww + kList + (rem0 > 1 ? rem0 : 1)) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stack_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return 0;
}

}  // namespace

// The count pass. ctl: int64[8 + c + ceil(2*c*32*ww / 2048)] zeros; after
// it ctl[0] = cliques, ctl[1] = star total (0 with sizes: the emit pass
// sums it), ctl[2] = the runs. icnt: int32[c*32*ww]; table:
// int32[2*c*32*ww, 4]; leaf_cnt: int64[2*c*32*ww], each run's leaves.
extern "C" int star_stack_count(const void* adj_full, const void* adj_dag,
                                const void* s0, const void* i0,
                                const void* live0, long long c, int ww, int k,
                                int sizes, void* ctl, void* icnt,
                                void* table, void* leaf_cnt, void* stream) {
  if (k < 2) return (int)cudaErrorInvalidValue;
  if (c <= 0 || ww <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int depth = k <= 3 ? 1 : 2;
  unsigned long long* cw = (unsigned long long*)ctl;
  count_kernel<<<(unsigned)c, kThreads, 0, st>>>(
      (const unsigned*)adj_dag, (const unsigned*)s0,
      (const unsigned char*)live0, c, ww, k, depth, cw, (int*)icnt,
      (int4*)table);
  size_t smem = 0;
  long long blocks = 0;
  const int err = stack_grid(ww, k, depth, smem, blocks);
  if (err) return err;
  stack_kernel<<<(unsigned)blocks, kThreads, smem, st>>>(
      (const unsigned*)adj_full, (const unsigned*)adj_dag,
      (const unsigned*)s0, (const unsigned*)i0, ww, k, depth,
      (const int4*)table, cw, cw + kCountNext, (long long*)leaf_cnt, nullptr,
      nullptr, 0ull, sizes ? kSizes : kCount);
  return (int)cudaGetLastError();
}

// The emit pass, after the count pass on the same ctl, table and leaf_cnt:
// n_runs = ctl[2] and out_cap = ctl[0] read back; leaf_base: int64[n_runs];
// out_rows: int32[out_cap, 2*ww + 1]. Adds the star total to ctl[1].
extern "C" int star_stack_emit(const void* adj_full, const void* adj_dag,
                               const void* s0, const void* i0, long long c,
                               int ww, int k, void* ctl, const void* table,
                               const void* leaf_cnt, long long n_runs,
                               void* leaf_base, void* out_rows,
                               long long out_cap, void* stream) {
  if (k < 2) return (int)cudaErrorInvalidValue;
  if (c <= 0 || ww <= 0 || n_runs <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int depth = k <= 3 ? 1 : 2;
  unsigned long long* cw = (unsigned long long*)ctl;
  const long long tiles = (n_runs + kTile - 1) / kTile;
  base_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
      (const long long*)leaf_cnt, n_runs, cw,
      (volatile unsigned long long*)(cw + kCtl + c), (long long*)leaf_base);
  size_t smem = 0;
  long long blocks = 0;
  const int err = stack_grid(ww, k, depth, smem, blocks);
  if (err) return err;
  stack_kernel<<<(unsigned)blocks, kThreads, smem, st>>>(
      (const unsigned*)adj_full, (const unsigned*)adj_dag,
      (const unsigned*)s0, (const unsigned*)i0, ww, k, depth,
      (const int4*)table, cw, cw + kEmitNext, nullptr,
      (const long long*)leaf_base, (unsigned*)out_rows,
      (unsigned long long)out_cap, kEmit);
  return (int)cudaGetLastError();
}
