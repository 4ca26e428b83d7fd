// K1 intersect_count: Σ over edges e of |A_e ∩ B_e| for the narrow degree
// tiers of the triangle-count plan; K14, the same tiers counted per vertex;
// and K40, the same sum over two row tables, an owned row staged once for
// all of its edges.
//
// Replaces four device programs of gms_tpu/algorithms/triangle_count.py
// and gms_tpu/parallel/sharding.py:
//   * count_tier_mat (:383)  — stream mode: operand rows pre-gathered and
//     stored transposed, a[wa, E] and b[wb, E]; row e is column e, stride E;
//   * count_dag_edges (:99)  — gather mode: rows nbr[u, :wa] and nbr[v, :wb]
//     of the padded adjacency (row stride D_pad), with valid[e] weighting
//     each edge (0 for padding edges, which point at vertex 0);
//   * the rotation body of gms_tpu/parallel/sharding.py:206-216
//     (VertexShardedTrianglePlan) — K40 (tier_intersect_owned): u's row
//     from the owned table shard, v's from the visiting one, each with its
//     own row stride, so the ring never copies a shard into one buffer;
//   * count_dag_edges_per_vertex (:129) — per-vertex mode (K14): the gather
//     mode's merge, where each match x (a witness) adds 1 to out[x] and the
//     edge's count c adds c * valid[e] to out[u] and out[v], for edges with
//     valid[e] > 0; ids outside [0, len(out)) are dropped, as gms_tpu's
//     scatter drops them. SENTINEL never matches, so gms_tpu's overflow
//     bucket for SENTINEL witnesses has no counterpart.
// gms_tpu's `salt` argument and the rotation chain of run_steady exist only
// because its platform memoized repeated runs of a pure program; CUDA launches
// are never memoized, so the port drops them.
//
// Design of K1: one thread per edge. Both rows are sorted ascending
// with a SENTINEL (int32 max) tail — the padded-layout invariant of
// harness/checks.py — so the thread merges them in O(wa + wb) steps instead
// of the wa*wb compare cube of the TPU program. An a-element counts only when
// it is not SENTINEL (SENTINEL equals SENTINEL; gms_tpu masks that diagonal
// at triangle_count.py:413): the merge stops at the first SENTINEL on either
// side, since nothing after it can match. Widths are runtime values (tiers
// reach D_pad).
//
// Bound on an H100 (3.35 TB/s): the words that carry data, read once: each
// valid edge's two rows up to and including their first SENTINEL (at most
// wa and wb words), and in gather mode each distinct row once plus edges and
// valid. Padding edges carry none.
// In stream mode neighbouring threads read neighbouring words of each row
// (stride-E layout), so the loads coalesce while the merges stay in step; the
// merge reads each word at most once and stops early at the SENTINEL tail.
// Gather mode reads rows of D_pad-strided adjacency and does not coalesce; it
// serves graphs whose materialized streams would not fit (plan MAT_BUDGET).
// Counts are summed exactly: int64 per block, one atomicAdd per block.
//
// K40 (owned_rows_kernel) takes the edges by a schedule
// (algorithms/triangle_count.py's cross_schedule) that orders a bucket's
// valid edges by owned row, cuts each row's run into work items (owned
// row, first edge, count) of at most `span` edges, and carries each edge's
// visiting row id, weight and live length. A block takes an item: it
// stages the owned row's live prefix once for all of the item's edges
// (csrc/slot_table.cuh's load_slots, stopping at the SENTINEL) and sets it
// in a bitmap of its value range in shared memory (2^18 ids; a row of a
// wider range is binary-searched in its staged copy), one lookup an entry;
// its warps take the item's edges in turn and walk each visiting row's
// live entries, kUnroll 32-entry chunks in flight, coalesced
// (warp_row_count), stopping after the chunk where an entry passes the
// owned row's last value. The row lengths keep every load on the rows'
// data. The grid is as many blocks as fit on the card, each walking items
// by a stride; hits times the edge's weight add into an int64 a lane, one
// atomicAdd a block. Integer sums in any order: exact. What bounds it on
// RMAT-18's rotation is the walk: 647 M visiting entries (each edge's row up
// to the owned row's last value) read from L2 and looked up, for 82.6 M
// triangles; a warp an item (binary search, or a hash set of its own), a
// hash table in place of the bitmap, 1, 2 or 8 chunks in flight, lane
// groups of 8 or 16 an edge and 512-thread blocks measured slower (PERF.md,
// PR 19). Bound: the gather mode's bytes (the function's); the schedule
// adds its own ids, weights, lengths and items.
//
// K14 (vertex_kernel) gives each edge a group of G lanes, G = 8, 16 or 32
// by the narrower width (a warp from 17 on), so the loads of a row coalesce
// and a long merge no longer holds a whole warp of unrelated edges. The
// group stages the wider row in shared memory up to its first SENTINEL
// (kUnroll rounds of loads in flight before their votes; kStageInts a
// block, in pieces where a row is longer than the group's share), reads
// the narrower row G entries at a time, the next round loaded ahead, and
// each lane binary-searches its entry in the staged row (at most 9 probes
// at 512): len_a · log2 len_b probes, fewer than len_b · log2 len_a where,
// as the planner orders them, the narrower row is the shorter. Entries past
// the staged piece's last value end the piece. The edge's count is a group
// sum. The witnesses go to a block-private table in shared memory (id ->
// count, kSlots slots, open addressing, at most kProbes probes; a witness
// that finds no slot adds to device memory at once), flushed once when the
// block ends: under the degree order the witnesses are the high-rank hubs
// (RMAT-18: 82,647,223 increments, the top vertex's 2,043,113), so the
// table takes most adds off device memory. An edge's two endpoint adds are
// one 64-bit atomicAdd each. Integer adds in any order give the same sums,
// so the result is exact for edges in any order. The grid is as many blocks
// as the occupancy calculator fits on the card, each walking edges by a
// stride. Its bound is the gather mode's bytes plus the int64 output
// written once; the merge, not the adds, holds it off that bound.

#include <cuda_runtime.h>

#include "block_sum.cuh"
#include "slot_table.cuh"

namespace {

// |a ∩ b| of two sorted rows.
__device__ __forceinline__ int merge_count(const int* a, long long sa, int wa,
                                           const int* b, long long sb,
                                           int wb) {
  if (wa <= 0 || wb <= 0) return 0;
  int i = 0, j = 0, cnt = 0;
  int x = a[0], y = b[0];
  while (x != GMS_SENTINEL && y != GMS_SENTINEL) {
    if (x < y) {
      if (++i == wa) break;
      x = a[i * sa];
    } else if (y < x) {
      if (++j == wb) break;
      y = b[j * sb];
    } else {
      ++cnt;
      if (++i == wa || ++j == wb) break;
      x = a[i * sa];
      y = b[j * sb];
    }
  }
  return cnt;
}

__global__ void stream_kernel(const int* __restrict__ a,
                              const int* __restrict__ b, int wa, int wb,
                              long long E, unsigned long long* out) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long cnt = 0;
  if (e < E) cnt = merge_count(a + e, E, wa, b + e, E, wb);
  block_sum_add(cnt, out);
}

// Gather mode: u's row from nbr_a, v's from nbr_b (K1's gather entry passes
// one table twice).
__global__ void gather_kernel(const int* __restrict__ nbr_a, long long d_a,
                              const int* __restrict__ nbr_b, long long d_b,
                              const int* __restrict__ edges,
                              const int* __restrict__ valid, int wa, int wb,
                              long long E, unsigned long long* out) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long cnt = 0;
  if (e < E) {
    const int v = valid[e];
    if (v != 0) {
      const long long u = edges[2 * e], w = edges[2 * e + 1];
      cnt = (long long)merge_count(nbr_a + u * d_a, 1, wa, nbr_b + w * d_b, 1,
                                   wb) * v;
    }
  }
  block_sum_add(cnt, out);
}

constexpr int kThreads = 256;

// K14's block: the witness table and the staged rows.
constexpr int kSlotBits = 11;
constexpr int kSlots = 1 << kSlotBits;
constexpr int kProbes = 8;
constexpr int kEmpty = -1;
constexpr int kStageInts = 4096;          // 16 KB, split among the groups
// (kUnroll, slot_table.cuh's 4: K14's staging rounds a vote)

// Adds 1 to witness x (0 <= x < n_out) in the block's table, or in device
// memory when its kProbes slots hold other ids.
__device__ __forceinline__ void add_witness(int* keys, unsigned* counts, int x,
                                            unsigned long long* out) {
  unsigned h = ((unsigned)x * 2654435761u) >> (32 - kSlotBits);
  for (int p = 0; p < kProbes; ++p, h = (h + 1) & (kSlots - 1)) {
    int k = *(volatile int*)(keys + h);
    if (k == kEmpty) k = atomicCAS(keys + h, kEmpty, x);
    if (k == kEmpty || k == x) {
      atomicAdd(counts + h, 1u);
      return;
    }
  }
  atomicAdd(out + x, 1ull);
}

// One edge a group of G lanes (see the header): the wider row (b) staged a
// piece at a time, each entry of the narrower row (a) searched in it.
template <int G>
__global__ void __launch_bounds__(kThreads)
vertex_kernel(const int* __restrict__ nbr, long long d_pad,
              const int* __restrict__ edges, const int* __restrict__ valid,
              int wa, int wb, int b_col, long long E,
              unsigned long long* out, long long n_out) {
  constexpr int kGroups = kThreads / G;
  constexpr int kCap = kStageInts / kGroups;
  __shared__ int keys[kSlots];
  __shared__ unsigned counts[kSlots];
  __shared__ int stage[kStageInts];
  for (int s = threadIdx.x; s < kSlots; s += kThreads) {
    keys[s] = kEmpty;
    counts[s] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int shift = threadIdx.x & 31 & ~(G - 1);
  const unsigned gmask =
      (G == 32 ? 0xffffffffu : (1u << (G % 32)) - 1) << shift;
  int* buf = stage + grp * kCap;
  // the group's lanes' votes, lane 0 of the group in bit 0 (lanes of other
  // groups that run the same instruction are masked off)
  auto ballot = [&](bool p) {
    return (__ballot_sync(gmask, p) & gmask) >> shift;
  };

  for (long long e = (long long)blockIdx.x * kGroups + grp; e < E;
       e += (long long)gridDim.x * kGroups) {
    const int v = valid[e];
    if (v <= 0) continue;
    const long long u = edges[2 * e], w = edges[2 * e + 1];
    const int* ra = nbr + (b_col ? u : w) * d_pad;
    const int* rb = nbr + (b_col ? w : u) * d_pad;
    auto a_at = [&](int i) { return i < wa ? ra[i] : GMS_SENTINEL; };
    int cnt = 0;
    int a0 = 0;                  // a's entries before a0 lie below the piece
    int x_a0 = a_at(lane);       // a's round at a0, loaded ahead
    bool a_done = wa <= 0;
    for (int p0 = 0; p0 < wb && !a_done; p0 += kCap) {
      // stage rb[p0 ..) up to its first SENTINEL, at most kCap entries,
      // kUnroll rounds of loads in flight before their votes
      const int lim = min(kCap, wb - p0);
      int n = lim;
      bool b_end = p0 + lim == wb;
      for (int t = 0; t < lim && n == lim; t += kUnroll * G) {
        int y[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const int i = t + q * G + lane;
          y[q] = i < lim ? rb[p0 + i] : GMS_SENTINEL;
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const int i = t + q * G + lane;
          if (i < lim) buf[i] = y[q];
          const unsigned sent = ballot(y[q] == GMS_SENTINEL && i < lim);
          if (sent && n == lim) {
            n = t + q * G + __ffs(sent) - 1;
            b_end = true;
          }
        }
      }
      __syncwarp(gmask);
      if (n == 0) break;
      const int hi = buf[n - 1];
      int x = x_a0;
      for (int s0 = a0; s0 < wa; s0 += G) {
        const int x_next = a_at(s0 + G + lane);
        if (x <= hi) {           // SENTINEL > hi: b's entries are ids
          int l = 0, r = n - 1;
          while (l < r) {
            const int m = (l + r) >> 1;
            if (buf[m] < x) l = m + 1;
            else r = m;
          }
          if (buf[l] == x) {
            ++cnt;
            if (x >= 0 && x < n_out) add_witness(keys, counts, x, out);
          }
        }
        // an entry past hi may match the next piece: resume at this round
        if (ballot(x > hi && x != GMS_SENTINEL)) {
          a0 = s0;
          x_a0 = x;
          break;
        }
        if (ballot(x == GMS_SENTINEL) || s0 + G >= wa) {
          a_done = true;
          break;
        }
        x = x_next;
      }
      __syncwarp(gmask);         // buf is rewritten by the next piece
      if (b_end) break;
    }
    for (int o = G / 2; o > 0; o >>= 1) cnt += __shfl_xor_sync(gmask, cnt, o);
    if (lane == 0 && cnt > 0) {
      const unsigned long long add = (unsigned long long)cnt * v;
      if (u >= 0 && u < n_out) atomicAdd(out + u, add);
      if (w >= 0 && w < n_out) atomicAdd(out + w, add);
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < kSlots; s += kThreads)
    if (counts[s]) atomicAdd(out + keys[s], (unsigned long long)counts[s]);
}

template <int G>
cudaError_t launch_vertex(const int* nbr, long long d_pad, const int* edges,
                          const int* valid, int wa, int wb, int b_col,
                          long long E, unsigned long long* out,
                          long long n_out, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, vertex_kernel<G>, kThreads, 0);
  if (err != cudaSuccess) return err;
  constexpr int kGroups = kThreads / G;
  const long long need = (E + kGroups - 1) / kGroups;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  vertex_kernel<G><<<(unsigned)(need < fit ? need : fit), kThreads, 0,
                     stream>>>(nbr, d_pad, edges, valid, wa, wb, b_col, E,
                               out, n_out);
  return cudaSuccess;
}

// K40's blocks and their staged rows.
constexpr int kOwnedThreads = 256;
constexpr int kOwnedWarps = kOwnedThreads / 32;
constexpr int kBitWords = 8192;           // the bitmap: 2^18 ids, 32 KB

// An owned row's live values as a bitmap over [lo, lo + 32 kBitWords).
struct BitSlots {
  const unsigned* bits;
  int lo;
  __device__ __forceinline__ int find(int x) const {
    const unsigned d = (unsigned)(x - lo);
    return d < 32u * kBitWords && (bits[d >> 5] >> (d & 31) & 1u) ? 0 : -1;
  }
};

// This warp's edges of an item, first + warp + kOwnedWarps i: each edge's
// hits in its visiting row's live entries (warp_row_count), times its
// weight, into acc (a lane's share). The warp loads its next edge's row
// id, weight and length while it walks.
template <class Lookup>
__device__ __forceinline__ void item_edges(
    const int* __restrict__ vis, const int* __restrict__ wt,
    const int* __restrict__ vlen, long long first, int count, int warp,
    int lane, long long& acc, const int* __restrict__ nbr_b, long long d_b,
    int wb, int last, const Lookup& look) {
  int v = 0, w = 0, len = 0;
  if (warp < count) {
    v = vis[first + warp], w = wt[first + warp], len = vlen[first + warp];
  }
  for (int i = warp; i < count; i += kOwnedWarps) {
    const int vi = v, wi = w, li = min(len, wb);
    if (i + kOwnedWarps < count) {
      const long long k = first + i + kOwnedWarps;
      v = vis[k], w = wt[k], len = vlen[k];
    }
    acc += (long long)warp_row_count(nbr_b + vi * d_b, li, last, look,
                                     lane) * wi;
  }
}

// A block an item: the owned row's live prefix staged by load_slots (W
// slots, a power of two >= wa) and set in a bitmap of its value range, or,
// where that range is wider than the bitmap, binary-searched; the item's
// edges dealt to the warps in turn. The bitmap is all zero between items:
// an item clears the words it set.
__global__ void __launch_bounds__(kOwnedThreads)
owned_rows_kernel(const int* __restrict__ nbr_a, long long d_a,
                  const int* __restrict__ nbr_b, long long d_b,
                  const int* __restrict__ items, long long n_items,
                  const int* __restrict__ vis, const int* __restrict__ wt,
                  const int* __restrict__ vlen, int wa, int wb, int W,
                  unsigned long long* out) {
  extern __shared__ unsigned bits[];      // [kBitWords], then r_nbr[W]
  int* r_nbr = reinterpret_cast<int*>(bits + kBitWords);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kBitWords; i += kOwnedThreads) bits[i] = 0u;
  __syncthreads();
  long long acc = 0;
  for (long long it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int u = items[3 * it], first = items[3 * it + 1],
              count = items[3 * it + 2];
    const Slots<false> slots = load_slots<false, true>(
        nbr_a + u * d_a, wa, W, nullptr, 0, r_nbr);
    const int n = slots.n;
    if (n > 0) {
      const int lo = r_nbr[0], last = r_nbr[n - 1];
      if (last - lo < 32 * kBitWords) {   // block-uniform
        for (int j = threadIdx.x; j < n; j += kOwnedThreads) {
          const int d = r_nbr[j] - lo;
          atomicOr(bits + (d >> 5), 1u << (d & 31));
        }
        __syncthreads();
        item_edges(vis, wt, vlen, first, count, warp, lane, acc, nbr_b, d_b,
                   wb, last, BitSlots{bits, lo});
        __syncthreads();
        for (int j = threadIdx.x; j < n; j += kOwnedThreads)
          bits[(r_nbr[j] - lo) >> 5] = 0u;
      } else {
        item_edges(vis, wt, vlen, first, count, warp, lane, acc, nbr_b, d_b,
                   wb, last, slots);
      }
    }
    __syncthreads();   // r_nbr and the bitmap are rebuilt for the next item
  }
  block_sum_add(acc, out);
}

}  // namespace

extern "C" int tier_intersect_stream(const void* a, const void* b, int wa,
                                     int wb, long long E, void* out,
                                     void* stream) {
  if (E > 0) {
    const long long blocks = (E + kThreads - 1) / kThreads;
    stream_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)a, (const int*)b, wa, wb, E, (unsigned long long*)out);
  }
  return (int)cudaGetLastError();
}

// K40: items int32[n_items, 3] (owned row, first edge, count); vis, wt,
// vlen int32[E'] (each scheduled edge's visiting row, weight and that row's
// live length, grouped by item).
extern "C" int tier_intersect_owned(const void* nbr_a, long long d_a,
                                    const void* nbr_b, long long d_b,
                                    const void* items, long long n_items,
                                    const void* vis, const void* wt,
                                    const void* vlen, int wa, int wb,
                                    void* out, void* stream) {
  if (n_items > 0 && wa > 0 && wb > 0) {
    int W = 64;
    while (W < wa) W <<= 1;
    const size_t smem = sizeof(unsigned) * kBitWords + sizeof(int) * W;
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(owned_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, owned_rows_kernel, kOwnedThreads, smem);
    if (e != cudaSuccess) return (int)e;
    const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
    owned_rows_kernel<<<(unsigned)(n_items < fit ? n_items : fit),
                        kOwnedThreads, smem, (cudaStream_t)stream>>>(
        (const int*)nbr_a, d_a, (const int*)nbr_b, d_b, (const int*)items,
        n_items, (const int*)vis, (const int*)wt, (const int*)vlen, wa, wb, W,
        (unsigned long long*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int tier_intersect_gather(const void* nbr, long long d_pad,
                                     const void* edges, const void* valid,
                                     int wa, int wb, long long E, void* out,
                                     void* stream) {
  if (E > 0) {
    const long long blocks = (E + kThreads - 1) / kThreads;
    gather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)nbr, d_pad, (const int*)nbr, d_pad, (const int*)edges,
        (const int*)valid, wa, wb, E, (unsigned long long*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int tier_intersect_vertex(const void* nbr, long long d_pad,
                                     const void* edges, const void* valid,
                                     int wa, int wb, long long E, void* out,
                                     long long n_out, void* stream) {
  if (E > 0) {
    // the group searches the narrower width's entries in the wider row
    const int b_col = wb >= wa;
    const int narrow = b_col ? wa : wb, wide = b_col ? wb : wa;
    const int* n = (const int*)nbr;
    const int* ed = (const int*)edges;
    const int* va = (const int*)valid;
    unsigned long long* o = (unsigned long long*)out;
    const cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t e =
        narrow <= 8 ? launch_vertex<8>(n, d_pad, ed, va, narrow, wide, b_col,
                                       E, o, n_out, s)
        : narrow <= 16 ? launch_vertex<16>(n, d_pad, ed, va, narrow, wide,
                                           b_col, E, o, n_out, s)
                       : launch_vertex<32>(n, d_pad, ed, va, narrow, wide,
                                           b_col, E, o, n_out, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
