// K4 build_local_adj: per-root local DAG adjacency bitsets and the initial
// candidate sets of k-clique counting.
//
// Replaces gms_tpu/algorithms/k_clique.py:82 build_local_adj, whose two
// branches (a blocked broadcast compare and a searchsorted scan, chosen by
// size at :113) give the same bits; this one kernel gives them too. With
// r = clip(roots[b], 0, V_pad-1) and r_nbr[j] = nbr[r, j] for j < min(W, D),
// SENTINEL beyond D (W = 32*ww):
//   bit j of adj[b, i] = r_nbr[i] != SENTINEL && r_nbr[j] != SENTINEL &&
//                        r_nbr[j] in nbr[clip(r_nbr[i]), 0:D]
//   bit j of S0[b]     = r_nbr[j] != SENTINEL
// Words are written as uint32 bits into int32 tensors.
//
// Bound on an H100 (3.35 TB/s): bytes. Each distinct row read once up to and
// including its first SENTINEL, the roots, and the C*W*WW + C*WW output words
// written once.
//
// Design: the work is spread over the grid by live local row. Rows are
// strictly ascending with a SENTINEL tail (the padded layout), so a root's
// live slots are the prefix [0, L) of r_nbr. The grid holds one block for
// each (root, slab of 16 local rows), C * W / 16 blocks of 8 warps; a block
// whose slab lies past L writes its rows as zeros with 16-byte stores and
// leaves (the sharded count pads every chunk to one global W, where most
// roots use a small prefix). A live block reads the root's row once into
// shared memory and, in the same pass, into an open-addressed table (value
// -> slot, at least 4W entries up to W = 1024 and 2W above, multiplicative
// hash, linear probing: one or two probes an element, in place of log2(W)
// for a binary search). Each warp then takes local rows i < L of its slab:
// it loads row nbr[r_nbr[i]] four 32-slot chunks at a time (coalesced, the
// four loads in flight together), looks the elements up, stops once an
// element passes the root's last live value r_nbr[L-1] (which also stops it
// at its first SENTINEL), and ORs the slot bits it finds into its word
// buffer in shared memory (a shared atomicOr a hit) before one coalesced
// store. Above W = 8192 the table would not fit; there the block
// binary-searches r_nbr[0, L) in shared memory.
//
// It does not use row_search.cuh, whose binary search K8, K11 and K39 keep.

#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 16;            // local rows a block
constexpr int kUnroll = 4;           // 32-slot chunks of a row in flight
constexpr int kMaxHashW = 8192;      // the largest W the table serves
constexpr int kQuarterW = 1024;      // up to here the table is <= 1/4 full
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long clip_row(long long v, long long n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

__device__ __forceinline__ unsigned hash_of(int x, int shift) {
  return ((unsigned)x * 0x9E3779B1u) >> shift;
}

// The root's live slots, looked up: a hash table (kHash) or the sorted
// slots themselves.
template <bool kHash>
struct Slots {
  int2* table;       // kHash: [mask + 1] (value, slot), empty = SENTINEL
  int* sorted;       // !kHash: r_nbr[0, L)
  int mask, shift, n;

  __device__ __forceinline__ int find(int x) const {
    if (kHash) {
      unsigned h = hash_of(x, shift);
      while (true) {
        const int2 e = table[h];
        if (e.x == x) return e.y;
        if (e.x == GMS_SENTINEL) return -1;
        h = (h + 1) & mask;
      }
    } else {
      int lo = 0, hi = n;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sorted[mid] < x) lo = mid + 1; else hi = mid;
      }
      return lo < n && sorted[lo] == x ? lo : -1;
    }
  }
};

template <bool kHash>
__global__ void __launch_bounds__(kThreads) local_adj_kernel(
    const int* __restrict__ nbr, long long v_pad, int d,
    const int* __restrict__ roots, int ww, int table_cap,
    unsigned* __restrict__ adj, unsigned* __restrict__ s0) {
  extern __shared__ int4 smem4[];
  const int W = 32 * ww;
  const int slabs = W / kSlab;
  const long long b = blockIdx.x / slabs;
  const int i0 = (int)(blockIdx.x % slabs) * kSlab;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* root_row = nbr + clip_row(roots[b], v_pad) * d;
  const int wmax = W < d ? W : d;
  unsigned* slab_out = adj + (b * W + i0) * ww;

  // a slab past the live prefix: zeros, 16 bytes a store
  if (i0 >= wmax || root_row[i0] == GMS_SENTINEL) {
    uint4* out = reinterpret_cast<uint4*>(slab_out);
    for (int k = threadIdx.x; k < kSlab * ww / 4; k += kThreads)
      out[k] = make_uint4(0u, 0u, 0u, 0u);
    if (i0 == 0)
      for (int w = threadIdx.x; w < ww; w += kThreads) s0[b * ww + w] = 0u;
    return;
  }

  // shared memory: the table (kHash) | r_nbr[W] | a word buffer a warp
  Slots<kHash> slots;
  int2* table = reinterpret_cast<int2*>(smem4);
  int* r_nbr = kHash ? reinterpret_cast<int*>(table + table_cap)
                     : reinterpret_cast<int*>(smem4);
  unsigned* bits = reinterpret_cast<unsigned*>(r_nbr + W) + warp * ww;
  if (kHash) {
    slots.table = table;
    slots.mask = table_cap - 1;
    slots.shift = 32 - __ffs(table_cap) + 1;
    for (int h = threadIdx.x; h < table_cap; h += kThreads)
      table[h] = make_int2(GMS_SENTINEL, 0);
    __syncthreads();
  }
  // one pass over the root's row: r_nbr to shared memory, each live slot
  // into the table, L = the live prefix
  int live = 0;
  for (int base = 0; base < W; base += kThreads) {
    const int j = base + threadIdx.x;
    const int x = j < wmax ? root_row[j] : GMS_SENTINEL;
    if (j < W) r_nbr[j] = x;
    if (kHash && x != GMS_SENTINEL) {
      unsigned h = hash_of(x, slots.shift);
      while (atomicCAS(&table[h].x, GMS_SENTINEL, x) != GMS_SENTINEL)
        h = (h + 1) & slots.mask;
      table[h].y = j;
    }
    live += __syncthreads_count(x != GMS_SENTINEL);
  }
  const int L = live;
  const int last = r_nbr[L - 1];
  slots.sorted = r_nbr;
  slots.n = L;
  if (i0 == 0)
    for (int w = threadIdx.x; w < ww; w += kThreads) {
      const int rem = L - 32 * w;
      s0[b * ww + w] = rem >= 32 ? kFull : (rem <= 0 ? 0u : (1u << rem) - 1u);
    }

  for (int i = i0 + warp; i < i0 + kSlab; i += kWarps) {
    unsigned* out = slab_out + (i - i0) * ww;
    if (i >= L) {
      for (int w = lane; w < ww; w += 32) out[w] = 0u;
      continue;
    }
    for (int w = lane; w < ww; w += 32) bits[w] = 0u;
    __syncwarp();
    const int* row = nbr + clip_row(r_nbr[i], v_pad) * d;
    // kUnroll chunks of 32 slots loaded at once, then looked up
    for (int base = 0; base < d; base += 32 * kUnroll) {
      int x[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int s = base + 32 * k + lane;
        x[k] = s < d ? row[s] : GMS_SENTINEL;
      }
      bool past = false;
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (x[k] <= last) {
          const int j = slots.find(x[k]);
          if (j >= 0) atomicOr(bits + (j >> 5), 1u << (j & 31));
        }
        past |= x[k] > last;
      }
      if (__any_sync(kFull, past)) break;
    }
    __syncwarp();
    for (int w = lane; w < ww; w += 32) out[w] = bits[w];
    __syncwarp();
  }
}

template <bool kHash>
int launch(const int* nbr, long long v_pad, int d, const int* roots,
           long long c, int ww, unsigned* adj, unsigned* s0,
           cudaStream_t stream) {
  const int W = 32 * ww;
  int cap = 0;
  size_t smem = (size_t)(W + kWarps * ww) * sizeof(int);
  if (kHash) {
    cap = 64;
    while (cap < (W <= kQuarterW ? 4 : 2) * W) cap <<= 1;
    smem += (size_t)cap * sizeof(int2);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        local_adj_kernel<kHash>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = c * (W / kSlab);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  local_adj_kernel<kHash><<<(unsigned)blocks, kThreads, smem, stream>>>(
      nbr, v_pad, d, roots, ww, cap, adj, s0);
  return 0;
}

}  // namespace

extern "C" int build_local_adj(const void* nbr, long long v_pad, int d,
                               const void* roots, long long c, int ww,
                               void* adj, void* s0, void* stream) {
  if (c > 0 && ww > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int err =
        32 * ww <= kMaxHashW
            ? launch<true>((const int*)nbr, v_pad, d, (const int*)roots, c,
                           ww, (unsigned*)adj, (unsigned*)s0, s)
            : launch<false>((const int*)nbr, v_pad, d, (const int*)roots, c,
                            ww, (unsigned*)adj, (unsigned*)s0, s);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
