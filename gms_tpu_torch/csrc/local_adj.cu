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
// roots use a small prefix). A live block loads the root's slots into
// shared memory and a hash table, and each warp takes local rows i < L of
// its slab: it walks row nbr[r_nbr[i]] against the root's slots until an
// element passes the root's last live value r_nbr[L-1], then writes its
// word buffer with one coalesced store (slot_table.cuh, shared with K8's
// hub_cover_bits; above W = 8192 a binary search in place of the table).

#include <cuda_runtime.h>

#include "slot_table.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 16;            // local rows a block

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
    zero_words(slab_out, (long long)kSlab * ww);
    if (i0 == 0)
      for (int w = threadIdx.x; w < ww; w += kThreads) s0[b * ww + w] = 0u;
    return;
  }

  // shared memory: the table (kHash) | r_nbr[W] | a word buffer a warp
  int2* table = reinterpret_cast<int2*>(smem4);
  int* r_nbr = kHash ? reinterpret_cast<int*>(table + table_cap)
                     : reinterpret_cast<int*>(smem4);
  unsigned* bits = reinterpret_cast<unsigned*>(r_nbr + W) + warp * ww;
  const Slots<kHash> slots =
      load_slots<kHash>(root_row, wmax, W, table, table_cap, r_nbr);
  const int L = slots.n;
  const int last = r_nbr[L - 1];
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
    warp_row_bits(nbr + clip_row(r_nbr[i], v_pad) * d, d, last, slots, lane,
                  bits, ww);
    for (int w = lane; w < ww; w += 32) out[w] = bits[w];
    __syncwarp();
  }
}

template <bool kHash>
int launch(const int* nbr, long long v_pad, int d, const int* roots,
           long long c, int ww, unsigned* adj, unsigned* s0,
           cudaStream_t stream) {
  const int W = 32 * ww;
  const int cap = kHash ? slot_table_cap(W) : 0;
  const size_t smem =
      (size_t)(W + kWarps * ww) * sizeof(int) + (size_t)cap * sizeof(int2);
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
