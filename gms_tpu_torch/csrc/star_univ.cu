// K11 build_local_univ: per-root local universe of k-clique-star listing,
// the root's full neighbourhood: undirected and rank-oriented local
// adjacency bitsets and the initial candidate and star sets.
//
// Replaces gms_tpu/algorithms/k_clique_star.py:54 build_local_univ, whose
// two branches (a blocked broadcast compare and a searchsorted scan, chosen
// by size at :82) give the same bits; this one kernel gives them too. With
// r = roots[b], r_nbr[j] = nbr[clip(r, 0, V_pad-1), j] for j < min(W, D),
// SENTINEL beyond (W = 32*ww), rank(v) = rank_pad[clip(v, 0, n_rank-1)] and
// valid(j) = r_nbr[j] != SENTINEL:
//   bit j of adj_full[b, i] = valid(i) && valid(j) &&
//                             r_nbr[j] in nbr[clip(r_nbr[i]), 0:D]
//   bit j of adj_dag[b, i]  = bit j of adj_full[b, i] &&
//                             rank(r_nbr[j]) > rank(r_nbr[i])
//   bit j of S0[b]          = valid(j) && rank(r_nbr[j]) > rank(r)
//   bit j of I0[b]          = valid(j)
// Words are written as uint32 bits into int32 tensors.
//
// Design, K4's (local_adj.cu): the work is spread over the grid by live
// local row. Rows are strictly ascending with a SENTINEL tail (the padded
// layout), so a root's valid slots are the prefix [0, L) of r_nbr. The grid
// holds one block for each (root, slab of 16 local rows); a block whose
// slab lies past L writes its rows of both matrices as zeros with 16-byte
// stores and leaves (a tier's pad roots and a hub job's narrow roots use a
// small prefix of W). A live block loads the root's slots into shared
// memory and a hash table, and their ranks lrank[0, L); each warp takes
// local rows i < L of its slab and walks row nbr[r_nbr[i]] against the
// root's slots until an element passes the root's last live value
// r_nbr[L-1], setting bit j in its full buffer, and in its dag buffer too
// where lrank[j] > lrank[i]; then writes each buffer with one coalesced
// store (slot_table.cuh's warp_row_bits_if, shared with K4, K8 and K40;
// above W = 8192 a binary search in place of the table). Slab 0 also writes
// S0 and I0, two ballots a word.
//
// Bound on an H100 (3.35 TB/s): bytes. Each distinct row read once up to
// and including its first SENTINEL, the ranks of the roots and their slots,
// the roots, and the 2*C*W*WW + 2*C*WW output words written once. This
// kernel reads a root's row and its slots' ranks once per live slab, and a
// neighbour's row once per root that holds it (L2 catches the repeats).

#include <cuda_runtime.h>

#include "slot_table.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 16;            // local rows a block

template <bool kHash>
__global__ void __launch_bounds__(kThreads) univ_kernel(
    const int* __restrict__ nbr, long long v_pad, int d,
    const int* __restrict__ rank_pad, long long n_rank,
    const int* __restrict__ roots, int ww, int table_cap,
    unsigned* __restrict__ adj_full, unsigned* __restrict__ adj_dag,
    unsigned* __restrict__ s0, unsigned* __restrict__ i0) {
  extern __shared__ int4 smem4[];
  const int W = 32 * ww;
  const int slabs = W / kSlab;
  const long long b = blockIdx.x / slabs;
  const int first = (int)(blockIdx.x % slabs) * kSlab;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r = roots[b];
  const int* root_row = nbr + clip_row(r, v_pad) * d;
  const int wmax = W < d ? W : d;
  const long long slab = (b * W + first) * ww;

  // a slab past the live prefix: zeros, 16 bytes a store
  if (first >= wmax || root_row[first] == GMS_SENTINEL) {
    zero_words(adj_full + slab, (long long)kSlab * ww);
    zero_words(adj_dag + slab, (long long)kSlab * ww);
    if (first == 0)
      for (int w = threadIdx.x; w < ww; w += kThreads)
        s0[b * ww + w] = i0[b * ww + w] = 0u;
    return;
  }

  // shared memory: the table (kHash) | r_nbr[W] | lrank[W] | two word
  // buffers a warp
  int2* table = reinterpret_cast<int2*>(smem4);
  int* r_nbr = kHash ? reinterpret_cast<int*>(table + table_cap)
                     : reinterpret_cast<int*>(smem4);
  int* lrank = r_nbr + W;
  unsigned* full = reinterpret_cast<unsigned*>(lrank + W) + warp * 2 * ww;
  unsigned* dag = full + ww;
  const Slots<kHash> slots =
      load_slots<kHash>(root_row, wmax, W, table, table_cap, r_nbr);
  const int L = slots.n;
  for (int j = threadIdx.x; j < L; j += kThreads)
    lrank[j] = rank_pad[clip_row(r_nbr[j], n_rank)];
  __syncthreads();
  if (first == 0) {
    const int rrank = rank_pad[clip_row(r, n_rank)];
    for (int w = warp; w < ww; w += kWarps) {
      const int j = 32 * w + lane;
      const bool valid = j < L;
      const unsigned vm = __ballot_sync(kFull, valid);
      const unsigned sm = __ballot_sync(kFull, valid && lrank[j] > rrank);
      if (lane == 0) {
        i0[b * ww + w] = vm;
        s0[b * ww + w] = sm;
      }
    }
  }

  const int last = r_nbr[L - 1];
  for (int i = first + warp; i < first + kSlab; i += kWarps) {
    unsigned* of = adj_full + slab + (long long)(i - first) * ww;
    unsigned* od = adj_dag + slab + (long long)(i - first) * ww;
    if (i >= L) {
      for (int w = lane; w < ww; w += 32) of[w] = od[w] = 0u;
      continue;
    }
    const int ri = lrank[i];
    warp_row_bits_if(nbr + clip_row(r_nbr[i], v_pad) * d, d, last, slots,
                     lane, full, dag, ww,
                     [&](int j) { return lrank[j] > ri; });
    for (int w = lane; w < ww; w += 32) {
      of[w] = full[w];
      od[w] = dag[w];
    }
    __syncwarp();
  }
}

template <bool kHash>
int launch(const int* nbr, long long v_pad, int d, const int* rank_pad,
           long long n_rank, const int* roots, long long c, int ww,
           unsigned* adj_full, unsigned* adj_dag, unsigned* s0, unsigned* i0,
           cudaStream_t stream) {
  const int W = 32 * ww;
  const int cap = kHash ? slot_table_cap(W) : 0;
  const size_t smem = (size_t)(2 * W + kWarps * 2 * ww) * sizeof(int) +
                      (size_t)cap * sizeof(int2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        univ_kernel<kHash>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = c * (W / kSlab);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  univ_kernel<kHash><<<(unsigned)blocks, kThreads, smem, stream>>>(
      nbr, v_pad, d, rank_pad, n_rank, roots, ww, cap, adj_full, adj_dag, s0,
      i0);
  return 0;
}

}  // namespace

extern "C" int build_local_univ(const void* nbr, long long v_pad, int d,
                                const void* rank_pad, long long n_rank,
                                const void* roots, long long c, int ww,
                                void* adj_full, void* adj_dag, void* s0,
                                void* i0, void* stream) {
  if (c > 0 && ww > 0 && n_rank > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int err =
        32 * ww <= kMaxHashW
            ? launch<true>((const int*)nbr, v_pad, d, (const int*)rank_pad,
                           n_rank, (const int*)roots, c, ww,
                           (unsigned*)adj_full, (unsigned*)adj_dag,
                           (unsigned*)s0, (unsigned*)i0, st)
            : launch<false>((const int*)nbr, v_pad, d, (const int*)rank_pad,
                            n_rank, (const int*)roots, c, ww,
                            (unsigned*)adj_full, (unsigned*)adj_dag,
                            (unsigned*)s0, (unsigned*)i0, st);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
