// K8 hub_cover_bits: the cover bitsets of Bron-Kerbosch's leaf maximality
// filter, read straight from the lower-neighbour CSR.
//
// Replaces gms_tpu/algorithms/bron_kerbosch.py:876 _gather_wlists (each
// root's lower-ranked neighbour list, padded with SENTINEL to IN slots) and
// :376 _hub_cover_bits (a blocked broadcast compare of each listed w's DAG
// row against the root's W DAG slots). With r = roots[b], n the vertices,
// live = r < n, s = clip(r, 0, n-1), cnt = live ? indptr[s+1] - indptr[s] : 0,
// w_i = i < cnt ? cols[clip(indptr[s] + i)] : SENTINEL, and the root's slots
// q[j] = nbr[clip(r, 0, V_pad-1), j] for j < min(W, D), SENTINEL beyond:
//   bit j of M[b, i] = q[j] != SENTINEL && q[j] in nbr[clip(w_i), 0:D]
//   wvalid[b, i]     = w_i != SENTINEL
// (a SENTINEL w clips to the all-SENTINEL guard row V_pad-1: no bits). The
// lists are not materialized.
//
// Design, K4's slab grid (local_adj.cu): one block for each (root, slab of
// 64 lower-neighbour slots i), C * ceil(IN / 64) blocks of 8 warps, so that
// a hub root's thousands of lower neighbours spread over tens of blocks and
// the pad roots of a hub job (one to a few real roots padded to 256) cost
// blocks that only write zeros. The grid's blocks, most of them dead, set
// the time: on an H100, slabs of 64 rows took 0.25 ms over the warm fused
// RMAT-14 call, of 32 0.26 and of 16 0.38 (bench/cover_decode.py). A slab
// is dead when i0 >= cnt (a pad root has cnt = 0; a negative root clips to
// vertex 0 and takes its list): it writes its M rows as zeros with 16-byte
// stores, clears its wvalid bytes and leaves without reading the root's
// row. A live slab reads its w_i once, coalesced, loads the root's slots
// into shared memory and a hash table (slot_table.cuh, shared with K4;
// above W = 8192 a binary search), and gives each live w_i a warp that walks
// w_i's row kUnroll chunks at a time until an element passes the root's
// last live slot, ORs its hits into a word buffer in shared memory and
// writes it with one coalesced store.
//
// Bound on an H100 (3.35 TB/s): bytes. Each distinct DAG row read (the
// roots' and their lower neighbours') up to and including its first
// SENTINEL, the roots' CSR entries, and M and wvalid written once. This
// kernel reads a row once per root that lists it (L2 catches the repeats).

#include <cuda_runtime.h>

#include "slot_table.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 64;            // lower-neighbour slots a block

template <bool kHash>
__global__ void __launch_bounds__(kThreads) cover_kernel(
    const int* __restrict__ nbr, long long v_pad, int d,
    const int* __restrict__ indptr, long long n,
    const int* __restrict__ cols, long long n_cols,
    const int* __restrict__ roots, int ww, int in_w, int slabs,
    int table_cap, unsigned* __restrict__ m,
    unsigned char* __restrict__ wvalid) {
  extern __shared__ int4 smem4[];
  const int W = 32 * ww;
  const long long b = blockIdx.x / slabs;
  const int i0 = (int)(blockIdx.x % slabs) * kSlab;
  const int rows = in_w - i0 < kSlab ? in_w - i0 : kSlab;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r = roots[b];
  long long start = 0, cnt = 0;
  if (r < n) {
    const long long s = clip_row(r, n);
    start = indptr[s];
    cnt = indptr[s + 1] - start;
  }
  unsigned* slab_m = m + (b * in_w + i0) * ww;
  unsigned char* slab_v = wvalid + b * in_w + i0;

  // a slab past the root's list: zeros, 16 bytes a store
  if (i0 >= cnt) {
    zero_words(slab_m, (long long)rows * ww);
    if (threadIdx.x < rows) slab_v[threadIdx.x] = 0;
    return;
  }

  // shared memory: the table (kHash) | r_nbr[W] | a word buffer a warp |
  // the slab's w_i
  int2* table = reinterpret_cast<int2*>(smem4);
  int* r_nbr = kHash ? reinterpret_cast<int*>(table + table_cap)
                     : reinterpret_cast<int*>(smem4);
  unsigned* bits = reinterpret_cast<unsigned*>(r_nbr + W) + warp * ww;
  int* ws = r_nbr + W + kWarps * ww;
  if (threadIdx.x < rows) {
    const int i = i0 + threadIdx.x;
    ws[threadIdx.x] =
        i < cnt ? cols[clip_row(start + i, n_cols)] : GMS_SENTINEL;
  }
  const int wmax = W < d ? W : d;
  const Slots<kHash> slots = load_slots<kHash>(
      nbr + clip_row(r, v_pad) * d, wmax, W, table, table_cap, r_nbr);
  const int L = slots.n;
  const int last = L > 0 ? r_nbr[L - 1] : 0;

  for (int t = warp; t < rows; t += kWarps) {
    const int u = ws[t];
    unsigned* out = slab_m + (long long)t * ww;
    if (u == GMS_SENTINEL || L == 0) {
      for (int w = lane; w < ww; w += 32) out[w] = 0u;
    } else {
      warp_row_bits(nbr + clip_row(u, v_pad) * d, d, last, slots, lane, bits,
                    ww);
      for (int w = lane; w < ww; w += 32) out[w] = bits[w];
    }
    if (lane == 0) slab_v[t] = u != GMS_SENTINEL;
    __syncwarp();
  }
}

template <bool kHash>
int launch(const int* nbr, long long v_pad, int d, const int* indptr,
           long long n, const int* cols, long long n_cols, const int* roots,
           long long c, int ww, int in_w, unsigned* m, unsigned char* wvalid,
           cudaStream_t stream) {
  const int W = 32 * ww;
  const int cap = kHash ? slot_table_cap(W) : 0;
  const size_t smem = (size_t)(W + kWarps * ww + kSlab) * sizeof(int) +
                      (size_t)cap * sizeof(int2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cover_kernel<kHash>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int slabs = (in_w + kSlab - 1) / kSlab;
  const long long blocks = c * slabs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cover_kernel<kHash><<<(unsigned)blocks, kThreads, smem, stream>>>(
      nbr, v_pad, d, indptr, n, cols, n_cols, roots, ww, in_w, slabs, cap, m,
      wvalid);
  return 0;
}

}  // namespace

extern "C" int hub_cover_bits(const void* nbr, long long v_pad, int d,
                              const void* indptr, long long n, const void* cols,
                              long long n_cols, const void* roots, long long c,
                              int ww, int in_w, void* m, void* wvalid,
                              void* stream) {
  if (c > 0 && ww > 0 && in_w > 0 && n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int err =
        32 * ww <= kMaxHashW
            ? launch<true>((const int*)nbr, v_pad, d, (const int*)indptr, n,
                           (const int*)cols, n_cols, (const int*)roots, c, ww,
                           in_w, (unsigned*)m, (unsigned char*)wvalid, s)
            : launch<false>((const int*)nbr, v_pad, d, (const int*)indptr, n,
                            (const int*)cols, n_cols, (const int*)roots, c,
                            ww, in_w, (unsigned*)m, (unsigned char*)wvalid,
                            s);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
