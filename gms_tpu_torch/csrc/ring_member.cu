// K39 member_pack: one rotation's membership bits of the ring-streamed
// vertex-sharded plans, OR-ed into the chunk's local bitsets.
//
// Replaces the two packs of gms_tpu/parallel/sharding.py that fold the
// visiting table shard into a root chunk's universe: `member_blocks`
// (:379-400, VertexShardedBKPlan, called twice a rotation: the induced DAG
// adjacency over the root's row Q, and the cover bitsets M over its lower
// neighbours) and the inline pack of VertexShardedKCliquePlan (:579-603).
// With q[c] the root's row (W = 32*ww slots, strictly ascending with a
// SENTINEL tail) and vis the visiting shard's rows (Vs x d, the same
// layout), for every slot i of locs[c, 0:L] with sel[c, i]:
//   out[c, i, :] |= {j : q[c, j] != SENTINEL &&
//                        q[c, j] in vis[clip(locs[c, i], 0, Vs-1), 0:d]}
// Unselected slots are left as they are. The caller selects the slots whose
// vertex the visiting shard owns, once a rotation (valid & owner == (me+t)
// mod N); words are uint32 bits in int32 tensors.
//
// Design, K4's slab grid (local_adj.cu) on slot_table.cuh: one block per
// (root c, slab of kSlab = 32 slots of locs). Every warp reads the slab's
// selections as one ballot; a block whose slab has no selected slot, or
// whose root is a pad root (q[c, 0] == SENTINEL), returns before it loads
// anything else: the OR leaves its words as they are, so it writes nothing
// (at world size N only about 1/N of a row's slots are selected in each
// rotation). In a live block the warps take the selected slots in turn,
// each loading its first slot's row index while the block loads the root's
// live slots into shared memory and a hash table (a binary search above W
// = 8192). A warp walks its visiting row against the root's slots until an
// element passes the root's last live value (which also stops it at the
// row's first SENTINEL), loading its next slot's row index meanwhile, then
// ORs its word buffer's non-zero words into out as reductions (a word is
// the warp's alone; nothing is read back). A hub row of thousands of
// entries is read only as far as the root's values reach. Slabs of 32 slots
// measured faster than 16 or 64 on the ring plans' packs.
//
// Bound on an H100 (3.35 TB/s): bytes. Each distinct visiting row a
// selected slot names, read once up to and including its first SENTINEL
// (the yardstick; the walk reads it only to the entry that passes the
// root's last value); the q rows, locs and sel; the selected out words read
// and written once.

#include <cuda_runtime.h>

#include "slot_table.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 32;            // slots of locs a block

template <bool kHash>
__global__ void __launch_bounds__(kThreads) member_kernel(
    const int* __restrict__ q_rows, int ww, const int* __restrict__ vis,
    long long vs, int d, const int* __restrict__ locs,
    const unsigned char* __restrict__ sel, int L, int table_cap,
    unsigned* __restrict__ out) {
  static_assert(kSlab == 32, "a warp's ballot lists a slab");
  extern __shared__ int4 smem4[];
  const int W = 32 * ww;
  const int slabs = (L + kSlab - 1) / kSlab;
  const long long c = blockIdx.x / slabs;
  const int i0 = (int)(blockIdx.x % slabs) * kSlab;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* q_row = q_rows + c * W;

  // every warp reads the slab's selections: a dead slab (none) or a pad
  // root leaves at once, the same in every warp, and writes nothing
  const unsigned listed =
      __ballot_sync(kFull, i0 + lane < L && sel[c * L + i0 + lane]);
  if (listed == 0u || q_row[0] == GMS_SENTINEL) return;
  // this warp's slots: the listed ones of rank warp, warp + kWarps, ...;
  // the first one's row index loads while the block builds the table
  unsigned mine = listed;
  for (int k = 0; k < warp && mine; ++k) mine &= mine - 1u;
  int loc = mine ? locs[c * L + i0 + __ffs(mine) - 1] : 0;

  // shared memory: the table (kHash) | r_nbr[W] | a word buffer a warp
  int2* table = reinterpret_cast<int2*>(smem4);
  int* r_nbr = kHash ? reinterpret_cast<int*>(table + table_cap)
                     : reinterpret_cast<int*>(smem4);
  unsigned* bits = reinterpret_cast<unsigned*>(r_nbr + W) + warp * ww;
  const Slots<kHash> slots =
      load_slots<kHash, true>(q_row, W, W, table, table_cap, r_nbr);
  const int last = r_nbr[slots.n - 1];

  while (mine) {
    const long long slot = c * L + i0 + __ffs(mine) - 1;
    const int* row = vis + clip_row(loc, vs) * d;
    for (int k = 0; k < kWarps && mine; ++k) mine &= mine - 1u;
    if (mine) loc = locs[c * L + i0 + __ffs(mine) - 1];
    warp_row_bits(row, d, last, slots, lane, bits, ww);
    // a word of out is this warp's alone: the OR goes as a reduction,
    // without a read on the way
    unsigned* o = out + slot * ww;
    for (int w = lane; w < ww; w += 32)
      if (bits[w]) atomicOr(o + w, bits[w]);
    __syncwarp();
  }
}

template <bool kHash>
int launch(const int* q, int ww, const int* vis, long long vs, int d,
           const int* locs, const unsigned char* sel, long long c, int L,
           unsigned* out, cudaStream_t stream) {
  const int W = 32 * ww;
  const int cap = kHash ? slot_table_cap(W) : 0;
  const size_t smem =
      (size_t)(W + kWarps * ww) * sizeof(int) + (size_t)cap * sizeof(int2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        member_kernel<kHash>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = c * ((L + kSlab - 1) / kSlab);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  member_kernel<kHash><<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, ww, vis, vs, d, locs, sel, L, cap, out);
  return 0;
}

}  // namespace

extern "C" int member_pack(const void* q, int ww, const void* vis,
                           long long vs, int d, const void* locs,
                           const void* sel, long long c, int L, void* out,
                           void* stream) {
  if (c > 0 && ww > 0 && L > 0 && vs > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int err =
        32 * ww <= kMaxHashW
            ? launch<true>((const int*)q, ww, (const int*)vis, vs, d,
                           (const int*)locs, (const unsigned char*)sel, c, L,
                           (unsigned*)out, s)
            : launch<false>((const int*)q, ww, (const int*)vis, vs, d,
                            (const int*)locs, (const unsigned char*)sel, c,
                            L, (unsigned*)out, s);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
