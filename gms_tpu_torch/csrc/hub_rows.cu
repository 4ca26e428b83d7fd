// K3 build_hub_rows: hub bitmap row i has bit hub_id[w] set for every
// w in N+(wide_ids[i]).
//
// Replaces gms_tpu/algorithms/triangle_count.py:219 build_hub_rows, run once
// while a TrianglePlan is built. The JAX program gathers with mode="clip" and
// scatter-adds with mode="drop" into hw+1 words, then slices the overflow word
// off; here each index is clipped the same way and an out-of-range bit is
// simply not written:
//   r = nbr[min(wide_ids[i], V_pad-1), slot]
//   h = hub_id[min(r, V_pad)]      (SENTINEL slots clip to the last entry,
//                                   whose value 32*hw means "drop")
//   if h < 32*hw: add bit h&31 to word h>>5 (mod 2^32, as the JAX add).
// Adding, not OR-ing, keeps the JAX program's result for any hub_id, also
// where bits repeat (a hub_id[V_pad] in range adds its bit once a SENTINEL
// slot).
//
// The row contract: each row sorted with a SENTINEL tail (nothing after its
// first SENTINEL), as K1, K14, K4, K8, K11 and K39 take it; the wrapper
// checks it under GMS_TPU_PARANOID=1. Every SENTINEL slot of a row then
// gives the same bit, hub_id[V_pad]'s, so the walk stops after the 32-slot
// step that holds the first SENTINEL, at slot f, and adds that bit
// D_pad - f times in one add.
//
// Design: a warp a (row, slab) item, eight a block. The warp zeroes its
// slab's words in shared memory, reads the row 32 slots a step up to the
// step of its first SENTINEL (a ballot), looks each entry up in hub_id (the
// 1 MB table at 2^18 vertices stays in L2) and adds the bit with a shared
// atomicAdd; then it writes every word of the slab once, zeros included,
// with 16-byte streaming stores from the first 16-byte boundary of the row's
// words on (single words before and after it). So the output needs no
// zero-fill and each output word is written once. A slab is the whole row
// while hw <= kSlabWords; a wider row is cut into slabs of at most that
// many words, each walking the row and keeping its own bits. With `guard`,
// the row after the last (the plan's guard row) is written as zeros in the
// same launch.
//
// Bound on an H100 (3.35 TB/s): bytes — each wide row up to and including
// its first SENTINEL, wide_ids, the hub_id entries looked up and the Nw*hw
// output words, each moved once. The output is most of it (342 MB of
// 359 MB at RMAT-18).

#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kWarps = 8;                // items a block, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kSlabWords = 2048;         // a warp's shared words at most

__global__ void hub_rows_kernel(const int* __restrict__ nbr, long long v_pad,
                                int d_pad, const int* __restrict__ hub_id,
                                const int* __restrict__ wide_ids, long long nw,
                                int hw, int slab, int n_slabs,
                                long long n_items, unsigned* __restrict__ out) {
  extern __shared__ unsigned bits[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = blockIdx.x * (long long)kWarps + warp;
  if (item >= n_items) return;  // the whole warp; only warp barriers follow
  const long long i = n_slabs == 1 ? item : item / n_slabs;
  const int w0 = (int)(item - i * n_slabs) * slab;
  const int words = hw - w0 < slab ? hw - w0 : slab;
  unsigned* mine = bits + warp * slab;
  for (int w = lane; w < words; w += 32) mine[w] = 0u;
  __syncwarp();
  if (i < nw) {  // row nw is the guard row: zeros only
    long long u = wide_ids[i];
    u = u < 0 ? 0 : (u >= v_pad ? v_pad - 1 : u);
    const int* row = nbr + u * d_pad;
    const int lo = 32 * w0, hi = 32 * (w0 + words);
    for (int base = 0; base < d_pad; base += 32) {
      const int slot = base + lane;
      const bool in = slot < d_pad;
      const int r = in ? row[slot] : 0;
      if (in && r != kSentinel) {
        const long long rc = r < 0 ? 0 : (r > v_pad ? v_pad : (long long)r);
        const int h = hub_id[rc];
        if (h >= lo && h < hi)
          atomicAdd(mine + ((h - lo) >> 5), 1u << (h & 31));
      }
      const unsigned sent = __ballot_sync(0xffffffffu, in && r == kSentinel);
      if (sent) {  // slots base + ffs - 1 .. d_pad - 1 are SENTINEL
        if (lane == 0) {
          const int h = hub_id[v_pad];
          const unsigned times = (unsigned)(d_pad - base - __ffs(sent) + 1);
          if (h >= lo && h < hi)
            atomicAdd(mine + ((h - lo) >> 5), times << (h & 31));
        }
        break;
      }
    }
  }
  __syncwarp();
  unsigned* dst = out + i * hw + w0;
  // words before the first 16-byte boundary, 4-word groups, the rest
  int head = (int)(((16 - ((unsigned long long)dst & 15)) & 15) >> 2);
  head = head < words ? head : words;
  const int groups = (words - head) >> 2;
  if (lane < head) dst[lane] = mine[lane];
  for (int g = lane; g < groups; g += 32) {
    const unsigned* s = mine + head + 4 * g;
    __stcs(reinterpret_cast<uint4*>(dst + head) + g,
           make_uint4(s[0], s[1], s[2], s[3]));
  }
  const int tail = head + 4 * groups;
  if (tail + lane < words) dst[tail + lane] = mine[tail + lane];
}

}  // namespace

// out: int32[nw + guard, hw]; with guard (0 or 1) the last row is zeroed.
extern "C" int build_hub_rows(const void* nbr, long long v_pad, int d_pad,
                              const void* hub_id, const void* wide_ids,
                              long long nw, int hw, int guard, void* out,
                              void* stream) {
  const long long rows = nw + (guard ? 1 : 0);
  if (rows <= 0 || hw <= 0) return (int)cudaGetLastError();
  const int n_slabs = (hw + kSlabWords - 1) / kSlabWords;
  int slab = (hw + n_slabs - 1) / n_slabs;
  slab = n_slabs == 1 ? slab : (slab + 3) & ~3;  // slabs start 16-byte apart
  const size_t smem = sizeof(unsigned) * (size_t)kWarps * slab;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hub_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_items = rows * n_slabs;
  const long long blocks = (n_items + kWarps - 1) / kWarps;
  hub_rows_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)nbr, v_pad, d_pad, (const int*)hub_id, (const int*)wide_ids,
      nw, hw, slab, n_slabs, n_items, (unsigned*)out);
  return (int)cudaGetLastError();
}
