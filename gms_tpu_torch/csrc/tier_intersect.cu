// K1 intersect_count: Σ over edges e of |A_e ∩ B_e| for the narrow degree
// tiers of the triangle-count plan; K14, the same tiers counted per vertex;
// and K40, K1's gather mode over two row tables.
//
// Replaces three device programs of gms_tpu/algorithms/triangle_count.py:
//   * count_tier_mat (:383)  — stream mode: operand rows pre-gathered and
//     stored transposed, a[wa, E] and b[wb, E]; row e is column e, stride E;
//   * count_dag_edges (:99)  — gather mode: rows nbr[u, :wa] and nbr[v, :wb]
//     of the padded adjacency (row stride D_pad), with valid[e] weighting
//     each edge (0 for padding edges, which point at vertex 0);
//   * the rotation body of gms_tpu/parallel/sharding.py:206-216
//     (VertexShardedTrianglePlan) — K40, the gather mode over two tables
//     (tier_intersect_cross): u's row from the owned table shard, v's from
//     the visiting one, each with its own row stride, so the ring never
//     copies a shard into one buffer;
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
// Design: one thread per edge. Both rows are sorted ascending with a SENTINEL
// (int32 max) tail — the padded-layout invariant of harness/checks.py — so the
// thread merges them in O(wa + wb) steps instead of the wa*wb compare cube of
// the TPU program. An a-element counts only when it is not SENTINEL (SENTINEL
// equals SENTINEL; gms_tpu masks that diagonal at triangle_count.py:413): the
// merge stops at the first SENTINEL on either side, since nothing after it can
// match. Widths are runtime values (tiers reach D_pad).
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
// K14 adds with 64-bit integer atomicAdd, bit-identical to a sequential sum
// in any order. Its risk is time, not exactness: under the degree order the
// witnesses are the high-rank hubs, so the atomics of one launch pile onto a
// few addresses (RMAT-18: 82,647,223 witness increments). Its bound is the
// gather mode's bytes plus the int64 output written once.

#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

struct NoWitness {
  __device__ void operator()(int) const {}
};

// |a ∩ b| of two sorted rows; on_match(x) is called for each common x.
template <typename OnMatch = NoWitness>
__device__ __forceinline__ int merge_count(const int* a, long long sa, int wa,
                                           const int* b, long long sb, int wb,
                                           OnMatch on_match = OnMatch()) {
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
      on_match(x);
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

// Gather mode over two row tables: u's row from nbr_a, v's from nbr_b (the
// same table for K1's gather entry).
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

__global__ void vertex_kernel(const int* __restrict__ nbr, long long d_pad,
                              const int* __restrict__ edges,
                              const int* __restrict__ valid, int wa, int wb,
                              long long E, unsigned long long* out,
                              long long n_out) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int v = valid[e];
  if (v <= 0) return;
  const long long u = edges[2 * e], w = edges[2 * e + 1];
  const int cnt = merge_count(
      nbr + u * d_pad, 1, wa, nbr + w * d_pad, 1, wb, [&](int x) {
        if (x < n_out) atomicAdd(out + x, 1ull);
      });
  if (cnt == 0) return;
  const unsigned long long add = (unsigned long long)cnt * v;
  if (u >= 0 && u < n_out) atomicAdd(out + u, add);
  if (w >= 0 && w < n_out) atomicAdd(out + w, add);
}

constexpr int kThreads = 256;

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

extern "C" int tier_intersect_cross(const void* nbr_a, long long d_a,
                                    const void* nbr_b, long long d_b,
                                    const void* edges, const void* valid,
                                    int wa, int wb, long long E, void* out,
                                    void* stream) {
  if (E > 0) {
    const long long blocks = (E + kThreads - 1) / kThreads;
    gather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)nbr_a, d_a, (const int*)nbr_b, d_b, (const int*)edges,
        (const int*)valid, wa, wb, E, (unsigned long long*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int tier_intersect_gather(const void* nbr, long long d_pad,
                                     const void* edges, const void* valid,
                                     int wa, int wb, long long E, void* out,
                                     void* stream) {
  return tier_intersect_cross(nbr, d_pad, nbr, d_pad, edges, valid, wa, wb, E,
                              out, stream);
}

extern "C" int tier_intersect_vertex(const void* nbr, long long d_pad,
                                     const void* edges, const void* valid,
                                     int wa, int wb, long long E, void* out,
                                     long long n_out, void* stream) {
  if (E > 0) {
    const long long blocks = (E + kThreads - 1) / kThreads;
    vertex_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)nbr, d_pad, (const int*)edges, (const int*)valid, wa, wb,
        E, (unsigned long long*)out, n_out);
  }
  return (int)cudaGetLastError();
}
