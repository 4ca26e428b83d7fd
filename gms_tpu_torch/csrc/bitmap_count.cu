// K15 bitmap_edge_count and K16 bitmap_rows_count: popcounts of word
// combinations of bitmap rows.
//
// K15 replaces count_hub_edges (gms_tpu/algorithms/triangle_count.py:184),
// whose caller here is the dense-bitmap triangle count: Σ over edges e with
// valid[e] != 0 of valid[e] * popcount(rows[ra] & rows[rb]) over the first
// `width` words, where (ra, rb) are the edge's ends, or row_of of them when
// row_of is given. Indices clip into range, as gms_tpu's `mode="clip"`
// takes do.
// K16 replaces the counts of gms_tpu/sets/bitmap_ops.py (:22-49): int32[B] =
// popcount(a op b) per row, op in {a, a & b, a | b, a & ~b} (cardinality,
// intersect_count, union_count, difference_count). It is a fused elementwise
// pass plus a reduction, which Triton would serve as well; it stays in CUDA so
// that the port keeps one build path, and shares K15's word loop.
// Bit words arrive as int32 tensors holding gms_tpu's uint32 bits and are read
// here as unsigned.
//
// Design: a warp per edge (K15) or per row (K16); its lanes walk the words
// with neighbouring lanes on neighbouring words, 16-byte loads where the
// width and the rows' alignment allow. K15 sums int64 per block and adds it
// with one 64-bit atomicAdd, as K2 does; K16 reduces each row in the warp.
//
// Bound on an H100: K15 does one AND+popcount per word per edge, at 16
// popcounts per clock per SM (4.18e12/s at 1,980 MHz); its bytes are each
// distinct row once, the edges and valid. At RMAT-16's dense rows (2,048
// words) the operations bound it. K16 does one word operation and one
// popcount per word of each row; its bytes (a, b, out) bound it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"

namespace {

template <int OP>
__device__ __forceinline__ unsigned combine(unsigned a, unsigned b) {
  if (OP == 0) return a;
  if (OP == 1) return a & b;
  if (OP == 2) return a | b;
  return a & ~b;
}

// This lane's share of Σ_w popcount(a[w] op b[w]), w < W.
template <int OP>
__device__ __forceinline__ int lane_popcount(const unsigned* a,
                                             const unsigned* b, int W,
                                             bool vec) {
  const int lane = threadIdx.x & 31;
  int acc = 0;
  if (vec) {
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    for (int i = lane; i < W / 4; i += 32) {
      const uint4 x = a4[i], y = b4[i];
      acc += __popc(combine<OP>(x.x, y.x)) + __popc(combine<OP>(x.y, y.y)) +
             __popc(combine<OP>(x.z, y.z)) + __popc(combine<OP>(x.w, y.w));
    }
  } else {
    for (int i = lane; i < W; i += 32) acc += __popc(combine<OP>(a[i], b[i]));
  }
  return acc;
}

__device__ __forceinline__ long long clip(long long i, long long n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void edge_kernel(const unsigned* __restrict__ rows, long long n_rows,
                            long long hw, const int* __restrict__ row_of,
                            long long n_row_of, const int* __restrict__ edges,
                            const int* __restrict__ valid, long long E,
                            int width, bool vec, unsigned long long* out) {
  const long long e = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  long long cnt = 0;
  if (e < E) {
    const int v = valid[e];
    if (v != 0) {
      long long ra = edges[2 * e], rb = edges[2 * e + 1];
      if (row_of) {
        ra = row_of[clip(ra, n_row_of)];
        rb = row_of[clip(rb, n_row_of)];
      }
      ra = clip(ra, n_rows);
      rb = clip(rb, n_rows);
      cnt = (long long)lane_popcount<1>(rows + ra * hw, rows + rb * hw, width,
                                        vec) * v;
    }
  }
  block_sum_add(cnt, out);
}

template <int OP>
__global__ void rows_kernel(const unsigned* __restrict__ a,
                            const unsigned* __restrict__ b, long long B, int W,
                            bool vec, int* __restrict__ out) {
  const long long r = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (r >= B) return;  // the whole warp
  int c = lane_popcount<OP>(a + r * W, b + r * W, W, vec);
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) out[r] = c;
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" int bitmap_edge_count(const void* rows, long long n_rows,
                                 long long hw, const void* row_of,
                                 long long n_row_of, const void* edges,
                                 const void* valid, long long E, int width,
                                 void* out, void* stream) {
  if (E > 0 && n_rows > 0 && width > 0) {
    const bool vec = hw % 4 == 0 && width % 4 == 0 && aligned16(rows);
    const long long blocks = (E + kWarps - 1) / kWarps;
    edge_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)rows, n_rows, hw, (const int*)row_of, n_row_of,
        (const int*)edges, (const int*)valid, E, width, vec,
        (unsigned long long*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int bitmap_rows_count(const void* a, const void* b, long long B,
                                 int W, int op, void* out, void* stream) {
  if (B > 0 && W > 0) {
    const bool vec = W % 4 == 0 && aligned16(a) && aligned16(b);
    const unsigned blocks = (unsigned)((B + kWarps - 1) / kWarps);
    const cudaStream_t s = (cudaStream_t)stream;
    const unsigned* ua = (const unsigned*)a;
    const unsigned* ub = (const unsigned*)b;
    switch (op) {
      case 0: rows_kernel<0><<<blocks, kThreads, 0, s>>>(ua, ub, B, W, vec, (int*)out); break;
      case 1: rows_kernel<1><<<blocks, kThreads, 0, s>>>(ua, ub, B, W, vec, (int*)out); break;
      case 2: rows_kernel<2><<<blocks, kThreads, 0, s>>>(ua, ub, B, W, vec, (int*)out); break;
      case 3: rows_kernel<3><<<blocks, kThreads, 0, s>>>(ua, ub, B, W, vec, (int*)out); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
