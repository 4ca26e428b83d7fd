// K20 auc_count: one trial of the sampled AUC's comparison, from the 2T
// scores of the trial's pairs (true pairs first, then false, in pair order)
// and a shift s held in device memory:
//   higher = Σ_i [st[i] > sf[(i - s) mod T]],  equal = Σ_i [st[i] == sf[...]]
// (a NaN score counts in neither, as C++'s comparisons and gms_tpu's do), and
// the next trial's shift (higher mod T) + 1, written over s.
//
// Replaces the counting tail of AUCPlan.program and its lax.scan step
// (gms_tpu/algorithms/link_prediction.py:208-256): jnp.roll(sf, s)[i] is
// sf[(i - s) mod T]. gms_tpu's perm and bucket gathers have no counterpart,
// since the port's scores are already in pair order. Because the shift stays
// on the device, a run of trials is a loop of launches with one read-back at
// the end, as the lax.scan is.
//
// It is a reduction, which Triton would serve as well; it stays in CUDA so
// that the port keeps one build path (as K16 does).
//
// Design: a grid-stride loop, a block reduction and one integer atomicAdd per
// block for each count into the trial's row (cleared first on the stream);
// then a one-thread launch writes the next shift, after every block of the
// first has read the old one.
//
// Bound on an H100: bytes, the 2T scores read once (8T bytes).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void count_kernel(const float* __restrict__ scores, long long T,
                             const int* __restrict__ shift, int* counts) {
  __shared__ int sums[2][kThreads / 32];
  const long long s = *shift;
  int higher = 0, equal = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < T;
       i += (long long)gridDim.x * blockDim.x) {
    long long j = (i - s) % T;
    if (j < 0) j += T;
    const float a = scores[i], b = scores[T + j];
    higher += a > b;
    equal += a == b;
  }
  for (int o = 16; o > 0; o >>= 1) {
    higher += __shfl_down_sync(0xffffffffu, higher, o);
    equal += __shfl_down_sync(0xffffffffu, equal, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sums[0][warp] = higher;
    sums[1][warp] = equal;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      higher += sums[0][w];
      equal += sums[1][w];
    }
    if (higher) atomicAdd(counts, higher);
    if (equal) atomicAdd(counts + 1, equal);
  }
}

__global__ void next_shift_kernel(const int* counts, long long T, int* shift) {
  *shift = (int)(counts[0] % T) + 1;
}

}  // namespace

extern "C" int auc_count(const void* scores, long long T, void* shift,
                         void* counts, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (T > 0) {
    long long blocks = (T + kThreads - 1) / kThreads;
    if (blocks > 132 * 8) blocks = 132 * 8;
    count_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)scores, T, (const int*)shift, (int*)counts);
    next_shift_kernel<<<1, 1, 0, s>>>((const int*)counts, T, (int*)shift);
  }
  return (int)cudaGetLastError();
}
