// Compiled into every kernel library (nvcc -include, _kernels.NVCC_FLAGS).
//
// Each library links its own static CUDA runtime, whose current device is
// device 0 until the library sets another. _kernels.launch calls this entry
// with the device of the launch's tensors before each C entry, so kernels,
// cudaGetDevice and cudaMallocAsync in the entry see that device.
#pragma once

#include <cuda_runtime.h>

extern "C" int gms_set_device(int device) {
  return (int)cudaSetDevice(device);
}

// An empty kernel on `stream`. bench/profiling.py opens each torch.profiler
// window with it from every library loaded so far: late in chip_smoke.py
// the profiler lost the first kernel that this package launched in a
// window (phase 20's first K11 launch), though no torch kernel before it.
__global__ void gms_window_open_kernel() {}

extern "C" int gms_window_open(void* stream) {
  gms_window_open_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
