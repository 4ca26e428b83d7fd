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
