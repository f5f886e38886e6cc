// What every kernel library of the port shares with the host side: the text
// of a CUDA error (tt_cuda_error_string, the one entry all libraries export;
// kernels/cuda_build.py declares it for each) and the device's limits that
// launch geometry is planned from.
//
// The limits are asked once per device index and kept: an SM count or a
// shared memory size does not change while a process runs, and asking costs
// host time on every launch that plans from it.  Each helper writes *out only
// on success and returns the runtime's error otherwise.
#pragma once

#include <cuda_runtime.h>

namespace tt_runtime {

template <cudaDeviceAttr ATTR>
cudaError_t device_attribute(int* out) {
  constexpr int MAX_DEVICES = 64;
  static int held[MAX_DEVICES] = {};  // value + 1; 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool keep = dev >= 0 && dev < MAX_DEVICES;
  if (keep && held[dev] > 0) {
    *out = held[dev] - 1;
    return cudaSuccess;
  }
  int value = 0;
  err = cudaDeviceGetAttribute(&value, ATTR, dev);
  if (err != cudaSuccess) return err;
  if (keep) held[dev] = value + 1;
  *out = value;
  return cudaSuccess;
}

// SMs of the current device.
inline cudaError_t sm_count(int* out) {
  return device_attribute<cudaDevAttrMultiProcessorCount>(out);
}

// Shared memory of one SM of the current device, in bytes.
inline cudaError_t smem_per_sm(int* out) {
  return device_attribute<cudaDevAttrMaxSharedMemoryPerMultiprocessor>(out);
}

// Shared memory the runtime reserves of each block, in bytes.
inline cudaError_t reserved_smem_per_block(int* out) {
  return device_attribute<cudaDevAttrReservedSharedMemoryPerBlock>(out);
}

}  // namespace tt_runtime

extern "C" const char* tt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
