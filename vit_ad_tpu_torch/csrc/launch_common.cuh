// Host-side launch helper shared by the port's kernel sources.

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace vitad_launch {

// Raise `kernel`'s dynamic shared-memory limit to `bytes` (above the 48 KB
// default) unless this process has already raised it that far on `device`:
// cudaFuncSetAttribute costs ~15 us of host time a call, as much as a short
// kernel's launch. Returns the CUDA error code (0 on success).
inline int raise_dynamic_smem(const void* kernel, size_t bytes, int device) {
  static std::mutex mutex;
  static std::map<std::pair<const void*, int>, size_t> raised;
  std::lock_guard<std::mutex> lock(mutex);
  size_t& have = raised[{kernel, device}];
  if (bytes > have) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    have = bytes;
  }
  return 0;
}

}  // namespace vitad_launch
