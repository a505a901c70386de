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

// Blocks of `threads` threads and no dynamic shared memory that one SM of
// `device` holds at once, for `kernel`: asked once per kernel and device.
inline int resident_blocks(const void* kernel, int threads, int device, int* blocks) {
  static std::mutex mutex;
  static std::map<std::pair<const void*, int>, int> known;
  std::lock_guard<std::mutex> lock(mutex);
  const auto it = known.find({kernel, device});
  if (it != known.end()) {
    *blocks = it->second;
    return 0;
  }
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*blocks < 1) *blocks = 1;
  known[{kernel, device}] = *blocks;
  return 0;
}

}  // namespace vitad_launch
