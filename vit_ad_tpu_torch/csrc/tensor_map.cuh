// Host side of the Tensor Memory Accelerator (TMA) for the port's warpgroup
// kernels: the tensor maps that hopper_mma.cuh's tma_load_2d / tma_load_3d /
// tma_store_2d read. Included by mlp_block.cu (B6) and gmm.cu (B2).
//
// Every map here is of a bf16 tensor moved in boxes whose innermost extent is
// 64 elements (128 bytes), 128-byte swizzled: the layout the wgmma operand
// descriptors of hopper_mma.cuh describe. A load brings zeros from outside
// the tensor, a store writes nothing there.

#pragma once

#include <cuda.h>
#include <dlfcn.h>

namespace vitad_tma {

// Errors of the tensor-map set-up, told apart from CUDA runtime error codes.
constexpr int kErrNoEncodeSymbol = 2001;
constexpr int kErrEncodeBase = 3000;  // + the CUresult of the call
constexpr int kBoxInner = 64;         // elements: 128 bytes, the swizzle span

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which the kernel library does not
// link: take it from the libcuda the process has loaded.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* libcuda = dlopen("libcuda.so.1", RTLD_LAZY);
    return libcuda == nullptr
               ? nullptr
               : reinterpret_cast<EncodeTiled>(dlsym(libcuda, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// Tensor map of a bf16 tensor of `rank` dimensions, innermost first: dims[0]
// elements are contiguous, strides[i] is the byte stride of dimension i + 1
// (a multiple of 16). Boxes of box[0..rank) elements, box[0] = kBoxInner.
// Returns 0, kErrNoEncodeSymbol or kErrEncodeBase + the CUresult.
inline int encode_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncodeSymbol;
  const cuuint32_t element_strides[3] = {1, 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
             const_cast<void*>(base), dims, strides, box, element_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncodeBase + static_cast<int>(res);
}

// A contiguous bf16 matrix [rows, cols] moved in boxes of [box_rows, 64].
inline int encode_matrix(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kBoxInner, static_cast<cuuint32_t>(box_rows)};
  return encode_bf16(map, base, 2, dims, strides, box);
}

}  // namespace vitad_tma
