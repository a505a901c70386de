// Device and launch code of the one-pass LayerNorm (B7), shared by
// layer_norm.cu (the kernel's own entry point) and mlp_block.cu (the first of
// the fused MLP half-block's three steps). See layer_norm.cu for what the
// kernel computes, what bounds it and why it has this form.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_common.cuh"

namespace vitad_layer_norm {

constexpr int kThreads = 128;  // four warps per block
constexpr int kMaxDim = 2048;
// The rows kernel's grid from this width up: at most as many blocks as the
// card holds at once, the warps striding over the rows (below it, one warp
// per group of rows: 7% faster at D = 96, level at 192; the stride is 8% and
// 25% faster at [25344, 768] and [25088, 384] on an NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).
constexpr int kStrideMinDim = 384;

template <typename T, int VEC>
struct Vector;

template <>
struct Vector<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&y)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  }
};

template <>
struct Vector<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&x)[1]) { x[0] = *p; }
  static __device__ __forceinline__ void store(float* p, const float (&y)[1]) { *p = y[0]; }
};

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);  // bf16 is the upper half of an f32
}

__device__ __forceinline__ uint32_t float_to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <>
struct Vector<uint16_t, 8> {
  static __device__ __forceinline__ void load(const uint16_t* p, float (&x)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = bf16_bits_to_float(w[i] & 0xffffu);
      x[2 * i + 1] = bf16_bits_to_float(w[i] >> 16);
    }
  }
  static __device__ __forceinline__ void store(uint16_t* p, const float (&y)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = float_to_bf16_bits(y[2 * i]) | (float_to_bf16_bits(y[2 * i + 1]) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vector<uint16_t, 1> {
  static __device__ __forceinline__ void load(const uint16_t* p, float (&x)[1]) {
    x[0] = bf16_bits_to_float(*p);
  }
  static __device__ __forceinline__ void store(uint16_t* p, const float (&y)[1]) {
    *p = static_cast<uint16_t>(float_to_bf16_bits(y[0]));
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// One warp per row; lane l holds vectors l + 32 i (i < NV) of VEC elements.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ out, int rows, int d,
                  float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave; no barrier follows
  const int nvec = d / VEC;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* outr = out + static_cast<size_t>(row) * d;

  float v[NV][VEC];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = lane + 32 * i;
    if (idx < nvec) {
      Vector<T, VEC>::load(xr + idx * VEC, v[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) sum += v[i][j];
    }
  }
  const float mean = warp_sum(sum) / static_cast<float>(d);

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float c = v[i][j] - mean;
        sq += c * c;
      }
    }
  }
  const float rstd = 1.f / sqrtf(warp_sum(sq) / static_cast<float>(d) + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = lane + 32 * i;
    if (idx < nvec) {
      float y[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int col = idx * VEC + j;
        y[j] = ((v[i][j] - mean) * rstd) * scale[col] + bias[col];
      }
      Vector<T, VEC>::store(outr + idx * VEC, y);
    }
  }
}

// bf16 rows of D = 8 LPR NV: LPR lanes per row, NV 16-byte vectors per lane
// (lane li of a row holds columns 8 (li + LPR i) .. + 8, i < NV), 32 / LPR
// rows per warp at a time, every lane busy. The lane's scale and bias are
// loaded once as float4s. Warps walk the groups of 32 / LPR rows with a
// stride of the grid's warp count, and the next group's loads are issued
// before this group's two reductions, so a warp keeps two groups of bytes in
// flight.
template <int LPR, int NV>
__global__ void __launch_bounds__(kThreads)
layer_norm_rows_kernel(const uint16_t* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, uint16_t* __restrict__ out, int rows,
                       float eps) {
  constexpr int kD = 8 * LPR * NV;
  constexpr int kRowsPerWarp = 32 / LPR;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPR;  // the warp's row this lane works on
  const int li = lane % LPR;
  float sc[NV][8], bi[NV][8];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = 8 * (li + LPR * i);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(scale + col) + h);
      const float4 b = __ldg(reinterpret_cast<const float4*>(bias + col) + h);
      sc[i][4 * h] = a.x; sc[i][4 * h + 1] = a.y; sc[i][4 * h + 2] = a.z; sc[i][4 * h + 3] = a.w;
      bi[i][4 * h] = b.x; bi[i][4 * h + 1] = b.y; bi[i][4 * h + 2] = b.z; bi[i][4 * h + 3] = b.w;
    }
  }
  const int groups = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  const int stride = gridDim.x * (kThreads / 32);
  int group = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  uint4 raw[NV];
  auto load = [&](int grp) {
    const int row = grp * kRowsPerWarp + sub;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      raw[i] = row < rows ? *reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * kD +
                                                             8 * (li + LPR * i))
                          : make_uint4(0, 0, 0, 0);
  };
  if (group < groups) load(group);
  for (; group < groups; group += stride) {  // the same for the whole warp
    const int row = group * kRowsPerWarp + sub;
    float v[NV][8];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const uint32_t w[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[i][2 * q] = bf16_bits_to_float(w[q] & 0xffffu);
        v[i][2 * q + 1] = bf16_bits_to_float(w[q] >> 16);
        sum += v[i][2 * q] + v[i][2 * q + 1];
      }
    }
    if (group + stride < groups) load(group + stride);
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / static_cast<float>(kD);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float c = v[i][j] - mean;
        sq += c * c;
      }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = 1.f / sqrtf(sq / static_cast<float>(kD) + eps);
    if (row < rows) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float y[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) y[j] = ((v[i][j] - mean) * rstd) * sc[i][j] + bi[i][j];
        Vector<uint16_t, 8>::store(out + static_cast<size_t>(row) * kD + 8 * (li + LPR * i), y);
      }
    }
  }
}

template <int LPR, int NV>
int launch_rows(const void* x, const float* scale, const float* bias, void* out, int rows,
                float eps, cudaStream_t stream) {
  const auto kernel = layer_norm_rows_kernel<LPR, NV>;
  const long long groups = (rows + 32 / LPR - 1) / (32 / LPR);
  long long blocks = (groups + kThreads / 32 - 1) / (kThreads / 32);
  if (8 * LPR * NV >= kStrideMinDim) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    int resident = 0;
    const int rc = vitad_launch::resident_blocks(reinterpret_cast<const void*>(kernel), kThreads,
                                                 device, &resident);
    if (rc != 0) return rc;
    blocks = blocks < static_cast<long long>(resident) * sms ? blocks
                                                              : static_cast<long long>(resident) * sms;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint16_t*>(x), scale, bias, static_cast<uint16_t*>(out), rows, eps);
  return static_cast<int>(cudaGetLastError());
}

// The rows kernel at D = 8 LPR NV with LPR in {4, 8, 16, 32} and NV in
// {1, 2, 3, 4, 6, 8}, the fewest vectors per lane first; -1 when D has no
// such form.
inline int dispatch_rows(const void* x, const float* scale, const float* bias, void* out,
                         int rows, int d, float eps, cudaStream_t stream) {
  const int nvec = d / 8;
#define VITAD_LN_ROWS(NV)                                                                      \
  if (nvec % NV == 0) {                                                                        \
    switch (nvec / NV) {                                                                       \
      case 4: return launch_rows<4, NV>(x, scale, bias, out, rows, eps, stream);              \
      case 8: return launch_rows<8, NV>(x, scale, bias, out, rows, eps, stream);              \
      case 16: return launch_rows<16, NV>(x, scale, bias, out, rows, eps, stream);            \
      case 32: return launch_rows<32, NV>(x, scale, bias, out, rows, eps, stream);            \
      default: break;                                                                          \
    }                                                                                          \
  }
  VITAD_LN_ROWS(1)
  VITAD_LN_ROWS(2)
  VITAD_LN_ROWS(3)
  VITAD_LN_ROWS(4)
  VITAD_LN_ROWS(6)
  VITAD_LN_ROWS(8)
#undef VITAD_LN_ROWS
  return -1;
}

template <typename T, int VEC, int NV>
int launch(const void* x, const float* scale, const float* bias, void* out, int rows, int d,
           float eps, cudaStream_t stream) {
  const int rows_per_block = kThreads / 32;
  const unsigned blocks = (static_cast<unsigned>(rows) + rows_per_block - 1) / rows_per_block;
  layer_norm_kernel<T, VEC, NV><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(out), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// The smallest instantiation whose 32 * NV vectors cover the row.
template <typename T, int VEC>
int dispatch_vectors(const void* x, const float* scale, const float* bias, void* out, int rows,
                     int d, float eps, cudaStream_t stream) {
  const int per_lane = (d / VEC + 31) / 32;
  if (per_lane <= 1) return launch<T, VEC, 1>(x, scale, bias, out, rows, d, eps, stream);
  if (per_lane <= 2) return launch<T, VEC, 2>(x, scale, bias, out, rows, d, eps, stream);
  if (per_lane <= 4) return launch<T, VEC, 4>(x, scale, bias, out, rows, d, eps, stream);
  if (per_lane <= 8) return launch<T, VEC, 8>(x, scale, bias, out, rows, d, eps, stream);
  if constexpr (kMaxDim / VEC / 32 > 8) {  // f32 vectors hold 4 elements: up to 16 per lane
    return launch<T, VEC, 16>(x, scale, bias, out, rows, d, eps, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_scalars(const void* x, const float* scale, const float* bias, void* out, int rows,
                     int d, float eps, cudaStream_t stream) {
  const int per_lane = (d + 31) / 32;
  if (per_lane <= 4) return launch<T, 1, 4>(x, scale, bias, out, rows, d, eps, stream);
  if (per_lane <= 16) return launch<T, 1, 16>(x, scale, bias, out, rows, d, eps, stream);
  return launch<T, 1, 64>(x, scale, bias, out, rows, d, eps, stream);
}

// What run() reports as the kernel it launched.
constexpr int kRouteRows = 1, kRouteWarpPerRow = 2;

// x and out are contiguous [rows, d] device buffers of bf16 (is_bf16) or f32,
// scale and bias f32 [d], 1 <= d <= kMaxDim. Launches on `stream` and returns
// cudaGetLastError(); writes the kernel it launched to `route` if given.
inline int run(const void* x, const float* scale, const float* bias, void* out, int rows, int d,
               float eps, bool is_bf16, cudaStream_t stream, int* route = nullptr) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  // the rows kernel also reads scale and bias as float4s
  const bool params_aligned =
      (reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(bias)) % 16 == 0;
  if (route != nullptr) *route = kRouteWarpPerRow;
  if (is_bf16) {
    if (aligned && params_aligned && d % 8 == 0) {
      const int rc = dispatch_rows(x, scale, bias, out, rows, d, eps, stream);
      if (rc >= 0) {
        if (route != nullptr) *route = kRouteRows;
        return rc;
      }
      return dispatch_vectors<uint16_t, 8>(x, scale, bias, out, rows, d, eps, stream);
    }
    return dispatch_scalars<uint16_t>(x, scale, bias, out, rows, d, eps, stream);
  }
  if (aligned && d % 4 == 0)
    return dispatch_vectors<float, 4>(x, scale, bias, out, rows, d, eps, stream);
  return dispatch_scalars<float>(x, scale, bias, out, rows, d, eps, stream);
}

}  // namespace vitad_layer_norm
