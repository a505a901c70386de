// Device and launch code of the one-pass LayerNorm (B7), shared by
// layer_norm.cu (the kernel's own entry point) and mlp_block.cu (the first of
// the fused MLP half-block's three steps). See layer_norm.cu for what the
// kernel computes, what bounds it and why it has this form.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vitad_layer_norm {

constexpr int kThreads = 128;  // four rows per block
constexpr int kMaxDim = 2048;

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

// x and out are contiguous [rows, d] device buffers of bf16 (is_bf16) or f32,
// scale and bias f32 [d], 1 <= d <= kMaxDim. Launches on `stream` and returns
// cudaGetLastError().
inline int run(const void* x, const float* scale, const float* bias, void* out, int rows, int d,
               float eps, bool is_bf16, cudaStream_t stream) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (is_bf16) {
    if (aligned && d % 8 == 0)
      return dispatch_vectors<uint16_t, 8>(x, scale, bias, out, rows, d, eps, stream);
    return dispatch_scalars<uint16_t>(x, scale, bias, out, rows, d, eps, stream);
  }
  if (aligned && d % 4 == 0)
    return dispatch_vectors<float, 4>(x, scale, bias, out, rows, d, eps, stream);
  return dispatch_scalars<float>(x, scale, bias, out, rows, d, eps, stream);
}

}  // namespace vitad_layer_norm
