// Packed-qkv multi-head self-attention for Hopper (sm_90a).
//
// Replaces the TPU kernel vit_ad_tpu/ops/pallas/window_attention.py::_kernel_qkv
// (pallas_call in _call_qkv, public entry vit_attention_qkv). For every image b
// and head h:
//
//   out[b, :, h*hd:(h+1)*hd] = softmax((q * hd^-1/2) k^T) v
//
// with q, k, v read in place from packed qkv [B, N, 3C], channel order
// [3][H][hd] (q at column h*hd, k at C + h*hd, v at 2C + h*hd): no split copies.
//
// Numerics follow the TPU kernel: q*scale is rounded to the input dtype, scores
// accumulate in f32, the softmax (max subtracted) runs in f32, the NORMALISED
// probabilities are rounded to the input dtype before PV, PV accumulates in f32
// and the output is stored in the input dtype. To keep that order the softmax
// is two-pass: pass 1 computes the row max and sum over key chunks (online
// rescale), pass 2 recomputes the scores, normalises them (times the
// reciprocal of the row sum) and accumulates PV. exp(x) is taken as
// exp2(x * log2 e), one multiply-add and one MUFU.EX2.
// This is not flash attention's deferred normalisation, which would round
// unnormalised probabilities.
//
// What bounds it on the H100: at the flagship shape (B=128, N=198, C=768,
// H=12, hd=64, bf16) one call reads 116.8 MB of qkv and writes 38.9 MB, 46 us
// at 3.35 TB/s, against 15.4 GFLOP (4*B*H*N^2*hd), 16 us at the 989 TFLOP/s
// bf16 tensor-core rate but 230 us at the 67 TFLOP/s of the CUDA cores. With
// tensor cores the kernel is memory bound, so the bf16 path issues mma.sync
// (m16n8k16, f32 accumulate), reads each head's K and V once per 128-query
// tile into shared memory (the second tile of a head hits L2) and
// never writes scores or probabilities to device memory. The second QK^T
// product of the two-pass softmax costs 50% more tensor-core work, which the
// memory bound leaves room for. wgmma and TMA are later work.
//
// The f32 path (the f32 numerics policy, off the flagship path) is plain FMA:
// the tensor cores have no f32 product that keeps full f32 precision.
//
// The device code (K/V staging, fragments, the two-pass softmax) lives in
// attention_common.cuh, shared with swin_window_attention.cu.

#include "attention_common.cuh"

namespace {

using namespace vitad_attention;

// One block per (image, query tile of 128 rows) x head; eight warps of 16 rows.
// Two blocks per SM (74 KB of shared memory each at N=256, <= 128 registers).
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
attention_bf16_kernel(const uint16_t* __restrict__ qkv, uint16_t* __restrict__ out,
                      int n, int heads, int q_tiles, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = padded_keys(n);
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* vs = ks + np * (HD + 8);

  const int b = blockIdx.x / q_tiles;
  const int qt = blockIdx.x % q_tiles;
  const int h = blockIdx.y;
  const int c = heads * HD;
  const size_t row_stride = 3 * static_cast<size_t>(c);
  const uint16_t* base = qkv + static_cast<size_t>(b) * n * row_stride + h * HD;

  stage_kv<HD>(ks, vs, base + c, base + 2 * c, row_stride, n, np);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = qt * kQTile + warp * kRowsPerWarp;
  if (row0 >= n) return;  // no barrier follows
  const int ra = row0 + g;
  const int rb = row0 + g + 8;

  uint32_t qa[HD / 16][4];
  load_q_fragments<HD>(qa, base, row_stride, ra, rb, n, t, scale);
  float o[HD / 8][4];
  attend_tile<HD, false, false>(o, qa, ks, vs, n, np, nullptr, nullptr, nullptr, nullptr, g, t);
  store_tile<HD>(out + static_cast<size_t>(b) * n * c + h * HD, c, ra, rb, n, t, o);
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
attention_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int n,
                     int heads, int q_tiles, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + n * HD;

  const int b = blockIdx.x / q_tiles;
  const int qt = blockIdx.x % q_tiles;
  const int h = blockIdx.y;
  const int c = heads * HD;
  const size_t row_stride = 3 * static_cast<size_t>(c);
  const float* base = qkv + static_cast<size_t>(b) * n * row_stride + h * HD;

  stage_kv_f32<HD>(ks, vs, base + c, base + 2 * c, row_stride, n);
  __syncthreads();

  const int r = qt * kF32Threads + threadIdx.x;
  if (r >= n) return;
  float q[HD];
  const float* qrow = base + r * row_stride;
#pragma unroll
  for (int d = 0; d < HD; ++d) q[d] = qrow[d] * scale;
  float o[HD];
  attend_row_f32<HD, false, false>(o, q, ks, vs, n, nullptr, nullptr);
  float* orow = out + (static_cast<size_t>(b) * n + r) * c + h * HD;
#pragma unroll
  for (int d = 0; d < HD; d += 4)
    *reinterpret_cast<float4*>(orow + d) = make_float4(o[d], o[d + 1], o[d + 2], o[d + 3]);
}

// Raise the kernel's dynamic shared-memory limit to what this launch needs
// (above the 48 KB default), launch on `stream`, report the launch status.
template <typename T>
int launch(void (*kernel)(const T*, T*, int, int, int, float), dim3 grid, int threads,
           size_t smem, cudaStream_t stream, const void* qkv, void* out, int n, int heads,
           int q_tiles, float scale) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out), n,
                                          heads, q_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. qkv [batch, n, 3*heads*head_dim] and
// out [batch, n, heads*head_dim] are contiguous, 16-byte aligned device
// buffers of bf16 (is_bf16 != 0) or f32. `scale` is hd^-1/2 already rounded to
// the input dtype. Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int vit_attention_qkv_forward(const void* qkv, void* out, int batch, int n,
                                         int heads, int head_dim, int is_bf16, float scale,
                                         int device, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxTokens || heads < 1 || heads > 65535 ||
      (head_dim != 32 && head_dim != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  if (is_bf16) {
    const int q_tiles = (n + kQTile - 1) / kQTile;
    const dim3 grid(batch * q_tiles, heads);
    const size_t smem = bf16_smem_bytes(n, head_dim);
    return launch<uint16_t>(head_dim == 64 ? attention_bf16_kernel<64> : attention_bf16_kernel<32>,
                            grid, kThreads, smem, st, qkv, out, n, heads, q_tiles, scale);
  }
  const int q_tiles = (n + kF32Threads - 1) / kF32Threads;
  const dim3 grid(batch * q_tiles, heads);
  const size_t smem = f32_smem_bytes(n, head_dim);
  return launch<float>(head_dim == 64 ? attention_f32_kernel<64> : attention_f32_kernel<32>, grid,
                       kF32Threads, smem, st, qkv, out, n, heads, q_tiles, scale);
}
