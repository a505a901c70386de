// (Shifted-)window multi-head self-attention of the Swin blocks for Hopper
// (sm_90a).
//
// Replaces two TPU kernels of vit_ad_tpu/ops/pallas/window_attention.py:
// _kernel_win (pallas_call in _call_win, public entry swin_attention_windows),
// which reads packed qkv windows [B_, N, 3C], channel order [3][H][hd], and
// _kernel (pallas_call in _call, public entries window_attention_core_pallas
// and window_attention), which reads split q, k, v [B_, N, C]. For every window
// b and head h:
//
//   out[b, :, h*hd:(h+1)*hd] =
//       softmax((q * hd^-1/2) k^T + bias[h] + mask[b % n_w]) v
//
// bias [H, N, N] f32 is the relative-position table gathered by the caller;
// mask [n_w, N, N] f32 (0 / -100, added, not -inf) is the shift mask, absent
// for unshifted blocks; windows are the minor axis of the partition, so window
// b takes mask row b % n_w. One entry point serves both layouts: it takes three
// base pointers and a row stride (packed: qkv, qkv + C, qkv + 2C, stride 3C;
// split: q, k, v, stride C), and no split copy is ever made.
//
// Numerics follow each TPU kernel (attention_common.cuh): q*scale rounded to
// the input dtype, f32 scores, bias, mask and softmax. The packed kernel
// rounds the UNNORMALISED exponentials before PV and multiplies the f32 PV by
// the reciprocal row sum (defer_norm = 1); the split kernel rounds the
// normalised probabilities (defer_norm = 0). Under f32 both agree to
// summation order.
//
// What bounds it on the H100: at the EsViT Swin-T stage-0 shape (B=128 at
// 224 px: 2048 windows, N=196, C=96, H=3, hd=32, bf16) one call reads 231 MB
// of qkv and writes 77 MB: 92 us at 3.35 TB/s, against 30.2 GFLOP
// (4*B_*H*N^2*hd), 31 us at the 989 TFLOP/s bf16 tensor-core rate; stages 1-3
// halve the bytes each (46, 23, 11.5 us). By that count the kernel is memory
// bound, so the bf16 path stages a head's K and V once per (window, head)
// block with 16-byte loads (head slices are 64 bytes of a 3C-wide row), keeps
// scores and probabilities on chip, and runs both products on mma.sync. The
// f32 bias and mask rows (154 KB per head and per mask row at N=196) are read
// from L2 in both softmax passes. Measured on an H100 (700 W) it takes 1.31 ms
// at stage 0 and its time follows the number of (window, head) blocks whether
// or not there is a mask: what holds it is the instruction stream around the
// MMAs (the scalar bias and mask loads, the score arithmetic of two passes),
// not L2 bandwidth. A variant that kept bias + mask in shared memory for a run
// of windows, at one block per SM, gained 15% at stage 0 and lost 35% at
// stage 2, and was not kept. A one-pass softmax with the scores in registers,
// ldmatrix, wgmma and TMA are later work.
//
// The f32 path (the f32 numerics policy and the tests) is plain FMA.

#include "attention_common.cuh"

namespace {

using namespace vitad_attention;

// One block per (window, head); each warp walks the window's 16-row query
// tiles (13 at N=196, 4 at N=49: the launch gives a block only as many warps
// as there are tiles, at most eight).
template <int HD, bool kDefer>
__global__ void __launch_bounds__(kThreads, 2)
window_attention_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                             const uint16_t* __restrict__ v, uint16_t* __restrict__ out,
                             const float* __restrict__ bias, const float* __restrict__ mask,
                             int n, int heads, int row_stride_i, int n_w, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = padded_keys(n);
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* vs = ks + np * (HD + 8);

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const size_t c = static_cast<size_t>(heads) * HD;
  const size_t row_stride = static_cast<size_t>(row_stride_i);
  const size_t slice = static_cast<size_t>(b) * n * row_stride + h * HD;

  stage_kv<HD>(ks, vs, k + slice, v + slice, row_stride, n, np);
  __syncthreads();

  const float* bias_h = bias + static_cast<size_t>(h) * n * n;
  const float* mask_w =
      mask == nullptr ? nullptr : mask + static_cast<size_t>(b % n_w) * n * n;
  uint16_t* out_h = out + static_cast<size_t>(b) * n * c + h * HD;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_step = (blockDim.x / 32) * kRowsPerWarp;
  for (int row0 = warp * kRowsPerWarp; row0 < n; row0 += row_step) {  // no barrier inside
    const int ra = row0 + g;
    const int rb = row0 + g + 8;
    uint32_t qa[HD / 16][4];
    load_q_fragments<HD>(qa, q + slice, row_stride, ra, rb, n, t, scale);
    // rows past n read the last row's bias and mask; their output is dropped
    const size_t off_a = static_cast<size_t>(min(ra, n - 1)) * n;
    const size_t off_b = static_cast<size_t>(min(rb, n - 1)) * n;
    float o[HD / 8][4];
    attend_tile<HD, kDefer, true>(o, qa, ks, vs, n, np, bias_h + off_a, bias_h + off_b,
                                  mask_w == nullptr ? nullptr : mask_w + off_a,
                                  mask_w == nullptr ? nullptr : mask_w + off_b, g, t);
    store_tile<HD>(out_h, c, ra, rb, n, t, o);
  }
}

// One block per (window, head), one query row per thread and pass.
template <int HD, bool kDefer>
__global__ void __launch_bounds__(kF32Threads)
window_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ out,
                            const float* __restrict__ bias, const float* __restrict__ mask,
                            int n, int heads, int row_stride_i, int n_w, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + n * HD;

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const size_t c = static_cast<size_t>(heads) * HD;
  const size_t row_stride = static_cast<size_t>(row_stride_i);
  const size_t slice = static_cast<size_t>(b) * n * row_stride + h * HD;

  stage_kv_f32<HD>(ks, vs, k + slice, v + slice, row_stride, n);
  __syncthreads();

  const float* bias_h = bias + static_cast<size_t>(h) * n * n;
  const float* mask_w =
      mask == nullptr ? nullptr : mask + static_cast<size_t>(b % n_w) * n * n;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {  // no barrier inside
    float qr[HD];
    const float* qrow = q + slice + r * row_stride;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = qrow[d] * scale;
    float o[HD];
    attend_row_f32<HD, kDefer, true>(o, qr, ks, vs, n, bias_h + static_cast<size_t>(r) * n,
                                     mask_w == nullptr ? nullptr
                                                       : mask_w + static_cast<size_t>(r) * n);
    float* orow = out + (static_cast<size_t>(b) * n + r) * c + h * HD;
#pragma unroll
    for (int d = 0; d < HD; d += 4)
      *reinterpret_cast<float4*>(orow + d) = make_float4(o[d], o[d + 1], o[d + 2], o[d + 3]);
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  const float *bias, *mask;
  int batch, n, heads, row_stride, n_w;
  float scale;
  cudaStream_t stream;
};

// Raise the kernel's dynamic shared-memory limit to what this launch needs
// (above the 48 KB default), launch on the stream, report the launch status.
template <typename T, typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const Args& a) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.batch, a.heads);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), a.bias, a.mask, a.n, a.heads, a.row_stride, a.n_w, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool kDefer>
int launch_bf16(const Args& a) {
  const int tiles = (a.n + kRowsPerWarp - 1) / kRowsPerWarp;
  const int warps = tiles < kWarps ? tiles : kWarps;
  return launch<uint16_t>(window_attention_bf16_kernel<HD, kDefer>, warps * 32,
                          bf16_smem_bytes(a.n, HD), a);
}

template <int HD, bool kDefer>
int launch_f32(const Args& a) {
  const int rows = (a.n + 31) / 32 * 32;
  const int threads = rows < kF32Threads ? rows : kF32Threads;
  return launch<float>(window_attention_f32_kernel<HD, kDefer>, threads,
                       f32_smem_bytes(a.n, HD), a);
}

}  // namespace

// Plain C entry point, bound with ctypes. q, k, v point at [batch, n, ...]
// device buffers whose rows are `row_stride` elements apart and whose windows
// are n rows apart (packed qkv: q, q + C, q + 2C with row_stride 3C; split: three
// contiguous [batch, n, C] buffers with row_stride C); out [batch, n, C] is
// contiguous; all are 16-byte aligned, bf16 (is_bf16 != 0) or f32. bias
// [heads, n, n] and mask [n_w, n, n] (or null) are contiguous f32. `scale` is
// hd^-1/2 already rounded to the input dtype; defer_norm selects which
// probabilities are rounded (see the header of this file). Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
extern "C" int swin_window_attention_forward(const void* q, const void* k, const void* v,
                                             void* out, const void* bias, const void* mask,
                                             int batch, int n, int heads, int head_dim,
                                             int row_stride, int n_w, int defer_norm,
                                             int is_bf16, float scale, int device,
                                             void* stream) {
  if (batch < 1 || n < 1 || n > kMaxTokens || heads < 1 || heads > 65535 ||
      (head_dim != 32 && head_dim != 64) || row_stride < heads * head_dim || row_stride % 8 ||
      bias == nullptr || (mask != nullptr && n_w < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, k, v, out, static_cast<const float*>(bias), static_cast<const float*>(mask),
               batch, n, heads, row_stride, mask == nullptr ? 1 : n_w, scale,
               static_cast<cudaStream_t>(stream)};
  if (is_bf16) {
    if (head_dim == 64) return defer_norm ? launch_bf16<64, true>(a) : launch_bf16<64, false>(a);
    return defer_norm ? launch_bf16<32, true>(a) : launch_bf16<32, false>(a);
  }
  if (head_dim == 64) return defer_norm ? launch_f32<64, true>(a) : launch_f32<64, false>(a);
  return defer_norm ? launch_f32<32, true>(a) : launch_f32<32, false>(a);
}
