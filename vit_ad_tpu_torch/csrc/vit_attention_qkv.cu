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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxTokens = 256;

// ---- bf16: mma.sync tensor-core path ---------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;                 // one m16 tile per warp
constexpr int kQTile = kWarps * kRowsPerWarp;    // 128 query rows per block
constexpr int kKeyChunk = 64;                    // keys per softmax chunk
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat16 l = __float2bfloat16_rn(lo);
  const __nv_bfloat16 h = __float2bfloat16_rn(hi);
  return static_cast<uint32_t>(__bfloat16_as_ushort(l)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(h)) << 16);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// d += a * b for one m16n8k16 tile: a is 16x16 row-major, b is 16x8
// column-major, d is 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Scores of this warp's 16 query rows against keys [kc, kc + kKeyChunk).
// Accumulator layout of tile nt: s[nt][0..1] are row g, keys kc+nt*8+2t+{0,1};
// s[nt][2..3] are row g+8, the same keys. Keys past n are set to -inf.
template <int HD>
__device__ __forceinline__ void score_chunk(float (&s)[kKeyChunk / 8][4],
                                            const uint32_t (&qa)[HD / 16][4],
                                            const uint16_t* ks, int kc, int g,
                                            int t, int n) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int nt = 0; nt < kKeyChunk / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const uint16_t* krow = ks + (kc + nt * 8 + g) * LD + t * 2;
#pragma unroll
    for (int kstep = 0; kstep < HD / 16; ++kstep) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kstep * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kstep * 16 + 8);
      mma_bf16(s[nt], qa[kstep], b0, b1);
    }
    const int key = kc + nt * 8 + t * 2;
    if (key >= n) {
      s[nt][0] = -INFINITY;
      s[nt][2] = -INFINITY;
    }
    if (key + 1 >= n) {
      s[nt][1] = -INFINITY;
      s[nt][3] = -INFINITY;
    }
  }
}

// One block per (image, query tile of 128 rows) x head; eight warps of 16 rows.
// Two blocks per SM (74 KB of shared memory each at N=256, <= 128 registers).
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
attention_bf16_kernel(const uint16_t* __restrict__ qkv, uint16_t* __restrict__ out,
                      int n, int heads, int q_tiles, float scale) {
  // Row pitch HD+8: rows stay 16-byte aligned and the fragment loads below
  // touch 32 distinct banks.
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = (n + kKeyChunk - 1) / kKeyChunk * kKeyChunk;
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* vs = ks + np * LD;

  const int b = blockIdx.x / q_tiles;
  const int qt = blockIdx.x % q_tiles;
  const int h = blockIdx.y;
  const int c = heads * HD;
  const size_t row_stride = 3 * static_cast<size_t>(c);
  const uint16_t* base = qkv + static_cast<size_t>(b) * n * row_stride;

  // Stage this head's K and V rows, 16 bytes per load, zeros past n (a zero
  // V row keeps 0 * garbage from turning into NaN).
  constexpr int kVec = 8;
  constexpr int kChunksPerRow = HD / kVec;
  for (int i = threadIdx.x; i < np * kChunksPerRow; i += kThreads) {
    const int r = i / kChunksPerRow;
    const int col = (i % kChunksPerRow) * kVec;
    uint4 kv = make_uint4(0, 0, 0, 0);
    uint4 vv = make_uint4(0, 0, 0, 0);
    if (r < n) {
      const uint16_t* src = base + r * row_stride + h * HD + col;
      kv = *reinterpret_cast<const uint4*>(src + c);
      vv = *reinterpret_cast<const uint4*>(src + 2 * c);
    }
    *reinterpret_cast<uint4*>(ks + r * LD + col) = kv;
    *reinterpret_cast<uint4*>(vs + r * LD + col) = vv;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = qt * kQTile + warp * kRowsPerWarp;
  if (row0 >= n) return;  // no barrier follows
  const int ra = row0 + g;
  const int rb = row0 + g + 8;

  // A fragments of q*scale straight from device memory. Register j holds row
  // (j&1 ? g+8 : g), columns 2t+{0,1} (+8 when j&2). Rows past n are zero.
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kstep = 0; kstep < HD / 16; ++kstep) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (j & 1) ? rb : ra;
      const int col = kstep * 16 + t * 2 + ((j & 2) ? 8 : 0);
      float lo = 0.f, hi = 0.f;
      if (r < n) {
        const uint32_t v =
            *reinterpret_cast<const uint32_t*>(base + r * row_stride + h * HD + col);
        lo = __bfloat162float(__ushort_as_bfloat16(static_cast<uint16_t>(v & 0xffff))) * scale;
        hi = __bfloat162float(__ushort_as_bfloat16(static_cast<uint16_t>(v >> 16))) * scale;
      }
      qa[kstep][j] = pack_bf16(lo, hi);
    }
  }

  // Pass 1: row max and row sum of exp(s - max), f32.
  float s[kKeyChunk / 8][4];
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  for (int kc = 0; kc < np; kc += kKeyChunk) {
    score_chunk<HD>(s, qa, ks, kc, g, t, n);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kKeyChunk / 8; ++nt) {
      mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
    }
    // the four threads of a quad share a row
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    // chunk 0 holds key 0, so the new max is finite from the first chunk on
    const float new_a = fmaxf(m_a, mx_a);
    const float new_b = fmaxf(m_b, mx_b);
    l_a *= exp2f((m_a - new_a) * kLog2e);
    l_b *= exp2f((m_b - new_b) * kLog2e);
    const float off_a = new_a * kLog2e, off_b = new_b * kLog2e;
#pragma unroll
    for (int nt = 0; nt < kKeyChunk / 8; ++nt) {
      l_a += exp2f(fmaf(s[nt][0], kLog2e, -off_a)) + exp2f(fmaf(s[nt][1], kLog2e, -off_a));
      l_b += exp2f(fmaf(s[nt][2], kLog2e, -off_b)) + exp2f(fmaf(s[nt][3], kLog2e, -off_b));
    }
    m_a = new_a;
    m_b = new_b;
  }
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float off_a = m_a * kLog2e, off_b = m_b * kLog2e;
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  // normalised probability of score x in row a / b
  auto prob_a = [&](float x) { return exp2f(fmaf(x, kLog2e, -off_a)) * inv_a; };
  auto prob_b = [&](float x) { return exp2f(fmaf(x, kLog2e, -off_b)) * inv_b; };

  // Pass 2: normalised probabilities, rounded to bf16, times V.
  float o[HD / 8][4];
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  for (int kc = 0; kc < np; kc += kKeyChunk) {
    score_chunk<HD>(s, qa, ks, kc, g, t, n);
#pragma unroll
    for (int kk = 0; kk < kKeyChunk / 16; ++kk) {
      // The accumulators of two adjacent key tiles are the A fragment of a
      // 16-key slice of P.
      uint32_t pa[4];
      pa[0] = pack_bf16(prob_a(s[2 * kk][0]), prob_a(s[2 * kk][1]));
      pa[1] = pack_bf16(prob_b(s[2 * kk][2]), prob_b(s[2 * kk][3]));
      pa[2] = pack_bf16(prob_a(s[2 * kk + 1][0]), prob_a(s[2 * kk + 1][1]));
      pa[3] = pack_bf16(prob_b(s[2 * kk + 1][2]), prob_b(s[2 * kk + 1][3]));
      // B fragment of V: keys 2t+{0,1} (+8), column dn*8+g
      const uint16_t* v0 = vs + (kc + kk * 16 + t * 2) * LD + g;
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn) {
        const uint16_t* vp = v0 + dn * 8;
        const uint32_t b0 = pack_raw(vp[0], vp[LD]);
        const uint32_t b1 = pack_raw(vp[8 * LD], vp[9 * LD]);
        mma_bf16(o[dn], pa, b0, b1);
      }
    }
  }

  uint16_t* out_b = out + static_cast<size_t>(b) * n * c + h * HD;
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    const int col = dn * 8 + t * 2;
    if (ra < n)
      *reinterpret_cast<uint32_t*>(out_b + static_cast<size_t>(ra) * c + col) =
          pack_bf16(o[dn][0], o[dn][1]);
    if (rb < n)
      *reinterpret_cast<uint32_t*>(out_b + static_cast<size_t>(rb) * c + col) =
          pack_bf16(o[dn][2], o[dn][3]);
  }
}

// ---- f32: FMA path ----------------------------------------------------------

constexpr int kF32Threads = 128;  // one query row per thread

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
  const float* base = qkv + static_cast<size_t>(b) * n * row_stride;

  constexpr int kVec = 4;
  constexpr int kChunksPerRow = HD / kVec;
  for (int i = threadIdx.x; i < n * kChunksPerRow; i += kF32Threads) {
    const int r = i / kChunksPerRow;
    const int col = (i % kChunksPerRow) * kVec;
    const float* src = base + r * row_stride + h * HD + col;
    *reinterpret_cast<float4*>(ks + r * HD + col) = *reinterpret_cast<const float4*>(src + c);
    *reinterpret_cast<float4*>(vs + r * HD + col) =
        *reinterpret_cast<const float4*>(src + 2 * c);
  }
  __syncthreads();

  const int r = qt * kF32Threads + threadIdx.x;
  if (r >= n) return;
  float q[HD];
  const float* qrow = base + r * row_stride + h * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) q[d] = qrow[d] * scale;

  // Pass 1: online row max and sum (every thread reads the same K row: a
  // shared-memory broadcast).
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < n; ++j) {
    const float* kr = ks + j * HD;
    float sc = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) sc = fmaf(q[d], kr[d], sc);
    if (sc > m) {
      l = l * expf(m - sc) + 1.f;
      m = sc;
    } else {
      l += expf(sc - m);
    }
  }

  // Pass 2: normalised probabilities times V.
  float o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float* kr = ks + j * HD;
    float sc = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) sc = fmaf(q[d], kr[d], sc);
    const float p = expf(sc - m) / l;
    const float* vr = vs + j * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = fmaf(p, vr[d], o[d]);
  }
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
    const int np = (n + kKeyChunk - 1) / kKeyChunk * kKeyChunk;
    const dim3 grid(batch * q_tiles, heads);
    const size_t smem = 2 * static_cast<size_t>(np) * (head_dim + 8) * sizeof(uint16_t);
    return launch<uint16_t>(head_dim == 64 ? attention_bf16_kernel<64> : attention_bf16_kernel<32>,
                            grid, kThreads, smem, st, qkv, out, n, heads, q_tiles, scale);
  }
  const int q_tiles = (n + kF32Threads - 1) / kF32Threads;
  const dim3 grid(batch * q_tiles, heads);
  const size_t smem = 2 * static_cast<size_t>(n) * head_dim * sizeof(float);
  return launch<float>(head_dim == 64 ? attention_f32_kernel<64> : attention_f32_kernel<32>, grid,
                       kF32Threads, smem, st, qkv, out, n, heads, q_tiles, scale);
}
