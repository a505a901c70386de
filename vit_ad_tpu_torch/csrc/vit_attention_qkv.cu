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
// and the output is stored in the input dtype. That is not flash attention's
// deferred normalisation, which would round unnormalised probabilities: the
// row sum must be known before the first probability is rounded. exp(x) is
// taken as exp2(x * log2 e), one multiply-add and one MUFU.EX2.
//
// What bounds it on the H100: at the flagship shape (B=128, N=198, C=768,
// H=12, hd=64, bf16) one call reads 116.8 MB of qkv and writes 38.9 MB, 46 us
// at 3.35 TB/s, against 15.4 GFLOP (4*B*H*N^2*hd), 16 us at the 989 TFLOP/s
// bf16 tensor-core rate but 230 us at the 67 TFLOP/s of the CUDA cores. With
// tensor cores the kernel is memory bound.
//
// The first version (attention_common.cuh `attend_tile`, still taken for 209
// to 256 tokens) read 0.265 ms there on an NVIDIA H100 80GB HBM3 at 700 W
// (0.201 ms back to back; SDPA 0.110 / 0.085): a two-pass softmax that ran
// QK^T twice, B fragments by 32-bit and 16-bit shared-memory loads (V four
// loads and two packs per MMA), keys padded from 198 to 256, two query tiles
// of 128 per image that each staged K and V again behind a barrier. Its
// instruction stream around the MMAs held it, not memory.
//
// This version, for up to 208 tokens (attention_one_pass_kernel): a warp's
// 16 x N f32 scores stay in registers (26 key tiles of 8 = 104 registers a
// thread), so one QK^T pass serves the max, the sum and the probabilities: a
// third of the MMAs and the second exponentials go. K fragments come by
// ldmatrix.x4 and V fragments by ldmatrix.x4.trans, one instruction for the B
// operands of two MMAs; Q, K and V are staged by cp.async (Q and K in one
// group, V in a second that lands while QK^T and the softmax run), Q's A
// fragments come by ldmatrix from its staged tile and are scaled in
// registers. Keys are padded to 16, not 64 (198 -> 208), and the queries go
// in 16-row tiles over the whole image: 13 warps' worth, split over two blocks
// of 7 and 6 warps that share an SM, so one block's staging overlaps the
// other's arithmetic. What holds it now: every warp re-reads all of K and V
// from shared memory (ldmatrix traffic ~0.69 MB per (image, head), a third of
// the kernel's time at the SM's 128 bytes a clock), and with 14 warps an SM
// in two blocks the shared-memory, tensor, special-function and FP32 phases
// of a block barely overlap; the library's kernel feeds wgmma from shared
// memory with 64-row tiles and reads a quarter of that. The alternative that
// keeps two passes and gives a warp 32 rows was not built: it keeps the second
// QK^T pass.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W at the flagship shape, over
// the whole runs of chip_smoke.py that PERF.md lists: 0.111 to 0.112 ms a call
// back to back, 2.4x the bound (SDPA, a wgmma kernel of the library: 0.086);
// by CUDA events around single calls 0.15 to 0.18 ms (SDPA 0.10 to 0.12), the host's
// share of a call moving from run to run.
//
// The f32 path (the f32 numerics policy, off the flagship path) is plain FMA:
// the tensor cores have no f32 product that keeps full f32 precision.
//
// The device code of the first version and of the f32 path (K/V staging,
// fragments, the two-pass softmax) and the cp.async / ldmatrix wrappers live in
// attention_common.cuh, shared with swin_window_attention.cu.

#include "attention_common.cuh"
#include "launch_common.cuh"

namespace {

using namespace vitad_attention;

// ---- bf16, 209 to 256 tokens: the two-pass form ----------------------------------

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

// ---- bf16, up to 208 tokens: one score pass, scores in registers ---------------

constexpr int kOnePassMaxTokens = 208;
constexpr int kKeyTiles = kOnePassMaxTokens / 8;  // n8 score tiles a warp holds

constexpr int kOnePassWarps = 7;                  // at most, per block

// A block has up to 7 warps, one 16-row query tile each: an image's
// ceil(n / 16) tiles are spread evenly over ceil(tiles / 7) blocks (13 tiles
// at 198 tokens: 7 + 6).
__host__ __device__ __forceinline__ int one_pass_q_blocks(int n) {
  return ((n + 15) / 16 + kOnePassWarps - 1) / kOnePassWarps;
}
__host__ __device__ __forceinline__ int one_pass_warps(int n) {
  const int blocks = one_pass_q_blocks(n);
  return ((n + 15) / 16 + blocks - 1) / blocks;
}

// dynamic shared memory of one block: K and V padded to 16 keys and the
// block's Q rows, row pitch HD + 8 (rows stay 16-byte aligned and the 8 rows
// of an ldmatrix tile fall in distinct banks)
inline size_t one_pass_smem_bytes(int n, int head_dim) {
  const int np = (n + 15) / 16 * 16;
  return static_cast<size_t>(2 * np + 16 * one_pass_warps(n)) * (head_dim + 8) *
         sizeof(uint16_t);
}

// One block per (image, query block) x head; warp w owns query rows
// q0 + 16 w .. + 16 of the image. Two blocks share an SM: its registers hold
// 16 warps at the 128 registers a thread that the scores need. (Three blocks
// of 5 warps read the same time, four of 4 warps 19% more; one persistent
// block of 13 warps per SM, double-buffered over (image, head) units, 38%
// more: all its warps sit in the same phase at once.)
template <int HD>
__global__ void __launch_bounds__(kOnePassWarps * 32, 2)
attention_one_pass_kernel(const uint16_t* __restrict__ qkv, uint16_t* __restrict__ out, int n,
                          int heads, int q_blocks, float scale) {
  constexpr int LD = HD + 8;
  constexpr int kChunksPerRow = HD / 8;  // 16-byte chunks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = (n + 15) / 16 * 16;
  const int q_rows = 16 * (blockDim.x / 32);
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* vs = ks + np * LD;
  uint16_t* qs = vs + np * LD;

  const int b = blockIdx.x / q_blocks;
  const int q0 = (blockIdx.x % q_blocks) * q_rows;
  const int h = blockIdx.y;
  const int c = heads * HD;
  const size_t row_stride = 3 * static_cast<size_t>(c);
  const uint16_t* base = qkv + static_cast<size_t>(b) * n * row_stride + h * HD;

  // Stage Q and K (group 0), then V (group 1); rows past n are zeros (a zero V
  // row keeps 0 * garbage from turning into NaN).
  const int q_live = min(q_rows, n - q0);
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < q_rows * kChunksPerRow; i += blockDim.x) {
    const int r = i / kChunksPerRow;
    const int col = (i % kChunksPerRow) * 8;
    if (r < q_live)
      cp_async_16(shared_u32(qs + r * LD + col), base + (q0 + r) * row_stride + col);
    else
      *reinterpret_cast<uint4*>(qs + r * LD + col) = zero4;
  }
  for (int i = threadIdx.x; i < np * kChunksPerRow; i += blockDim.x) {
    const int r = i / kChunksPerRow;
    const int col = (i % kChunksPerRow) * 8;
    if (r < n)
      cp_async_16(shared_u32(ks + r * LD + col), base + c + r * row_stride + col);
    else
      *reinterpret_cast<uint4*>(ks + r * LD + col) = zero4;
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < np * kChunksPerRow; i += blockDim.x) {
    const int r = i / kChunksPerRow;
    const int col = (i % kChunksPerRow) * 8;
    if (r < n)
      cp_async_16(shared_u32(vs + r * LD + col), base + 2 * c + r * row_stride + col);
    else
      *reinterpret_cast<uint4*>(vs + r * LD + col) = zero4;
  }
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + warp * 16;
  const bool live = row0 < n;  // the same for the whole warp
  const int key_tiles = np / 8;  // even

  cp_async_wait<1>();
  __syncthreads();  // Q and K have landed

  // P = softmax(q*scale K^T), normalised and rounded: pa[kk] is the A fragment
  // of keys 16 kk .. + 16
  uint32_t pa[kKeyTiles / 2][4];
  if (live) {
    // scores: s[nt][0..1] are row g, keys 8 nt + 2t + {0, 1}; s[nt][2..3] row g + 8
    float s[kKeyTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    // lane's row address of ldmatrix tiles: Q tile i = rows 8 (i & 1), columns
    // 8 (i >> 1); K tile i = keys 8 (i >> 1), columns 8 (i & 1)
    const uint32_t q_addr =
        shared_u32(qs + (warp * 16 + (lane & 15)) * LD + 8 * (lane >> 4));
    const uint32_t k_addr =
        shared_u32(ks + ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1));
#pragma unroll
    for (int kstep = 0; kstep < HD / 16; ++kstep) {
      uint32_t qa[4];
      ldmatrix_x4(qa, q_addr + kstep * 32);
#pragma unroll
      for (int j = 0; j < 4; ++j) qa[j] = scale_bf16x2(qa[j], scale);
#pragma unroll
      for (int pair = 0; pair < kKeyTiles / 2; ++pair) {
        if (2 * pair < key_tiles) {
          uint32_t kb[4];
          ldmatrix_x4(kb, k_addr + pair * 16 * LD * 2 + kstep * 32);
          mma_bf16(s[2 * pair], qa, kb[0], kb[1]);
          mma_bf16(s[2 * pair + 1], qa, kb[2], kb[3]);
        }
      }
    }
    // mask the padded keys, row max (key 0 is live, so the max is finite)
    float m_a = -INFINITY, m_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
      if (nt < key_tiles) {
        if (nt * 8 + 8 > n) {
          const int key = nt * 8 + t * 2;
          if (key >= n) s[nt][0] = s[nt][2] = -INFINITY;
          if (key + 1 >= n) s[nt][1] = s[nt][3] = -INFINITY;
        }
        m_a = fmaxf(m_a, fmaxf(s[nt][0], s[nt][1]));
        m_b = fmaxf(m_b, fmaxf(s[nt][2], s[nt][3]));
      }
    }
    // the four threads of a quad share a row
    m_a = fmaxf(m_a, __shfl_xor_sync(0xffffffffu, m_a, 1));
    m_a = fmaxf(m_a, __shfl_xor_sync(0xffffffffu, m_a, 2));
    m_b = fmaxf(m_b, __shfl_xor_sync(0xffffffffu, m_b, 1));
    m_b = fmaxf(m_b, __shfl_xor_sync(0xffffffffu, m_b, 2));
    const float off_a = m_a * kLog2e, off_b = m_b * kLog2e;
    float l_a = 0.f, l_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
      if (nt < key_tiles) {
        s[nt][0] = exp2_approx(fmaf(s[nt][0], kLog2e, -off_a));
        s[nt][1] = exp2_approx(fmaf(s[nt][1], kLog2e, -off_a));
        s[nt][2] = exp2_approx(fmaf(s[nt][2], kLog2e, -off_b));
        s[nt][3] = exp2_approx(fmaf(s[nt][3], kLog2e, -off_b));
        l_a += s[nt][0] + s[nt][1];
        l_b += s[nt][2] + s[nt][3];
      }
    }
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
    // the accumulators of two adjacent key tiles are the A fragment of a
    // 16-key slice of P
#pragma unroll
    for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
      if (2 * kk < key_tiles) {
        pa[kk][0] = pack_bf16(s[2 * kk][0] * inv_a, s[2 * kk][1] * inv_a);
        pa[kk][1] = pack_bf16(s[2 * kk][2] * inv_b, s[2 * kk][3] * inv_b);
        pa[kk][2] = pack_bf16(s[2 * kk + 1][0] * inv_a, s[2 * kk + 1][1] * inv_a);
        pa[kk][3] = pack_bf16(s[2 * kk + 1][2] * inv_b, s[2 * kk + 1][3] * inv_b);
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // V has landed
  if (!live) return;  // no barrier follows

  float o[HD / 8][4];
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  // V tile i of a transposing ldmatrix = keys 8 (i & 1), columns 8 (i >> 1)
  const uint32_t v_addr =
      shared_u32(vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4));
#pragma unroll
  for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
    if (2 * kk < key_tiles) {
#pragma unroll
      for (int pair = 0; pair < HD / 16; ++pair) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_addr + kk * 16 * LD * 2 + pair * 32);
        mma_bf16(o[2 * pair], pa[kk], vb[0], vb[1]);
        mma_bf16(o[2 * pair + 1], pa[kk], vb[2], vb[3]);
      }
    }
  }
  store_tile<HD>(out + static_cast<size_t>(b) * n * c + h * HD, c, row0 + g, row0 + g + 8, n, t,
                 o);
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
// (above the 48 KB default; once per kernel and device), launch on `stream`,
// report the launch status.
template <typename T>
int launch(void (*kernel)(const T*, T*, int, int, int, float), dim3 grid, int threads,
           size_t smem, int device, cudaStream_t stream, const void* qkv, void* out, int n,
           int heads, int q_tiles, float scale) {
  const int err =
      vitad_launch::raise_dynamic_smem(reinterpret_cast<const void*>(kernel), smem, device);
  if (err != 0) return err;
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out), n,
                                          heads, q_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

// What the entry point reports as the kernel it launched.
constexpr int kRouteOnePass = 1, kRouteTwoPass = 2, kRouteFma = 3;

}  // namespace

// Plain C entry point, bound with ctypes. qkv [batch, n, 3*heads*head_dim] and
// out [batch, n, heads*head_dim] are contiguous, 16-byte aligned device
// buffers of bf16 (is_bf16 != 0) or f32. `scale` is hd^-1/2 already rounded to
// the input dtype. bf16 with n <= 208 takes the one-pass kernel, bf16 above it
// the two-pass kernel, f32 the FMA kernel; the branch that launches writes
// which it was to the host int `route` (1 one-pass, 2 two-pass, 3 FMA; 0 if
// nothing was launched). Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int vit_attention_qkv_forward(const void* qkv, void* out, int batch, int n,
                                         int heads, int head_dim, int is_bf16, float scale,
                                         int device, void* stream, int* route) {
  if (route == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *route = 0;
  if (batch < 1 || n < 1 || n > kMaxTokens || heads < 1 || heads > 65535 ||
      (head_dim != 32 && head_dim != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  if (is_bf16 && n <= kOnePassMaxTokens) {
    const int q_blocks = one_pass_q_blocks(n);
    const dim3 grid(batch * q_blocks, heads);
    const int rc = launch<uint16_t>(
        head_dim == 64 ? attention_one_pass_kernel<64> : attention_one_pass_kernel<32>, grid,
        one_pass_warps(n) * 32, one_pass_smem_bytes(n, head_dim), device, st, qkv, out, n, heads,
        q_blocks, scale);
    if (rc == 0) *route = kRouteOnePass;
    return rc;
  }
  if (is_bf16) {
    const int q_tiles = (n + kQTile - 1) / kQTile;
    const dim3 grid(batch * q_tiles, heads);
    const size_t smem = bf16_smem_bytes(n, head_dim);
    const int rc =
        launch<uint16_t>(head_dim == 64 ? attention_bf16_kernel<64> : attention_bf16_kernel<32>,
                         grid, kThreads, smem, device, st, qkv, out, n, heads, q_tiles, scale);
    if (rc == 0) *route = kRouteTwoPass;
    return rc;
  }
  const int q_tiles = (n + kF32Threads - 1) / kF32Threads;
  const dim3 grid(batch * q_tiles, heads);
  const size_t smem = f32_smem_bytes(n, head_dim);
  const int rc =
      launch<float>(head_dim == 64 ? attention_f32_kernel<64> : attention_f32_kernel<32>, grid,
                    kF32Threads, smem, device, st, qkv, out, n, heads, q_tiles, scale);
  if (rc == 0) *route = kRouteFma;
  return rc;
}
