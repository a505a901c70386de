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
// halve the bytes each (46, 23, 11.5 us). By that count it is memory bound.
//
// Which form serves which N (the entry reports the one it launched):
//
//   bf16, N <= 208   window_one_pass_{wide,narrow}_kernel. A warp holds its 16 x N f32
//                    scores in registers over ONE QK^T pass, which serves the
//                    row max, the row sum and the probabilities. Q (the block's
//                    rows), K and V of a (window, head) unit are staged by
//                    cp.async (Q and K in one group, V in a second that lands
//                    while QK^T and the softmax run), row pitch hd + 8; Q's A
//                    and K's B fragments come by ldmatrix.x4, V's by
//                    ldmatrix.x4.trans. Keys are padded to 16, not 64 (196 ->
//                    208, 49 -> 64). Bias and mask are added to the register
//                    scores in the TPU kernel's order, (s + bias) + mask, by one
//                    8-byte load per key pair where N is even (196) and scalar
//                    loads where it is odd (49); no element past N is read and
//                    padded keys get -inf. Exponentials by ex2.approx.
//                    Up to 208 tokens a unit's 16-row query tiles are spread
//                    over blocks of at most 7 warps (13 tiles at 196: 7 + 6, as
//                    the ViT kernel); with a mask a block takes two units of
//                    one head whose windows share the mask row (images 2i and
//                    2i + 1), so L2 serves their bias and mask rows once (one
//                    block of 14 warps an SM), without one two blocks of one
//                    unit share an SM. Up to 64 tokens a unit fills at most 4
//                    warps: a block of 16 warps takes 16 / tiles units of one
//                    head (4 at 49) and the score array is sized to 8 key tiles.
//   bf16, 209-256    window_attention_bf16_kernel, the first form
//                    (attention_common.cuh `attend_tile`): two softmax passes
//                    over chunks of 64 keys, QK^T run twice, bias and mask read
//                    in both (windows of 15^2 and 16^2 only).
//   f32              window_attention_f32_kernel, plain FMA (the f32 numerics
//                    policy and the tests).
//
// What holds the one-pass kernel (PERF.md section 6 has the variants and the
// runs): the f32 bias and mask rows, read in the register layout from
// L2 (~0.95 GB each a call at stage 0 unpaired; without the adds the kernel
// reads ~60% of its time there), and the scores' 128 registers a thread, at
// which ptxas spills 100-300 bytes (a cap of 144 leaves one block an SM and
// reads 40% slower). Measured on an NVIDIA H100 80GB HBM3 at 700 W, back to
// back through the raw entry (`chip_smoke.py --against`; two earlier whole
// runs, of forms that differ in the loop order, within 2.5%): 0.686 / 0.353 /
// 0.1555 / 0.0347 ms at stages 0-3 (stages 0-1 with the shift mask; unmasked
// 0.592 / 0.305), 7.4x the bound at stage 0; SDPA 0.597 / 0.302 / 0.157 / 0.169; the first form
// 1.232 / 0.618 / 0.279 / 0.058. The split entry (normalised rounding) 0.718
// at stage 0 (first form 1.230).

#include "attention_common.cuh"
#include "launch_common.cuh"

namespace {

using namespace vitad_attention;

// ---- bf16, 209 to 256 tokens: the two-pass form ----------------------------------

// One block per (window, head); each warp walks the window's 16-row query
// tiles (the launch gives a block eight warps).
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

// ---- bf16, up to 208 tokens: one score pass, scores in registers ---------------

constexpr int kOnePassMaxTokens = 208;
constexpr int kWideKeyTiles = kOnePassMaxTokens / 8;  // n8 score tiles a warp holds
constexpr int kWideUnitWarps = 7;                     // at most, per unit and block
constexpr int kNarrowMaxTokens = 64;
constexpr int kNarrowKeyTiles = kNarrowMaxTokens / 8;
constexpr int kNarrowWarps = 16;                      // per block, over several units

// How the (window, head) units and their 16-row query tiles map onto blocks.
// The units of a block share the head and the mask row: their warps read the
// same bias and mask rows at the same time, and L2 serves them once. Up to 64
// tokens a block takes 16 / tiles units; above, two units when there is a
// mask (one block of 14 warps an SM) and one without (two blocks of 7 warps
// an SM: consecutive blocks on an SM share the head, so the bias rows come
// from L1 either way, and two blocks overlap one's staging with the other's
// arithmetic).
struct OnePassShape {
  int q_blocks;    // blocks per unit (each takes unit_warps tiles)
  int unit_warps;  // warps a unit has in a block
  int units;       // units per block
};

__host__ __device__ __forceinline__ OnePassShape one_pass_shape(int n, bool masked) {
  const int tiles = (n + 15) / 16;
  if (n <= kNarrowMaxTokens) return {1, tiles, kNarrowWarps / tiles};
  const int q_blocks = (tiles + kWideUnitWarps - 1) / kWideUnitWarps;  // 13 tiles at 196: 7 + 6
  return {q_blocks, (tiles + q_blocks - 1) / q_blocks, masked ? 2 : 1};
}

// shared-memory elements of one unit's slot: K and V padded to 16 keys and the
// block's Q rows of the unit, row pitch HD + 8 (rows stay 16-byte aligned and
// the 8 rows of an ldmatrix tile fall in distinct banks)
__host__ __device__ __forceinline__ int one_pass_slot_elems(int n, int unit_warps, int hd) {
  return (2 * ((n + 15) / 16 * 16) + 16 * unit_warps) * (hd + 8);
}

// s += bias (+ mask) for this thread's keys `key` and `key + 1` (key = 8 nt +
// 2t of a score tile nt) of its rows a and b (bias_a / bias_b, mask_a /
// mask_b: their f32 [n] rows), (s + bias) + mask as the TPU kernel adds them;
// keys past n become -inf and are not read. With kPairs (n even) the two keys
// come by one 8-byte load.
template <bool kPairs, bool kMask>
__device__ __forceinline__ void add_bias_tile(float (&s)[4], const float* bias_a,
                                              const float* bias_b, const float* mask_a,
                                              const float* mask_b, int key, int n) {
  if (key + 1 < n) {
    if (kPairs) {
      const float2 ba = *reinterpret_cast<const float2*>(bias_a + key);
      const float2 bb = *reinterpret_cast<const float2*>(bias_b + key);
      s[0] += ba.x;
      s[1] += ba.y;
      s[2] += bb.x;
      s[3] += bb.y;
      if (kMask) {
        const float2 ma = *reinterpret_cast<const float2*>(mask_a + key);
        const float2 mb = *reinterpret_cast<const float2*>(mask_b + key);
        s[0] += ma.x;
        s[1] += ma.y;
        s[2] += mb.x;
        s[3] += mb.y;
      }
    } else {
      s[0] += bias_a[key];
      s[1] += bias_a[key + 1];
      s[2] += bias_b[key];
      s[3] += bias_b[key + 1];
      if (kMask) {
        s[0] += mask_a[key];
        s[1] += mask_a[key + 1];
        s[2] += mask_b[key];
        s[3] += mask_b[key + 1];
      }
    }
  } else if (key < n) {
    s[0] += bias_a[key];
    s[2] += bias_b[key];
    if (kMask) {
      s[0] += mask_a[key];
      s[2] += mask_b[key];
    }
    s[1] = s[3] = -INFINITY;
  } else {
    s[0] = s[1] = s[2] = s[3] = -INFINITY;
  }
}

// Softmax(q k^T + bias [+ mask]) of one warp's 16 query rows into P's A
// fragments: pa[kk] holds keys 16 kk .. + 16, the exponentials times `pre`
// (1 under kDefer, else 1 / l) rounded to bf16; inv_a / inv_b are 1 / l of
// rows g and g + 8. q_addr is the lane's ldmatrix row address of the warp's Q
// tile, k_addr its address into the unit's K tiles.
template <int HD, bool kDefer, int kKeyTiles, bool kPairs, bool kMask>
__device__ __forceinline__ void one_pass_probs(uint32_t (&pa)[kKeyTiles / 2][4], float& inv_a,
                                               float& inv_b, uint32_t q_addr, uint32_t k_addr,
                                               int key_tiles, const float* bias_a,
                                               const float* bias_b, const float* mask_a,
                                               const float* mask_b, int t, int n, float scale) {
  constexpr int LD = HD + 8;
  // scores: s[nt][0..1] are row g, keys 8 nt + 2t + {0, 1}; s[nt][2..3] row g + 8
  float s[kKeyTiles][4];
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kstep = 0; kstep < HD / 16; ++kstep) {
    ldmatrix_x4(qa[kstep], q_addr + kstep * 32);
#pragma unroll
    for (int j = 0; j < 4; ++j) qa[kstep][j] = scale_bf16x2(qa[kstep][j], scale);
  }
  // a key pair's products, then its adds
#pragma unroll
  for (int pair = 0; pair < kKeyTiles / 2; ++pair) {
    if (2 * pair < key_tiles) {
      s[2 * pair][0] = s[2 * pair][1] = s[2 * pair][2] = s[2 * pair][3] = 0.f;
      s[2 * pair + 1][0] = s[2 * pair + 1][1] = s[2 * pair + 1][2] = s[2 * pair + 1][3] = 0.f;
#pragma unroll
      for (int kstep = 0; kstep < HD / 16; ++kstep) {
        uint32_t kb[4];
        ldmatrix_x4(kb, k_addr + pair * 16 * LD * 2 + kstep * 32);
        mma_bf16(s[2 * pair], qa[kstep], kb[0], kb[1]);
        mma_bf16(s[2 * pair + 1], qa[kstep], kb[2], kb[3]);
      }
      add_bias_tile<kPairs, kMask>(s[2 * pair], bias_a, bias_b, mask_a, mask_b,
                                   16 * pair + 2 * t, n);
      add_bias_tile<kPairs, kMask>(s[2 * pair + 1], bias_a, bias_b, mask_a, mask_b,
                                   16 * pair + 8 + 2 * t, n);
    }
  }
  // row max (key 0 is live and bias and mask are finite, so it is finite)
  float m_a = -INFINITY, m_b = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kKeyTiles; ++nt) {
    if (nt < key_tiles) {
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
  inv_a = 1.f / l_a;
  inv_b = 1.f / l_b;
  // the probability as it is rounded before PV: the bare exponential
  // (kDefer) or the normalised one
  const float pre_a = kDefer ? 1.f : inv_a, pre_b = kDefer ? 1.f : inv_b;
  // the accumulators of two adjacent key tiles are the A fragment of a
  // 16-key slice of P
#pragma unroll
  for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
    if (2 * kk < key_tiles) {
      pa[kk][0] = pack_bf16(s[2 * kk][0] * pre_a, s[2 * kk][1] * pre_a);
      pa[kk][1] = pack_bf16(s[2 * kk][2] * pre_b, s[2 * kk][3] * pre_b);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0] * pre_a, s[2 * kk + 1][1] * pre_a);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2] * pre_b, s[2 * kk + 1][3] * pre_b);
    }
  }
}

// A block takes `shape.units` (window, head) units of one head h whose windows
// share a mask row: windows b0 + s * n_w, s < units (n_w = 1 without a mask),
// the same images' worth of windows apart; of each it takes the 16-row query
// tiles of one query block. Warp w serves slot w / unit_warps, tile w %
// unit_warps. Block index = ((group * n_w + mask row) * heads + h) * q_blocks +
// query block, where a group is `units` images of n_w windows. Rows past n,
// and slots past the last window, are staged as zeros and computed by no warp.
// kMasked: 1 or 0 when the kernel is built for launches with or without a
// mask, -1 when `mask` decides at run time. A kernel that holds one form of
// the adds spills less and reads ~2% faster than one that holds both.
template <int HD, bool kDefer, int kKeyTiles, int kMasked>
__device__ __forceinline__ void window_one_pass(const uint16_t* __restrict__ q,
                                                const uint16_t* __restrict__ k,
                                                const uint16_t* __restrict__ v,
                                                uint16_t* __restrict__ out,
                                                const float* __restrict__ bias,
                                                const float* __restrict__ mask, int n, int heads,
                                                int row_stride_i, int n_w, int batch,
                                                float scale) {
  constexpr int LD = HD + 8;
  constexpr int kChunks = HD / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* smem = reinterpret_cast<uint16_t*>(smem_raw);
  const bool masked = kMasked < 0 ? mask != nullptr : kMasked == 1;
  const OnePassShape shape = one_pass_shape(n, masked);
  const int np = (n + 15) / 16 * 16;
  const int q_rows = 16 * shape.unit_warps;
  const int slot_elems = one_pass_slot_elems(n, shape.unit_warps, HD);
  int blk = blockIdx.x;
  const int q0 = (blk % shape.q_blocks) * q_rows;
  blk /= shape.q_blocks;
  const int h = blk % heads;
  blk /= heads;
  const int w_row = blk % n_w;  // the mask row of every window of the block
  const int b0 = (blk / n_w) * shape.units * n_w + w_row;
  const size_t row_stride = static_cast<size_t>(row_stride_i);
  // offset of window b's row 0, head h, in q, k, v
  auto window_off = [&](int b) {
    return static_cast<size_t>(b) * n * row_stride + static_cast<size_t>(h) * HD;
  };

  // Stage Q and K (group 0), then V (group 1), slot by slot; rows past n and
  // slots past the last window are zeros (a zero V row keeps 0 * garbage from
  // turning into NaN).
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  for (int slot = 0; slot < shape.units; ++slot) {
    const int b = b0 + slot * n_w;
    const int rows = b < batch ? n : 0;  // rows of this slot to copy
    const size_t off = b < batch ? window_off(b) : 0;
    uint16_t* ks = smem + slot * slot_elems;
    uint16_t* qs = ks + 2 * np * LD;
    for (int i = threadIdx.x; i < (q_rows + np) * kChunks; i += blockDim.x) {
      const int r = i / kChunks, col = (i % kChunks) * 8;
      if (r < q_rows) {  // Q row q0 + r
        if (q0 + r < rows)
          cp_async_16(shared_u32(qs + r * LD + col), q + off + (q0 + r) * row_stride + col);
        else
          *reinterpret_cast<uint4*>(qs + r * LD + col) = zero4;
      } else {           // K row r - q_rows
        const int kr = r - q_rows;
        if (kr < rows)
          cp_async_16(shared_u32(ks + kr * LD + col), k + off + kr * row_stride + col);
        else
          *reinterpret_cast<uint4*>(ks + kr * LD + col) = zero4;
      }
    }
  }
  cp_async_commit();
  for (int slot = 0; slot < shape.units; ++slot) {
    const int b = b0 + slot * n_w;
    const int rows = b < batch ? n : 0;
    const size_t off = b < batch ? window_off(b) : 0;
    uint16_t* vs = smem + slot * slot_elems + np * LD;
    for (int i = threadIdx.x; i < np * kChunks; i += blockDim.x) {
      const int r = i / kChunks, col = (i % kChunks) * 8;
      if (r < rows)
        cp_async_16(shared_u32(vs + r * LD + col), v + off + r * row_stride + col);
      else
        *reinterpret_cast<uint4*>(vs + r * LD + col) = zero4;
    }
  }
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int slot = warp / shape.unit_warps;
  const int row0 = q0 + (warp % shape.unit_warps) * 16;
  const int b = b0 + slot * n_w;
  const bool live = b < batch && row0 < n;  // the same for the whole warp
  const int key_tiles = np / 8;             // even
  const uint16_t* ks = smem + slot * slot_elems;
  const uint16_t* vs = ks + np * LD;
  const uint16_t* qs = vs + np * LD;

  cp_async_wait<1>();
  __syncthreads();  // Q and K have landed

  uint32_t pa[kKeyTiles / 2][4];
  float inv_a = 1.f, inv_b = 1.f;
  if (live) {
    // rows past n read the last row's bias and mask; their output is dropped
    const size_t off_a = static_cast<size_t>(min(row0 + g, n - 1)) * n;
    const size_t off_b = static_cast<size_t>(min(row0 + g + 8, n - 1)) * n;
    const float* bias_h = bias + static_cast<size_t>(h) * n * n;
    const float* mask_w = masked ? mask + static_cast<size_t>(w_row) * n * n : nullptr;
    // lane's row address of ldmatrix tiles: Q tile i = rows 8 (i & 1), columns
    // 8 (i >> 1); K tile i = keys 8 (i >> 1), columns 8 (i & 1)
    const uint32_t q_addr =
        shared_u32(qs + ((warp % shape.unit_warps) * 16 + (lane & 15)) * LD + 8 * (lane >> 4));
    const uint32_t k_addr =
        shared_u32(ks + ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1));
    const bool pairs = n % 2 == 0;  // 8-byte aligned bias and mask rows
    if (!masked) {
      if (pairs)
        one_pass_probs<HD, kDefer, kKeyTiles, true, false>(
            pa, inv_a, inv_b, q_addr, k_addr, key_tiles, bias_h + off_a, bias_h + off_b,
            nullptr, nullptr, t, n, scale);
      else
        one_pass_probs<HD, kDefer, kKeyTiles, false, false>(
            pa, inv_a, inv_b, q_addr, k_addr, key_tiles, bias_h + off_a, bias_h + off_b,
            nullptr, nullptr, t, n, scale);
    } else {
      if (pairs)
        one_pass_probs<HD, kDefer, kKeyTiles, true, true>(
            pa, inv_a, inv_b, q_addr, k_addr, key_tiles, bias_h + off_a, bias_h + off_b,
            mask_w + off_a, mask_w + off_b, t, n, scale);
      else
        one_pass_probs<HD, kDefer, kKeyTiles, false, true>(
            pa, inv_a, inv_b, q_addr, k_addr, key_tiles, bias_h + off_a, bias_h + off_b,
            mask_w + off_a, mask_w + off_b, t, n, scale);
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
  if (kDefer) {
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      o[dn][0] *= inv_a;
      o[dn][1] *= inv_a;
      o[dn][2] *= inv_b;
      o[dn][3] *= inv_b;
    }
  }
  const size_t c = static_cast<size_t>(heads) * HD;
  store_tile<HD>(out + static_cast<size_t>(b) * n * c + static_cast<size_t>(h) * HD, c,
                 row0 + g, row0 + g + 8, n, t, o);
}

// Up to 208 tokens, one kernel for launches with a mask (blocks of two units)
// and one without (blocks of one unit); the scores' 128 registers a thread
// hold 16 warps an SM (blocks of 7 warps count as 8), so one block of two
// units or two blocks of one.
template <int HD, bool kDefer, bool kMasked>
__global__ void __launch_bounds__((kMasked ? 2 : 1) * kWideUnitWarps * 32, kMasked ? 1 : 2)
window_one_pass_wide_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                            const uint16_t* __restrict__ v, uint16_t* __restrict__ out,
                            const float* __restrict__ bias, const float* __restrict__ mask, int n,
                            int heads, int row_stride, int n_w, int batch, float scale) {
  window_one_pass<HD, kDefer, kWideKeyTiles, kMasked ? 1 : 0>(q, k, v, out, bias, mask, n, heads,
                                                              row_stride, n_w, batch, scale);
}

// Up to 64 tokens: blocks of 16 warps over 16 / tiles units.
template <int HD, bool kDefer>
__global__ void __launch_bounds__(kNarrowWarps * 32, 1)
window_one_pass_narrow_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                              const uint16_t* __restrict__ v, uint16_t* __restrict__ out,
                              const float* __restrict__ bias, const float* __restrict__ mask,
                              int n, int heads, int row_stride, int n_w, int batch,
                              float scale) {
  window_one_pass<HD, kDefer, kNarrowKeyTiles, -1>(q, k, v, out, bias, mask, n, heads,
                                                   row_stride, n_w, batch, scale);
}

// ---- f32: FMA path ----------------------------------------------------------

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
  bool is_bf16;
  float scale;
  int device;
  cudaStream_t stream;
};

// Raise the kernel's dynamic shared-memory limit to what this launch needs
// (above the 48 KB default; once per kernel and device), launch on the
// stream, report the launch status.
template <typename T, typename Kernel, typename... Extra>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, const Args& a, Extra... extra) {
  const int err =
      vitad_launch::raise_dynamic_smem(reinterpret_cast<const void*>(kernel), smem, a.device);
  if (err != 0) return err;
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), a.bias, a.mask, a.n, a.heads, a.row_stride, a.n_w, extra...,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool kDefer>
int launch_one_pass(const Args& a) {
  const OnePassShape s = one_pass_shape(a.n, a.mask != nullptr);
  const int images = a.batch / a.n_w;  // windows are the minor axis: b = image * n_w + row
  const int groups = (images + s.units - 1) / s.units;
  const int blocks = groups * a.n_w * a.heads * s.q_blocks;
  const size_t smem = static_cast<size_t>(s.units) *
                      one_pass_slot_elems(a.n, s.unit_warps, HD) * sizeof(uint16_t);
  const int threads = s.units * s.unit_warps * 32;
  if (a.n <= kNarrowMaxTokens)
    return launch<uint16_t>(window_one_pass_narrow_kernel<HD, kDefer>, dim3(blocks), threads,
                            smem, a, a.batch);
  if (a.mask != nullptr)
    return launch<uint16_t>(window_one_pass_wide_kernel<HD, kDefer, true>, dim3(blocks), threads,
                            smem, a, a.batch);
  return launch<uint16_t>(window_one_pass_wide_kernel<HD, kDefer, false>, dim3(blocks), threads,
                          smem, a, a.batch);
}

template <int HD, bool kDefer>
int launch_two_pass(const Args& a) {
  return launch<uint16_t>(window_attention_bf16_kernel<HD, kDefer>, dim3(a.batch, a.heads),
                          kThreads, bf16_smem_bytes(a.n, HD), a);
}

template <int HD, bool kDefer>
int launch_f32(const Args& a) {
  const int rows = (a.n + 31) / 32 * 32;
  const int threads = rows < kF32Threads ? rows : kF32Threads;
  return launch<float>(window_attention_f32_kernel<HD, kDefer>, dim3(a.batch, a.heads), threads,
                       f32_smem_bytes(a.n, HD), a);
}

// What the entry point reports as the kernel it launched.
constexpr int kRouteOnePass = 1, kRouteTwoPass = 2, kRouteFma = 3;

// Launch the form that serves this input; the branch that launched writes its
// route code.
template <int HD, bool kDefer>
int launch_form(const Args& a, int* route) {
  if (a.is_bf16 && a.n <= kOnePassMaxTokens) {
    const int rc = launch_one_pass<HD, kDefer>(a);
    if (rc == 0) *route = kRouteOnePass;
    return rc;
  }
  if (a.is_bf16) {
    const int rc = launch_two_pass<HD, kDefer>(a);
    if (rc == 0) *route = kRouteTwoPass;
    return rc;
  }
  const int rc = launch_f32<HD, kDefer>(a);
  if (rc == 0) *route = kRouteFma;
  return rc;
}

}  // namespace

// Plain C entry point, bound with ctypes. q, k, v point at [batch, n, ...]
// device buffers whose rows are `row_stride` elements apart and whose windows
// are n rows apart (packed qkv: q, q + C, q + 2C with row_stride 3C; split: three
// contiguous [batch, n, C] buffers with row_stride C); out [batch, n, C] is
// contiguous; all are 16-byte aligned, bf16 (is_bf16 != 0) or f32. bias
// [heads, n, n] and mask [n_w, n, n] (or null) are contiguous f32. `scale` is
// hd^-1/2 already rounded to the input dtype; defer_norm selects which
// probabilities are rounded (see the header of this file). bf16 with n <= 208
// takes the one-pass kernel, bf16 above it the two-pass kernel, f32 the FMA
// kernel; the branch that launches writes which it was to the host int `route`
// (1 one-pass, 2 two-pass, 3 FMA; 0 if nothing was launched). Launches on
// `stream` without synchronising and returns cudaGetLastError() (0 on success).
extern "C" int swin_window_attention_forward(const void* q, const void* k, const void* v,
                                             void* out, const void* bias, const void* mask,
                                             int batch, int n, int heads, int head_dim,
                                             int row_stride, int n_w, int defer_norm,
                                             int is_bf16, float scale, int device,
                                             void* stream, int* route) {
  if (route == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *route = 0;
  if (batch < 1 || n < 1 || n > kMaxTokens || heads < 1 || heads > 65535 ||
      (head_dim != 32 && head_dim != 64) || row_stride < heads * head_dim || row_stride % 8 ||
      bias == nullptr || (mask != nullptr && (n_w < 1 || batch % n_w != 0)) ||
      static_cast<long long>(batch) * heads > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, k, v, out, static_cast<const float*>(bias), static_cast<const float*>(mask),
               batch, n, heads, row_stride, mask == nullptr ? 1 : n_w, is_bf16 != 0, scale,
               device, static_cast<cudaStream_t>(stream)};
  if (head_dim == 64)
    return defer_norm ? launch_form<64, true>(a, route) : launch_form<64, false>(a, route);
  return defer_norm ? launch_form<32, true>(a, route) : launch_form<32, false>(a, route);
}
