// GMM per-feature log-likelihood (B2) and its two backwards (B3, B4) for
// Hopper (sm_90a).
//
// Replaces the TPU kernels
//   vit_ad_tpu/ops/pallas/gmm.py::_kernel, _kernel_dtiled        (forward, B2)
//   vit_ad_tpu/ops/pallas/gmm_train.py::_bwd_params_kernel      (B3)
//   vit_ad_tpu/ops/pallas/gmm_train.py::_bwd_x_kernel, _bwd_x_dtiled_kernel (B4)
//
// Math, for feature row r, output feature e and component k:
//   mu  = xm[r,:] . Wmu[k][e,:] + bmu[k][e]      pre = xm[r,:] . Wsig[k][e,:] + bsig[k][e]
//   sigma = where(pre > 0, pre + 1, exp(pre)) + 1e-15
//   dens  = -log(sigma) - log(2 pi)/2 - ((x - mu)/sigma)^2 / 2
//   ll[r,e] = logsumexp_k(dens + log_pi[r,k])   (online, from the -1e30 sentinel)
// and, with g = dL/dll and q = g * exp(dens + log_pi - ll), z = (x - mu)/sigma:
//   dmu = q z / sigma,  dpre = q (z^2 - 1)/sigma * elu'(pre),  d log_pi[r,k] = sum_e q
//   dWmu[k] = dmu^T xm,  dWsig[k] = dpre^T xm,  db = sum_r d(mu|pre)
//   dx = sum_k (dmu Wmu[k] + dpre Wsig[k]) - sum_k dmu
// xm is x rounded to the matmul type (bf16 or f32); x - mu uses f32 x. Under
// bf16 the weight gradients take bf16 dmu/dpre, as the TPU kernel does.
//
// Layout: the weights are read in place in the reference nn.Linear layout
// [D*K, D_in]: row e*K + k is output feature e of component k, contiguous in
// D_in. Component k's [D_out, D_in] block is rows k, K+k, 2K+k, ... (row
// stride K*D_in). Biases [D*K] with the same index. x, g, ll are [R, D] f32,
// log_pi [R, K] f32. The weight gradients are written in the same layout.
//
// Structure: every kernel is a 64x64 output tile per block of 8 warps (4 x 2,
// 16 x 32 each), the contraction staged 32 deep through shared memory, and
// products by mma.sync m16n8k16 bf16 with f32 accumulation (bf16 policy) or
// by f32 FMA in the same register layout (f32 policy; TF32 stays off). One
// kernel covers the full-width and the output-feature-tiled TPU bodies: the
// output features are always tiled by 64.
//
//   gmm_forward_kernel   (B2)  block (64 rows, 64 e): loops over K, the
//                              online logsumexp stays in registers.
//   gmm_terms_kernel     (B3)  block (64 rows, 64 e), a chunk of components:
//                              recomputes mu/pre exactly as the forward does,
//                              writes dmu/dpre to a global scratch
//                              [Kc, R, D], per-row-tile bias partials and
//                              per-e-tile d log_pi partials (reduced
//                              afterwards in a fixed order: no atomics, the
//                              gradients are deterministic), and, when dx
//                              is wanted, sum_k dmu in f32.
//   gmm_wgrad_kernel     (B3)  block (64 d_in, 64 e, one component): the
//                              weight gradients, contracting over all rows.
//   gmm_bwd_x_kernel     (B4)  block (64 rows, 64 d_in): dx over the chunk's
//                              components; the direct term -sum_k dmu is
//                              subtracted on the last chunk, element by
//                              element (it belongs to the tile it touches).
//
// The dW accumulator cannot stay resident across the row sweep as it did in
// the TPU's 16 MB of VMEM (a [768, 256] f32 block is 768 KB; an SM has
// 228 KB), so dmu/dpre go through global scratch per chunk of components
// instead of recomputing mu/pre once per D_in tile. Cost per train step at R
// rows: 3 x 4 R D^2 K FLOP (forward, recompute, weight gradients; +1 for dx)
// and 2 x 2 x R D K x sizeof(matmul type) bytes of scratch written and read
// (at B=32, D=768, K=150 bf16: 6.7 TFLOP and 5.8 GB). Recomputing per D_in
// tile instead would cost D/64 = 12 times the recompute FLOPs.
//
// What bounds it on the H100: at B=128 (R = 25,088), D=768, K=150 the
// forward does 4 R D^2 K = 8.9 TFLOP (9 ms at the 989 TFLOP/s bf16 peak). A
// 64-row tile re-reads every component's weights, 2 x 64 x 768 x 2 bytes for
// 12.6 MFLOP of products: 64 FLOP per byte, below the card's ridge, so the
// weights must come from L2: blocks of one e-tile are launched next to each
// other (blockIdx.x is the row tile) and sweep k in step. This first version
// stages every operand with plain loads and no double buffering, so it is
// bound by its loads, far from either roof; wgmma, TMA and a resident x tile
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kBK = 32;
constexpr float kHalfLog2Pi = 0.918938533204672742f;
constexpr float kNegBig = -1e30f;

template <typename T>
struct Smem;
template <>
struct Smem<__nv_bfloat16> {
  // 80-byte rows: the 32-bit fragment loads of a warp hit 32 distinct banks
  static constexpr int kLd = kBK + 8;
};
template <>
struct Smem<float> {
  static constexpr int kLd = kBK + 4;
};

template <typename TS>
struct Cvt;
template <>
struct Cvt<float> {
  __device__ static float from(float v) { return v; }
};
template <>
struct Cvt<__nv_bfloat16> {
  __device__ static __nv_bfloat16 from(float v) { return __float2bfloat16_rn(v); }
  __device__ static __nv_bfloat16 from(__nv_bfloat16 v) { return v; }
};

// Stage a 64 x kBK slice of an operand into shared memory as [row][k] with
// row pitch Smem<TS>::kLd, converted to TS; zeros outside rows [0, row_end)
// and depth [0, k_end). KCONTIG: element (row, k) is g[row * stride + k];
// otherwise g[k * stride + row]. 16-byte loads along the contiguous
// dimension, whose extent is a multiple of 64 (checked by the host), so a
// vector never straddles its end.
template <typename TG, typename TS, bool KCONTIG>
__device__ __forceinline__ void stage(TS* s, const TG* __restrict__ g, size_t stride, int row0,
                                      int row_end, int k0, int k_end) {
  constexpr int kLd = Smem<TS>::kLd;
  constexpr int kVec = 16 / sizeof(TG);
  if constexpr (KCONTIG) {
    constexpr int kPer = kBK / kVec;
    for (int i = threadIdx.x; i < kTile * kPer; i += kThreads) {
      const int r = i / kPer;
      const int k = (i % kPer) * kVec;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (row0 + r < row_end && k0 + k < k_end)
        raw = __ldg(reinterpret_cast<const uint4*>(g + static_cast<size_t>(row0 + r) * stride +
                                                   k0 + k));
      const TG* v = reinterpret_cast<const TG*>(&raw);
      TS* dst = s + r * kLd + k;
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[j] = Cvt<TS>::from(v[j]);
    }
  } else {
    constexpr int kPer = kTile / kVec;
    for (int i = threadIdx.x; i < kBK * kPer; i += kThreads) {
      const int k = i / kPer;
      const int r = (i % kPer) * kVec;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (row0 + r < row_end && k0 + k < k_end)
        raw = __ldg(reinterpret_cast<const uint4*>(g + static_cast<size_t>(k0 + k) * stride +
                                                   row0 + r));
      const TG* v = reinterpret_cast<const TG*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) s[(r + j) * kLd + k] = Cvt<TS>::from(v[j]);
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b for one m16n8k16 tile: a 16x16 row-major, b 16x8 column-major.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A[wm*16 .. +16, :] x B[wn*32 .. +32, :]^T over the staged depth.
// Accumulator layout (the mma.sync one, also used by the f32 path):
// acc[nt][0..1] are tile row wm*16 + g, columns wn*32 + nt*8 + 2t + {0,1};
// acc[nt][2..3] are row wm*16 + g + 8, the same columns.
__device__ __forceinline__ void warp_product(float (&acc)[4][4], const __nv_bfloat16* as,
                                             const __nv_bfloat16* bs, int wm, int wn, int g,
                                             int t) {
  constexpr int kLd = Smem<__nv_bfloat16>::kLd;
  const uint16_t* a = reinterpret_cast<const uint16_t*>(as) + (wm * 16 + g) * kLd + 2 * t;
  const uint16_t* b = reinterpret_cast<const uint16_t*>(bs) + (wn * 32 + g) * kLd + 2 * t;
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 16) {
    uint32_t af[4];
    af[0] = ld32(a + ks);
    af[1] = ld32(a + 8 * kLd + ks);
    af[2] = ld32(a + ks + 8);
    af[3] = ld32(a + 8 * kLd + ks + 8);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint16_t* bp = b + nt * 8 * kLd + ks;
      mma_bf16(acc[nt], af, ld32(bp), ld32(bp + 8));
    }
  }
}

__device__ __forceinline__ void warp_product(float (&acc)[4][4], const float* as,
                                             const float* bs, int wm, int wn, int g, int t) {
  constexpr int kLd = Smem<float>::kLd;
  const float* a = as + (wm * 16 + g) * kLd;
  const float* b = bs + (wn * 32 + 2 * t) * kLd;
#pragma unroll 4
  for (int k = 0; k < kBK; ++k) {
    const float a0 = a[k];
    const float a1 = a[8 * kLd + k];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float b0 = b[nt * 8 * kLd + k];
      const float b1 = b[(nt * 8 + 1) * kLd + k];
      acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
      acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
      acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
      acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
    }
  }
}

struct Lane {
  int wm, wn, g, t;
  __device__ Lane() {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    wm = warp & 3;
    wn = warp >> 2;
    g = lane >> 2;
    t = lane & 3;
  }
  // tile coordinates of accumulator element (nt, j)
  __device__ int row(int j) const { return wm * 16 + g + (j >= 2 ? 8 : 0); }
  __device__ int col(int nt, int j) const { return wn * 32 + nt * 8 + 2 * t + (j & 1); }
};

template <typename TS>
struct Tiles {
  TS a[kTile * Smem<TS>::kLd];
  TS b0[kTile * Smem<TS>::kLd];
  TS b1[kTile * Smem<TS>::kLd];
  TS b2[kTile * Smem<TS>::kLd];
};

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
}

// mu and pre (without biases) of component k for rows r0.., features e0..:
// the one recompute shared by the forward and the backward, so both round
// and sum identically.
template <typename TS>
__device__ __forceinline__ void component_products(float (&mu)[4][4], float (&pre)[4][4],
                                                   Tiles<TS>& sm, const float* x, const TS* wm,
                                                   const TS* ws, int k, int r0, int e0,
                                                   int rows, int d, int k_total,
                                                   const Lane& ln) {
  zero(mu);
  zero(pre);
  const size_t wstride = static_cast<size_t>(k_total) * d;
  for (int c0 = 0; c0 < d; c0 += kBK) {
    stage<float, TS, true>(sm.a, x, d, r0, rows, c0, d);
    stage<TS, TS, true>(sm.b0, wm + static_cast<size_t>(k) * d, wstride, e0, d, c0, d);
    stage<TS, TS, true>(sm.b1, ws + static_cast<size_t>(k) * d, wstride, e0, d, c0, d);
    __syncthreads();
    warp_product(mu, sm.a, sm.b0, ln.wm, ln.wn, ln.g, ln.t);
    warp_product(pre, sm.a, sm.b1, ln.wm, ln.wn, ln.g, ln.t);
    __syncthreads();
  }
}

__device__ __forceinline__ float sigma_of(float pre) {
  return (pre > 0.f ? pre + 1.f : expf(pre)) + 1e-15f;
}

// ---- B2: forward -------------------------------------------------------------

template <typename TS>
__global__ void __launch_bounds__(kThreads)
gmm_forward_kernel(const float* __restrict__ x, const float* __restrict__ lp,
                   const TS* __restrict__ wm, const TS* __restrict__ ws,
                   const float* __restrict__ bm, const float* __restrict__ bs,
                   float* __restrict__ ll, int rows, int d, int k_total) {
  __shared__ __align__(16) Tiles<TS> sm;
  const Lane ln;
  const int r0 = blockIdx.x * kTile;
  const int e0 = blockIdx.y * kTile;
  const int ra = r0 + ln.row(0), rb = r0 + ln.row(2);

  float xv[4][4], m[4][4], s[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = j < 2 ? ra : rb;
      xv[nt][j] = r < rows ? x[static_cast<size_t>(r) * d + e0 + ln.col(nt, j)] : 0.f;
      m[nt][j] = kNegBig;
      s[nt][j] = 0.f;
    }

  float mu[4][4], pre[4][4];
  for (int k = 0; k < k_total; ++k) {
    component_products(mu, pre, sm, x, wm, ws, k, r0, e0, rows, d, k_total, ln);
    const float lpa = ra < rows ? lp[static_cast<size_t>(ra) * k_total + k] : 0.f;
    const float lpb = rb < rows ? lp[static_cast<size_t>(rb) * k_total + k] : 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t bi = static_cast<size_t>(e0 + ln.col(nt, j)) * k_total + k;
        const float mu_ = mu[nt][j] + bm[bi];
        const float sigma = sigma_of(pre[nt][j] + bs[bi]);
        const float z = (xv[nt][j] - mu_) / sigma;
        const float dens = -logf(sigma) - kHalfLog2Pi - 0.5f * (z * z);
        const float tv = dens + (j < 2 ? lpa : lpb);
        const float m_new = fmaxf(m[nt][j], tv);
        s[nt][j] = s[nt][j] * expf(m[nt][j] - m_new) + expf(tv - m_new);
        m[nt][j] = m_new;
      }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = j < 2 ? ra : rb;
      if (r < rows)
        ll[static_cast<size_t>(r) * d + e0 + ln.col(nt, j)] = m[nt][j] + logf(s[nt][j]);
    }
}

// ---- B3, part 1: per-component gradient terms ---------------------------------

template <typename TS>
__global__ void __launch_bounds__(kThreads)
gmm_terms_kernel(const float* __restrict__ x, const float* __restrict__ lp,
                 const float* __restrict__ gin, const float* __restrict__ llin,
                 const TS* __restrict__ wm, const TS* __restrict__ ws,
                 const float* __restrict__ bm, const float* __restrict__ bs, int k0, int kc,
                 TS* __restrict__ dmu_out, TS* __restrict__ dpre_out,
                 float* __restrict__ bmu_part, float* __restrict__ bsig_part,
                 float* __restrict__ dlp_part, float* __restrict__ dmu_sum, int rows, int d,
                 int k_total) {
  __shared__ __align__(16) Tiles<TS> sm;
  __shared__ float red_col[2][4][kTile];  // [dmu|dpre][warp row][column]
  __shared__ float red_row[2][kTile];     // [warp column][row]
  const Lane ln;
  const int r0 = blockIdx.x * kTile;
  const int e0 = blockIdx.y * kTile;
  const int ra = r0 + ln.row(0), rb = r0 + ln.row(2);

  float dsum[4][4];
  zero(dsum);
  float mu[4][4], pre[4][4];
  for (int kk = 0; kk < kc; ++kk) {
    const int k = k0 + kk;
    component_products(mu, pre, sm, x, wm, ws, k, r0, e0, rows, d, k_total, ln);
    const float lpa = ra < rows ? lp[static_cast<size_t>(ra) * k_total + k] : 0.f;
    const float lpb = rb < rows ? lp[static_cast<size_t>(rb) * k_total + k] : 0.f;
    const size_t out0 = static_cast<size_t>(kk) * rows * d;
    float cm[4][2] = {}, cs[4][2] = {};
    float qa = 0.f, qb = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j < 2 ? ra : rb;
        const int e = e0 + ln.col(nt, j);
        const size_t bi = static_cast<size_t>(e) * k_total + k;
        float dmu = 0.f, dpre = 0.f, q = 0.f;
        if (r < rows) {
          const size_t xi = static_cast<size_t>(r) * d + e;
          const float pre_ = pre[nt][j] + bs[bi];
          const float mu_ = mu[nt][j] + bm[bi];
          const float sigma = sigma_of(pre_);
          const float z = (x[xi] - mu_) / sigma;
          const float dens = -logf(sigma) - kHalfLog2Pi - 0.5f * (z * z);
          q = gin[xi] * expf(dens + (j < 2 ? lpa : lpb) - llin[xi]);
          dmu = q * z / sigma;
          dpre = q * ((z * z - 1.f) / sigma) * (pre_ > 0.f ? 1.f : expf(pre_));
          dmu_out[out0 + xi] = Cvt<TS>::from(dmu);
          dpre_out[out0 + xi] = Cvt<TS>::from(dpre);
        }
        cm[nt][j & 1] += dmu;
        cs[nt][j & 1] += dpre;
        if (j < 2) qa += q; else qb += q;
        dsum[nt][j] += dmu;
      }
    // bias partials: sum over this warp's 16 rows (lane bits 2..4), then over
    // the four warp rows in order
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a = cm[nt][h], b = cs[nt][h];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, off);
          b += __shfl_xor_sync(0xffffffffu, b, off);
        }
        if (ln.g == 0) {
          red_col[0][ln.wm][ln.col(nt, h)] = a;
          red_col[1][ln.wm][ln.col(nt, h)] = b;
        }
      }
    // d log_pi partials: sum over this warp's 32 columns (lane bits 0..1),
    // then over the two warp columns
    qa += __shfl_xor_sync(0xffffffffu, qa, 1);
    qa += __shfl_xor_sync(0xffffffffu, qa, 2);
    qb += __shfl_xor_sync(0xffffffffu, qb, 1);
    qb += __shfl_xor_sync(0xffffffffu, qb, 2);
    if (ln.t == 0) {
      red_row[ln.wn][ln.row(0)] = qa;
      red_row[ln.wn][ln.row(2)] = qb;
    }
    __syncthreads();
    const int i = threadIdx.x;
    if (i < kTile) {
      const size_t pi = (static_cast<size_t>(blockIdx.x) * k_total + k) * d + e0 + i;
      bmu_part[pi] = ((red_col[0][0][i] + red_col[0][1][i]) + red_col[0][2][i]) + red_col[0][3][i];
      bsig_part[pi] = ((red_col[1][0][i] + red_col[1][1][i]) + red_col[1][2][i]) + red_col[1][3][i];
    } else if (i < 2 * kTile && r0 + i - kTile < rows) {
      const int r = r0 + i - kTile;
      dlp_part[(static_cast<size_t>(blockIdx.y) * rows + r) * k_total + k] =
          red_row[0][i - kTile] + red_row[1][i - kTile];
    }
    __syncthreads();
  }
  if (dmu_sum != nullptr) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j < 2 ? ra : rb;
        if (r < rows) {
          const size_t xi = static_cast<size_t>(r) * d + e0 + ln.col(nt, j);
          dmu_sum[xi] = (k0 == 0 ? 0.f : dmu_sum[xi]) + dsum[nt][j];
        }
      }
  }
}

// ---- B3, part 2: weight gradients ----------------------------------------------

// Block (64 input features i, 64 output features e, component k0 + z):
// dW[k][e, i] = sum_r dterm[r, e] xm[r, i], contracting over every row.
template <typename TS>
__global__ void __launch_bounds__(kThreads)
gmm_wgrad_kernel(const float* __restrict__ x, const TS* __restrict__ dmu,
                 const TS* __restrict__ dpre, float* __restrict__ dwm,
                 float* __restrict__ dws, int k0, int rows, int d, int k_total) {
  __shared__ __align__(16) Tiles<TS> sm;
  const Lane ln;
  const int i0 = blockIdx.x * kTile;
  const int e0 = blockIdx.y * kTile;
  const int kk = blockIdx.z;
  const int k = k0 + kk;
  const size_t off = static_cast<size_t>(kk) * rows * d;
  float am[4][4], as[4][4];
  zero(am);
  zero(as);
  for (int c0 = 0; c0 < rows; c0 += kBK) {
    stage<float, TS, false>(sm.a, x, d, i0, d, c0, rows);
    stage<TS, TS, false>(sm.b0, dmu + off, d, e0, d, c0, rows);
    stage<TS, TS, false>(sm.b1, dpre + off, d, e0, d, c0, rows);
    __syncthreads();
    warp_product(am, sm.a, sm.b0, ln.wm, ln.wn, ln.g, ln.t);
    warp_product(as, sm.a, sm.b1, ln.wm, ln.wn, ln.g, ln.t);
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t o =
          (static_cast<size_t>(e0 + ln.col(nt, j)) * k_total + k) * d + i0 + ln.row(j);
      dwm[o] = am[nt][j];
      dws[o] = as[nt][j];
    }
}

// ---- B4: feature gradient ---------------------------------------------------------

// Block (64 rows, 64 input features i) over the chunk's components:
// dx[r, i] (+)= sum_k sum_e dmu[k][r, e] Wmu[k][e, i] + dpre[k][r, e] Wsig[k][e, i],
// minus sum_k dmu[r, i] on the last chunk.
template <typename TS>
__global__ void __launch_bounds__(kThreads)
gmm_bwd_x_kernel(const TS* __restrict__ dmu, const TS* __restrict__ dpre,
                 const TS* __restrict__ wm, const TS* __restrict__ ws,
                 const float* __restrict__ dmu_sum, float* __restrict__ dx, int k0, int kc,
                 int first, int last, int rows, int d, int k_total) {
  __shared__ __align__(16) Tiles<TS> sm;
  const Lane ln;
  const int r0 = blockIdx.x * kTile;
  const int i0 = blockIdx.y * kTile;
  const size_t wstride = static_cast<size_t>(k_total) * d;
  float acc[4][4];
  zero(acc);
  for (int kk = 0; kk < kc; ++kk) {
    const size_t off = static_cast<size_t>(kk) * rows * d;
    const size_t woff = static_cast<size_t>(k0 + kk) * d;
    for (int c0 = 0; c0 < d; c0 += kBK) {
      stage<TS, TS, true>(sm.a, dmu + off, d, r0, rows, c0, d);
      stage<TS, TS, false>(sm.b0, wm + woff, wstride, i0, d, c0, d);
      stage<TS, TS, true>(sm.b2, dpre + off, d, r0, rows, c0, d);
      stage<TS, TS, false>(sm.b1, ws + woff, wstride, i0, d, c0, d);
      __syncthreads();
      warp_product(acc, sm.a, sm.b0, ln.wm, ln.wn, ln.g, ln.t);
      warp_product(acc, sm.b2, sm.b1, ln.wm, ln.wn, ln.g, ln.t);
      __syncthreads();
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + ln.row(j);
      if (r < rows) {
        const size_t o = static_cast<size_t>(r) * d + i0 + ln.col(nt, j);
        float v = (first ? 0.f : dx[o]) + acc[nt][j];
        if (last) v -= dmu_sum[o];
        dx[o] = v;
      }
    }
}

bool bad_shape(int rows, int d, int k_total) {
  return rows < 1 || d < kTile || d % kTile != 0 || d / kTile > 65535 || k_total < 1;
}

int status(cudaStream_t) { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Plain C entry points, bound with ctypes. Every pointer is a contiguous,
// 16-byte aligned device buffer in the layouts of the header; weights are
// bf16 when is_bf16 != 0, else f32; every other buffer is f32 except the
// dmu/dpre scratch, which is in the weights' type. Each launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).

extern "C" int gmm_forward(const void* x, const void* log_pi, const void* w_mu,
                           const void* w_sigma, const void* b_mu, const void* b_sigma,
                           void* ll, int rows, int d, int k_total, int is_bf16, int device,
                           void* stream) {
  if (bad_shape(rows, d, k_total)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + kTile - 1) / kTile, d / kTile);
  const float* xf = static_cast<const float*>(x);
  const float* lp = static_cast<const float*>(log_pi);
  const float* bm = static_cast<const float*>(b_mu);
  const float* bs = static_cast<const float*>(b_sigma);
  if (is_bf16)
    gmm_forward_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        xf, lp, static_cast<const __nv_bfloat16*>(w_mu),
        static_cast<const __nv_bfloat16*>(w_sigma), bm, bs, static_cast<float*>(ll), rows, d,
        k_total);
  else
    gmm_forward_kernel<float><<<grid, kThreads, 0, st>>>(
        xf, lp, static_cast<const float*>(w_mu), static_cast<const float*>(w_sigma), bm, bs,
        static_cast<float*>(ll), rows, d, k_total);
  return status(st);
}

extern "C" int gmm_backward_terms(const void* x, const void* log_pi, const void* g,
                                  const void* ll, const void* w_mu, const void* w_sigma,
                                  const void* b_mu, const void* b_sigma, int k0, int kc,
                                  void* dmu, void* dpre, void* bmu_part, void* bsig_part,
                                  void* dlp_part, void* dmu_sum, int rows, int d, int k_total,
                                  int is_bf16, int device, void* stream) {
  if (bad_shape(rows, d, k_total) || k0 < 0 || kc < 1 || k0 + kc > k_total)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + kTile - 1) / kTile, d / kTile);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (is_bf16)
    gmm_terms_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        f(x), f(log_pi), f(g), f(ll), static_cast<const __nv_bfloat16*>(w_mu),
        static_cast<const __nv_bfloat16*>(w_sigma), f(b_mu), f(b_sigma), k0, kc,
        static_cast<__nv_bfloat16*>(dmu), static_cast<__nv_bfloat16*>(dpre),
        static_cast<float*>(bmu_part), static_cast<float*>(bsig_part),
        static_cast<float*>(dlp_part), static_cast<float*>(dmu_sum), rows, d, k_total);
  else
    gmm_terms_kernel<float><<<grid, kThreads, 0, st>>>(
        f(x), f(log_pi), f(g), f(ll), f(w_mu), f(w_sigma), f(b_mu), f(b_sigma), k0, kc,
        static_cast<float*>(dmu), static_cast<float*>(dpre), static_cast<float*>(bmu_part),
        static_cast<float*>(bsig_part), static_cast<float*>(dlp_part),
        static_cast<float*>(dmu_sum), rows, d, k_total);
  return status(st);
}

extern "C" int gmm_backward_weights(const void* x, const void* dmu, const void* dpre,
                                    void* dw_mu, void* dw_sigma, int k0, int kc, int rows,
                                    int d, int k_total, int is_bf16, int device, void* stream) {
  if (bad_shape(rows, d, k_total) || k0 < 0 || kc < 1 || kc > 65535 || k0 + kc > k_total)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(d / kTile, d / kTile, kc);
  if (is_bf16)
    gmm_wgrad_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(dmu),
        static_cast<const __nv_bfloat16*>(dpre), static_cast<float*>(dw_mu),
        static_cast<float*>(dw_sigma), k0, rows, d, k_total);
  else
    gmm_wgrad_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dmu),
        static_cast<const float*>(dpre), static_cast<float*>(dw_mu),
        static_cast<float*>(dw_sigma), k0, rows, d, k_total);
  return status(st);
}

extern "C" int gmm_backward_x(const void* dmu, const void* dpre, const void* w_mu,
                              const void* w_sigma, const void* dmu_sum, void* dx, int k0,
                              int kc, int first, int last, int rows, int d, int k_total,
                              int is_bf16, int device, void* stream) {
  if (bad_shape(rows, d, k_total) || k0 < 0 || kc < 1 || k0 + kc > k_total)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + kTile - 1) / kTile, d / kTile);
  if (is_bf16)
    gmm_bwd_x_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dmu), static_cast<const __nv_bfloat16*>(dpre),
        static_cast<const __nv_bfloat16*>(w_mu), static_cast<const __nv_bfloat16*>(w_sigma),
        static_cast<const float*>(dmu_sum), static_cast<float*>(dx), k0, kc, first, last, rows,
        d, k_total);
  else
    gmm_bwd_x_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(dmu), static_cast<const float*>(dpre),
        static_cast<const float*>(w_mu), static_cast<const float*>(w_sigma),
        static_cast<const float*>(dmu_sum), static_cast<float*>(dx), k0, kc, first, last, rows,
        d, k_total);
  return status(st);
}
