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
// bf16 the weight-gradient and dx products take dmu/dpre rounded to bf16, as
// the TPU kernel does.
//
// Layout: the weights are read in place in the reference nn.Linear layout
// [D*K, D_in]: row e*K + k is output feature e of component k, contiguous in
// D_in. Component k's [D_out, D_in] block is rows k, K+k, 2K+k, ... (row
// stride K*D_in). The biases [K, D] and log_pi [K, R] come component-major (a
// transpose in the wrapper, as the JAX wrapper does for log_pi); x, g, ll are
// [R, D] f32, x_m [R, D] bf16 (x rounded, under bf16). The backward keeps
// dmu/dpre of a chunk of components in a scratch [Kc, R, D] of the matmul
// type (the chunk bounds its size), the bias partials per 64-row tile
// [row tiles, K, D] and the d log_pi partials per 64-feature group
// [D/64, K, R]; the wrapper sums the partials in a fixed order (no atomics:
// the gradients are deterministic). The weight gradients are written in the
// Linear layout, f32.
//
// ---- bf16 (every CLI path): warp-specialised wgmma kernels behind TMA ----
//
// All four take 128-byte-swizzled TMA boxes of 64 bf16 x 64 rows
// (hopper_mma.cuh); one producer thread per block keeps the stages full
// (mbarrier transaction counts; rows past R arrive as zeros and are never
// stored), two consumer warpgroups run wgmma with f32 accumulators in
// registers, and setmaxnreg moves the producer warpgroup's registers to them.
// The weights are read in place through 3-D tensor maps [D_out, K, D_in] (k
// fixed by the box coordinate; strides D_in and K D_in elements).
//
//   B2  gmm_forward_wgmma_kernel  block (64 rows, 128 features): each consumer
//       warpgroup takes 64 features and runs wgmma m64n128k16 with x_m as A
//       and [Wmu[k]; Wsig[k]] of its features as one 128-row B operand, so mu
//       and pre of an element land in the same thread; a TMA ring per
//       warpgroup (a ring shared by both crashed: a parity wait on a barrier
//       two rounds ahead passes at once), filled in the order component,
//       warpgroup, 64-deep slice, so one warpgroup's epilogue runs under the
//       other's products. x rows resident in shared memory up to D = 1024,
//       above streamed with the weights. The density and a one-exp online
//       logsumexp stay in registers.
//   B3  gmm_terms_wgmma_kernel    the same block, tiles, slice order and
//       operands over the chunk's components, with another epilogue: per
//       component, from mu and pre in registers, sigma, z, the density, q,
//       dmu and dpre; dmu and dpre go to the scratch as bf16, the bias
//       partials are column sums over the block's 64 rows (a warp's 16 rows
//       by shuffles, then the four warps in order through the component's
//       last ring stage, released once they are read), the
//       d log_pi partials row sums over the warpgroup's 64 features, and,
//       when dx is wanted (a template flag: the frozen-trunk trainers pay
//       nothing for it), sum_k dmu stays in f32 registers across the chunk.
//       x stays in registers as in B2; g and ll too without the dx sum (the
//       frozen-trunk path), and with it are read again per component from
//       L2 (in registers there they spill and read 13-18% slower). dmu and
//       dpre leave by 4-byte stores from registers (through shared memory
//       and TMA stores they read no faster).
//   B3  gmm_wgrad_wgmma_kernel    persistent GEMM over tiles (component,
//       128 e, 128 i): dWmu[k][e, i] = sum_r dmu[k][r, e] xm[r, i] and the
//       same for dpre, contracting over all R rows in 64-row stages of
//       [dmu | dpre | xm] (48 KB, 4 stages). dmu, dpre (e contiguous) and xm
//       (i contiguous) are both MN-major operands: wgmma with both transpose
//       bits set. Each output element is written once, by one block.
//   B4  gmm_bwd_x_wgmma_kernel    block (128 rows, 256 i, a split of the
//       chunk's components): dx[r, i] = sum_k sum_e dmu[k][r, e] Wmu[k][e, i]
//       + dpre Wsig, both products into one 64 x 256 accumulator a
//       warpgroup, one product per stage of 64 e ([dmu or dpre] K-major,
//       [Wmu or Wsig] MN-major through the 3-D maps: 48 KB, 4 stages; 128-wide
//       tiles with both products in a 64 KB stage read 1.4-1.6x slower).
//       Where row tiles x feature tiles fill the card poorly (784 rows at
//       D = 2048: 56 blocks for 132 SMs), the wrapper splits the chunk's
//       components into `splits` ranges, each into its own partial dx;
//       `gmm_dx_reduce_kernel` adds them in order with the dx of the chunks
//       before and, on the last chunk, the direct term -sum_k dmu.
//
// Rounding: the terms kernel recomputes mu and pre with B2's tiles, operand
// order and wgmma sequence, and its density with B2's code (`log_term`), so
// the ll B3 reads is the logsumexp of its own terms: q = g exp(tv - ll) with
// exp(tv - ll) <= 1, as the JAX docstring says (gmm_train.py:81).
//
// ---- f32 (the f32 numerics policy): the first kernels ----
//
// A 64x64 output tile per block of 8 warps (4 x 2, 16 x 32 each), the
// contraction staged 32 deep through shared memory, products by f32 FMA in
// the mma.sync register layout (TF32 stays off); the output features are
// always tiled by 64.
//   gmm_forward_kernel   (B2)  block (64 rows, 64 e): loops over K.
//   gmm_terms_kernel     (B3)  block (64 rows, 64 e), a chunk of components:
//                              the partials and scratch of the bf16 kernel.
//   gmm_wgrad_kernel     (B3)  block (64 d_in, 64 e, one component).
//   gmm_bwd_x_kernel     (B4)  block (64 rows, 64 d_in) over the chunk.
//
// Why a scratch: the dW accumulator cannot stay resident across the row sweep
// as it did in the TPU's 16 MB of VMEM (a [768, 256] f32 block is 768 KB; an
// SM has 228 KB), so dmu/dpre go through device memory per chunk instead of
// recomputing mu/pre once per D_in tile (D/64 = 12 times the recompute).
// Cost per train step at R rows: 4 R D^2 K FLOP each for the forward, the
// recompute and the weight gradients (+1 for dx), and 2 x 2 x R D K x 2
// bytes of bf16 scratch written and read.
//
// What bounds them on the H100: operations. At the DeiT train step's 12,544
// rows, D = 768, K = 150 each set of two products is 4.4 TFLOP (4.5 ms at the
// 989 TFLOP/s bf16 peak); the scratch is 5.8 GB written and read (1.7 ms at
// 3.35 TB/s each way), under the products. Measured numbers: PERF.md §6.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"
#include "launch_common.cuh"
#include "tensor_map.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kBK = 32;
constexpr int kLd = kBK + 4;  // f32 row pitch of a staged slice
constexpr float kHalfLog2Pi = 0.918938533204672742f;
constexpr float kNegBig = -1e30f;

// log N(x; mu, sigma) + lp from mu and pre with biases, as B2's bf16 kernel
// computes it (fast intrinsics); B3's bf16 recompute calls the same code.
// Returns the term and leaves sigma and z for the gradients.
__device__ __forceinline__ float log_term(float x, float mu, float pre, float lp, float& sigma,
                                          float& z) {
  sigma = (pre > 0.f ? pre + 1.f : __expf(pre)) + 1e-15f;
  z = __fdividef(x - mu, sigma);
  return (-__logf(sigma) - kHalfLog2Pi - 0.5f * (z * z)) + lp;
}

// ---- f32: the first kernels ---------------------------------------------------

// Stage a 64 x kBK f32 slice of an operand into shared memory as [row][k] with
// row pitch kLd; zeros outside rows [0, row_end) and depth [0, k_end).
// KCONTIG: element (row, k) is g[row * stride + k]; otherwise
// g[k * stride + row]. 16-byte loads along the contiguous dimension, whose
// extent is a multiple of 64 (checked by the host), so a vector never
// straddles its end.
template <bool KCONTIG>
__device__ __forceinline__ void stage(float* s, const float* __restrict__ g, size_t stride,
                                      int row0, int row_end, int k0, int k_end) {
  constexpr int kVec = 4;
  if constexpr (KCONTIG) {
    constexpr int kPer = kBK / kVec;
    for (int i = threadIdx.x; i < kTile * kPer; i += kThreads) {
      const int r = i / kPer;
      const int k = (i % kPer) * kVec;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < row_end && k0 + k < k_end)
        v = __ldg(reinterpret_cast<const float4*>(g + static_cast<size_t>(row0 + r) * stride +
                                                  k0 + k));
      *reinterpret_cast<float4*>(s + r * kLd + k) = v;
    }
  } else {
    constexpr int kPer = kTile / kVec;
    for (int i = threadIdx.x; i < kBK * kPer; i += kThreads) {
      const int k = i / kPer;
      const int r = (i % kPer) * kVec;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < row_end && k0 + k < k_end)
        v = __ldg(reinterpret_cast<const float4*>(g + static_cast<size_t>(k0 + k) * stride +
                                                  row0 + r));
      s[r * kLd + k] = v.x;
      s[(r + 1) * kLd + k] = v.y;
      s[(r + 2) * kLd + k] = v.z;
      s[(r + 3) * kLd + k] = v.w;
    }
  }
}

// acc += A[wm*16 .. +16, :] x B[wn*32 .. +32, :]^T over the staged depth, by
// FMA. Accumulator layout (that of an m16n8 MMA tile): acc[nt][0..1] are tile
// row wm*16 + g, columns wn*32 + nt*8 + 2t + {0,1}; acc[nt][2..3] are row
// wm*16 + g + 8, the same columns.
__device__ __forceinline__ void warp_product(float (&acc)[4][4], const float* as,
                                             const float* bs, int wm, int wn, int g, int t) {
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

struct Tiles {
  float a[kTile * kLd];
  float b0[kTile * kLd];
  float b1[kTile * kLd];
  float b2[kTile * kLd];
};

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
}

// mu and pre (without biases) of component k for rows r0.., features e0..:
// the one recompute shared by the f32 forward and backward, so both sum
// identically.
__device__ __forceinline__ void component_products(float (&mu)[4][4], float (&pre)[4][4],
                                                   Tiles& sm, const float* x, const float* wm,
                                                   const float* ws, int k, int r0, int e0,
                                                   int rows, int d, int k_total,
                                                   const Lane& ln) {
  zero(mu);
  zero(pre);
  const size_t wstride = static_cast<size_t>(k_total) * d;
  for (int c0 = 0; c0 < d; c0 += kBK) {
    stage<true>(sm.a, x, d, r0, rows, c0, d);
    stage<true>(sm.b0, wm + static_cast<size_t>(k) * d, wstride, e0, d, c0, d);
    stage<true>(sm.b1, ws + static_cast<size_t>(k) * d, wstride, e0, d, c0, d);
    __syncthreads();
    warp_product(mu, sm.a, sm.b0, ln.wm, ln.wn, ln.g, ln.t);
    warp_product(pre, sm.a, sm.b1, ln.wm, ln.wn, ln.g, ln.t);
    __syncthreads();
  }
}

__device__ __forceinline__ float sigma_of(float pre) {
  return (pre > 0.f ? pre + 1.f : expf(pre)) + 1e-15f;
}

// bm, bs [K, D] and lp [K, R]: the component-major copies the wrapper makes.
__global__ void __launch_bounds__(kThreads)
gmm_forward_kernel(const float* __restrict__ x, const float* __restrict__ lp,
                   const float* __restrict__ wm, const float* __restrict__ ws,
                   const float* __restrict__ bm, const float* __restrict__ bs,
                   float* __restrict__ ll, int rows, int d, int k_total) {
  __shared__ __align__(16) Tiles sm;
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
    const float lpa = ra < rows ? lp[static_cast<size_t>(k) * rows + ra] : 0.f;
    const float lpb = rb < rows ? lp[static_cast<size_t>(k) * rows + rb] : 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t bi = static_cast<size_t>(k) * d + e0 + ln.col(nt, j);
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

// B3, part 1 under f32: block (64 rows, 64 e) over a chunk of components.
// Writes dmu/dpre to the scratch [Kc, R, D], the bias partials
// [row tiles, K, D], the d log_pi partials [D/64, K, R] and, when dmu_sum is
// not null, sum_k dmu (added to what earlier chunks left when k0 > 0).
__global__ void __launch_bounds__(kThreads)
gmm_terms_kernel(const float* __restrict__ x, const float* __restrict__ lp,
                 const float* __restrict__ gin, const float* __restrict__ llin,
                 const float* __restrict__ wm, const float* __restrict__ ws,
                 const float* __restrict__ bm, const float* __restrict__ bs, int k0, int kc,
                 float* __restrict__ dmu_out, float* __restrict__ dpre_out,
                 float* __restrict__ bmu_part, float* __restrict__ bsig_part,
                 float* __restrict__ dlp_part, float* __restrict__ dmu_sum, int rows, int d,
                 int k_total) {
  __shared__ __align__(16) Tiles sm;
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
    const float lpa = ra < rows ? lp[static_cast<size_t>(k) * rows + ra] : 0.f;
    const float lpb = rb < rows ? lp[static_cast<size_t>(k) * rows + rb] : 0.f;
    const size_t out0 = static_cast<size_t>(kk) * rows * d;
    float cm[4][2] = {}, cs[4][2] = {};
    float qa = 0.f, qb = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j < 2 ? ra : rb;
        const int e = e0 + ln.col(nt, j);
        const size_t bi = static_cast<size_t>(k) * d + e;
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
          dmu_out[out0 + xi] = dmu;
          dpre_out[out0 + xi] = dpre;
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
      dlp_part[(static_cast<size_t>(blockIdx.y) * k_total + k) * rows + r] =
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

// B3, part 2 under f32: block (64 input features i, 64 output features e,
// component k0 + z): dW[k][e, i] = sum_r dterm[r, e] x[r, i] over every row.
__global__ void __launch_bounds__(kThreads)
gmm_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dmu,
                 const float* __restrict__ dpre, float* __restrict__ dwm,
                 float* __restrict__ dws, int k0, int rows, int d, int k_total) {
  __shared__ __align__(16) Tiles sm;
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
    stage<false>(sm.a, x, d, i0, d, c0, rows);
    stage<false>(sm.b0, dmu + off, d, e0, d, c0, rows);
    stage<false>(sm.b1, dpre + off, d, e0, d, c0, rows);
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

// B4 under f32: block (64 rows, 64 input features i) over the chunk:
// dx[r, i] (+)= sum_k sum_e dmu[k][r, e] Wmu[k][e, i] + dpre[k][r, e] Wsig[k][e, i],
// minus sum_k dmu[r, i] on the last chunk.
__global__ void __launch_bounds__(kThreads)
gmm_bwd_x_kernel(const float* __restrict__ dmu, const float* __restrict__ dpre,
                 const float* __restrict__ wm, const float* __restrict__ ws,
                 const float* __restrict__ dmu_sum, float* __restrict__ dx, int k0, int kc,
                 int first, int last, int rows, int d, int k_total) {
  __shared__ __align__(16) Tiles sm;
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
      stage<true>(sm.a, dmu + off, d, r0, rows, c0, d);
      stage<false>(sm.b0, wm + woff, wstride, i0, d, c0, d);
      stage<true>(sm.b2, dpre + off, d, r0, rows, c0, d);
      stage<false>(sm.b1, ws + woff, wstride, i0, d, c0, d);
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
// ---- bf16: wgmma behind TMA ----------------------------------------------------

namespace wg {

using namespace vitad_hopper;

constexpr int kRows = 64;             // feature rows of a block: one wgmma M
constexpr int kHalf = 64;             // output features of a consumer warpgroup
constexpr int kConsumers = 2;         // warpgroups; the third holds the producer thread
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBoxBytes = 64 * 64 * 2;  // one TMA box: 64 rows x 64 bf16 (128 bytes)
constexpr int kMaxStages = 6;           // per consumer warpgroup
// x [64, D] stays in shared memory up to this width (128 KB) beside two rings
// of at least 3 stages; wider, every stage brings its own 64-deep slice of x.
constexpr int kMaxResidentDim = 1024;


// The producer thread's loop: for each component k in [k_begin, k_end) and
// each warpgroup w < halves, the n_ks 64-deep slices of [Wmu[k]; Wsig[k]] for
// w's 64 features (and, streamed, the slice of x) into w's ring.
template <bool kResidentX>
__device__ __forceinline__ void fill_rings(const CUtensorMap& map_wm, const CUtensorMap& map_ws,
                                           const CUtensorMap& map_x, uint32_t rings,
                                           uint32_t full, uint32_t empty, int k_begin, int k_end,
                                           int halves, int n_ks, int n_stages, int e0, int r0) {
  constexpr uint32_t kStageBytes = (kResidentX ? 2 : 3) * kBoxBytes;
  int slot0 = 0, slot1 = 0;
  uint32_t phase0 = 1, phase1 = 1;  // fresh empty barriers let the first round pass
  for (int k = k_begin; k < k_end; ++k)
    for (int w = 0; w < halves; ++w) {
      int slot = w ? slot1 : slot0;
      uint32_t phase = w ? phase1 : phase0;
      const int ring = w * n_stages;
      for (int ks = 0; ks < n_ks; ++ks) {
        barrier_wait(empty + 8 * (ring + slot), phase);
        const uint32_t bar = full + 8 * (ring + slot);
        const uint32_t stage = rings + (ring + slot) * kStageBytes;
        barrier_arrive_expect(bar, kStageBytes);
        tma_load_3d(stage, &map_wm, bar, 64 * ks, k, e0 + kHalf * w);
        tma_load_3d(stage + kBoxBytes, &map_ws, bar, 64 * ks, k, e0 + kHalf * w);
        if (!kResidentX) tma_load_2d(stage + 2 * kBoxBytes, &map_x, bar, 64 * ks, r0);
        if (++slot == n_stages) {
          slot = 0;
          phase ^= 1;
        }
      }
      if (w) {
        slot1 = slot;
        phase1 = phase;
      } else {
        slot0 = slot;
        phase0 = phase;
      }
    }
}

// A consumer warpgroup's products of one component: acc = x_m . [Wmu; Wsig]^T
// of its 64 features over the n_ks slices of its ring, one stage's four wgmma
// in flight behind the next. Returns the last stage, which the caller
// releases after wgmma_wait<0>.
template <bool kResidentX>
__device__ __forceinline__ int component_products(float (&acc)[64], uint32_t rings, uint32_t full,
                                                  uint32_t empty, uint32_t x_tile, int ring,
                                                  int n_ks, int n_stages, int& slot,
                                                  uint32_t& phase, int lane) {
  constexpr uint32_t kStageBytes = (kResidentX ? 2 : 3) * kBoxBytes;
  int held = 0;  // the stage whose products may still be running
  for (int ks = 0; ks < n_ks; ++ks) {
    barrier_wait(full + 8 * (ring + slot), phase);
    const uint32_t stage = rings + (ring + slot) * kStageBytes;
    const uint64_t desc_a =
        operand_descriptor(kResidentX ? x_tile + ks * kBoxBytes : stage + 2 * kBoxBytes);
    const uint64_t desc_b = operand_descriptor(stage);
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)  // 32 bytes along D_in = 2 descriptor units
      wgmma_m64n128k16(acc, desc_a + 2 * jj, desc_b + 2 * jj, (ks | jj) != 0);
    wgmma_commit();
    wgmma_wait<1>();  // the stage before this one has been read: release it
    if (ks > 0 && lane == 0) barrier_arrive(empty + 8 * (ring + held));
    held = slot;
    if (++slot == n_stages) {
      slot = 0;
      phase ^= 1;
    }
  }
  return held;
}

// Block (64 rows r0.., 128 output features e0..): consumer warpgroup w takes
// the features e0 + 64 w .. + 64 (the last block of an odd D / 64 has one).
// Each warpgroup has its own ring: for each component k and each 64-deep
// slice ks of D_in, a stage holds [Wmu[k][64 rows, ks]; Wsig[k][64 rows, ks]]
// as one 128-row B operand (and, streamed, the slice of x). The producer fills
// the rings in the order k, then warpgroup, then ks, so warpgroup 1's products
// of component k follow warpgroup 0's, and each warpgroup's epilogue of k runs
// while the other's products run. (One ring shared in that order would let a
// warpgroup's next stage lie two rounds of a barrier ahead, which a parity
// wait cannot tell from the round before.)
template <bool kResidentX>
__global__ void __launch_bounds__(kThreads, 1)
gmm_forward_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_wm,
                         const __grid_constant__ CUtensorMap map_ws,
                         const float* __restrict__ x, const float* __restrict__ lp,
                         const float* __restrict__ bm, const float* __restrict__ bs,
                         float* __restrict__ ll, int rows, int d, int k_total, int n_stages) {
  constexpr uint32_t kStageBytes = (kResidentX ? 2 : 3) * kBoxBytes;
  extern __shared__ unsigned char smem_raw[];
  const int n_ks = d / 64;
  const uint32_t x_tile = (shared_address(smem_raw) + 1023u) & ~1023u;  // resident x
  const uint32_t rings = x_tile + (kResidentX ? n_ks * kBoxBytes : 0);  // [warpgroup][stage]
  const uint32_t full = rings + kConsumers * n_stages * kStageBytes;   // producer -> consumer
  const uint32_t empty = full + 8 * kConsumers * n_stages;             // consumer -> producer
  const uint32_t x_full = empty + 8 * kConsumers * n_stages;           // the resident x landed
  const int r0 = blockIdx.x * kRows;
  const int e0 = blockIdx.y * (kConsumers * kHalf);
  const int halves = min(kConsumers, (d - e0) / kHalf);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kConsumers * n_stages; ++s) {
      barrier_init(full + 8 * s, 1);   // the producer's arrive.expect_tx
      barrier_init(empty + 8 * s, 4);  // lane 0 of each warp of the consuming warpgroup
    }
    barrier_init(x_full, 1);
    barrier_init_fence();
  }
  __syncthreads();
  const int warpgroup = threadIdx.x / 128;

  if (warpgroup == kConsumers) {
    registers_release<40>();
    if (threadIdx.x == 128 * kConsumers) {
      if (kResidentX) {
        barrier_arrive_expect(x_full, n_ks * kBoxBytes);
        for (int c = 0; c < n_ks; ++c)
          tma_load_2d(x_tile + c * kBoxBytes, &map_x, x_full, 64 * c, r0);
      }
      fill_rings<kResidentX>(map_wm, map_ws, map_x, rings, full, empty, 0, k_total, halves,
                             n_ks, n_stages, e0, r0);
    }
  } else {
    if (warpgroup >= halves) return;
    registers_acquire<232>();
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int eh = e0 + kHalf * warpgroup;
    const int ra = r0 + 16 * warp + g, rb = ra + 8;
    const int ring = warpgroup * n_stages;
    // Per thread 32 (row, feature) elements, i = 4 j + 2 h + c: row ra (h = 0)
    // or rb, feature eh + 8 j + 2 t + c (j < 8); mu is acc[i], pre acc[32 + i]
    // (the accumulator layout of wgmma_m64n128k16 over [Wmu rows; Wsig rows]).
    float xv[32], m[32], s[32];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? rb : ra;
        float2 v = make_float2(0.f, 0.f);
        if (r < rows)
          v = *reinterpret_cast<const float2*>(x + static_cast<size_t>(r) * d + eh + 8 * j + 2 * t);
        xv[4 * j + 2 * h] = v.x;
        xv[4 * j + 2 * h + 1] = v.y;
      }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      m[i] = kNegBig;
      s[i] = 0.f;
    }
    if (kResidentX) barrier_wait(x_full, 0);
    int slot = 0;
    uint32_t phase = 0;
    float acc[64];
    for (int k = 0; k < k_total; ++k) {
      const int held = component_products<kResidentX>(acc, rings, full, empty, x_tile, ring, n_ks,
                                                      n_stages, slot, phase, lane);
      // this component's biases and mixture weights, loaded while its last
      // products run
      const size_t bk = static_cast<size_t>(k) * d + eh;
      const float2* bm2p = reinterpret_cast<const float2*>(bm + bk) + t;
      const float2* bs2p = reinterpret_cast<const float2*>(bs + bk) + t;
      float2 bm2[8], bs2[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bm2[j] = __ldg(bm2p + 4 * j);
        bs2[j] = __ldg(bs2p + 4 * j);
      }
      const float lpa = ra < rows ? __ldg(lp + static_cast<size_t>(k) * rows + ra) : 0.f;
      const float lpb = rb < rows ? __ldg(lp + static_cast<size_t>(k) * rows + rb) : 0.f;
      wgmma_wait<0>();
      if (lane == 0) barrier_arrive(empty + 8 * (ring + held));
      accumulator_fence(acc);

      // density and online logsumexp, one exp per update: with
      // e = exp(-|tv - m|), s = s e + 1 when tv > m (and m = tv), else s + e,
      // which is s exp(m - m') + exp(tv - m') with one of the two factors 1
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = 4 * j + 2 * h + c;
            float sigma, z;
            const float tv = log_term(xv[i], acc[i] + (c ? bm2[j].y : bm2[j].x),
                                      acc[32 + i] + (c ? bs2[j].y : bs2[j].x), h ? lpb : lpa,
                                      sigma, z);
            const float e = __expf(-fabsf(tv - m[i]));
            if (tv > m[i]) {
              s[i] = s[i] * e + 1.f;
              m[i] = tv;
            } else {
              s[i] += e;
            }
          }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? rb : ra;
        const int i = 4 * j + 2 * h;
        if (r < rows)
          *reinterpret_cast<float2*>(ll + static_cast<size_t>(r) * d + eh + 8 * j + 2 * t) =
              make_float2(m[i] + logf(s[i]), m[i + 1] + logf(s[i + 1]));
      }
  }
}


// Elements (r, e) and (r, e + 1) of an [R, D] f32 array; zeros past R.
__device__ __forceinline__ float2 load_pair(const float* __restrict__ a, int r, int rows, int d,
                                            int e) {
  return r < rows ? __ldg(reinterpret_cast<const float2*>(a + static_cast<size_t>(r) * d + e))
                  : make_float2(0.f, 0.f);
}

// B3, part 1 under bf16: B2's block, rings, slice order and products over the
// chunk's components k0 .. k0 + kc - 1, with the gradient terms as epilogue.
// Writes dmu/dpre (bf16) to the scratch [Kc, R, D], the bias partials
// [row tiles, K, D], the d log_pi partials [D/64, K, R] (one per warpgroup's
// 64 features) and, with kSum, sum_k dmu (added to what earlier chunks left
// when k0 > 0).
template <bool kResidentX, bool kSum>
__global__ void __launch_bounds__(kThreads, 1)
gmm_terms_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_wm,
                       const __grid_constant__ CUtensorMap map_ws, const float* __restrict__ x,
                       const float* __restrict__ lp, const float* __restrict__ gin,
                       const float* __restrict__ llin, const float* __restrict__ bm,
                       const float* __restrict__ bs, int k0, int kc,
                       __nv_bfloat16* __restrict__ dmu_out, __nv_bfloat16* __restrict__ dpre_out,
                       float* __restrict__ bmu_part, float* __restrict__ bsig_part,
                       float* __restrict__ dlp_part, float* __restrict__ dmu_sum, int rows,
                       int d, int k_total, int n_stages) {
  constexpr uint32_t kStageBytes = (kResidentX ? 2 : 3) * kBoxBytes;
  extern __shared__ unsigned char smem_raw[];
  const int n_ks = d / 64;
  const uint32_t x_tile = (shared_address(smem_raw) + 1023u) & ~1023u;  // resident x
  const uint32_t rings = x_tile + (kResidentX ? n_ks * kBoxBytes : 0);  // [warpgroup][stage]
  const uint32_t full = rings + kConsumers * n_stages * kStageBytes;   // producer -> consumer
  const uint32_t empty = full + 8 * kConsumers * n_stages;             // consumer -> producer
  const uint32_t x_full = empty + 8 * kConsumers * n_stages;           // the resident x landed
  const int r0 = blockIdx.x * kRows;
  const int e0 = blockIdx.y * (kConsumers * kHalf);
  const int halves = min(kConsumers, (d - e0) / kHalf);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kConsumers * n_stages; ++s) {
      barrier_init(full + 8 * s, 1);   // the producer's arrive.expect_tx
      barrier_init(empty + 8 * s, 4);  // lane 0 of each warp of the consuming warpgroup
    }
    barrier_init(x_full, 1);
    barrier_init_fence();
  }
  __syncthreads();
  const int warpgroup = threadIdx.x / 128;

  if (warpgroup == kConsumers) {
    registers_release<40>();
    if (threadIdx.x == 128 * kConsumers) {
      if (kResidentX) {
        barrier_arrive_expect(x_full, n_ks * kBoxBytes);
        for (int c = 0; c < n_ks; ++c)
          tma_load_2d(x_tile + c * kBoxBytes, &map_x, x_full, 64 * c, r0);
      }
      fill_rings<kResidentX>(map_wm, map_ws, map_x, rings, full, empty, k0, k0 + kc, halves,
                             n_ks, n_stages, e0, r0);
    }
  } else {
    if (warpgroup >= halves) return;
    registers_acquire<232>();
    const int tid = threadIdx.x % 128;
    const int lane = threadIdx.x % 32;
    const int warp = tid / 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int eh = e0 + kHalf * warpgroup;
    const int ra = r0 + 16 * warp + g, rb = ra + 8;
    const int ring = warpgroup * n_stages;
    // Per thread 32 (row, feature) elements, i = 4 j + 2 h + c: row ra (h = 0)
    // or rb, feature eh + 8 j + 2 t + c (j < 8); mu is acc[i], pre acc[32 + i]
    // (the accumulator layout of wgmma_m64n128k16 over [Wmu rows; Wsig rows]).
    float xv[32];
    float dsum[kSum ? 32 : 1];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? rb : ra;
        float2 v = make_float2(0.f, 0.f);
        if (r < rows)
          v = *reinterpret_cast<const float2*>(x + static_cast<size_t>(r) * d + eh + 8 * j + 2 * t);
        xv[4 * j + 2 * h] = v.x;
        xv[4 * j + 2 * h + 1] = v.y;
      }
#pragma unroll
    for (int i = 0; i < (kSum ? 32 : 1); ++i) dsum[i] = 0.f;
    // g and ll: kept in registers across the chunk without the dx sum (no
    // spills at D = 768), read again per component from L2 beside it (kept,
    // they spill 264 bytes and read 13-18% slower at the ResNet shapes)
    constexpr int kHeld = kSum ? 1 : 32;
    float gr[kHeld], lr[kHeld];
    if constexpr (!kSum) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 gv = load_pair(gin, h ? rb : ra, rows, d, eh + 8 * j + 2 * t);
          const float2 lv = load_pair(llin, h ? rb : ra, rows, d, eh + 8 * j + 2 * t);
          gr[4 * j + 2 * h] = gv.x;
          gr[4 * j + 2 * h + 1] = gv.y;
          lr[4 * j + 2 * h] = lv.x;
          lr[4 * j + 2 * h + 1] = lv.y;
        }
    }
    if (kResidentX) barrier_wait(x_full, 0);
    int slot = 0;
    uint32_t phase = 0;
    float acc[64];
    for (int kk = 0; kk < kc; ++kk) {
      const int k = k0 + kk;
      const int held = component_products<kResidentX>(acc, rings, full, empty, x_tile, ring, n_ks,
                                                      n_stages, slot, phase, lane);
      const size_t bk = static_cast<size_t>(k) * d + eh;
      const float2* bm2p = reinterpret_cast<const float2*>(bm + bk) + t;
      const float2* bs2p = reinterpret_cast<const float2*>(bs + bk) + t;
      float2 bm2[8], bs2[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bm2[j] = __ldg(bm2p + 4 * j);
        bs2[j] = __ldg(bs2p + 4 * j);
      }
      const float lpa = ra < rows ? __ldg(lp + static_cast<size_t>(k) * rows + ra) : 0.f;
      const float lpb = rb < rows ? __ldg(lp + static_cast<size_t>(k) * rows + rb) : 0.f;
      wgmma_wait<0>();
      accumulator_fence(acc);
      // The component's last stage has been read; it stays held until the
      // column sums below have passed through it ([dmu | dpre][warp][feature]
      // floats, 2 KB of its 16), so no shared memory is set aside for them.
      const uint32_t held_stage = rings + (ring + held) * kStageBytes;
      float* red_wg =
          reinterpret_cast<float*>(smem_raw + (held_stage - shared_address(smem_raw)));

      // the terms, in place of mu and pre: acc[i] = dmu, acc[32 + i] = dpre
      float qa = 0.f, qb = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = h ? rb : ra;
          float2 gv, lv;
          if constexpr (kSum) {
            gv = load_pair(gin, r, rows, d, eh + 8 * j + 2 * t);
            lv = load_pair(llin, r, rows, d, eh + 8 * j + 2 * t);
          } else {
            gv = make_float2(gr[4 * j + 2 * h], gr[4 * j + 2 * h + 1]);
            lv = make_float2(lr[4 * j + 2 * h], lr[4 * j + 2 * h + 1]);
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = 4 * j + 2 * h + c;
            const float pre = acc[32 + i] + (c ? bs2[j].y : bs2[j].x);
            float sigma, z;
            const float tv = log_term(xv[i], acc[i] + (c ? bm2[j].y : bm2[j].x),
                                      pre, h ? lpb : lpa, sigma, z);
            float q = (c ? gv.y : gv.x) * __expf(tv - (c ? lv.y : lv.x));
            float dm = __fdividef(q * z, sigma);
            float dp = __fdividef(q * (z * z - 1.f), sigma) * (pre > 0.f ? 1.f : __expf(pre));
            if (r >= rows) q = dm = dp = 0.f;
            acc[i] = dm;
            acc[32 + i] = dp;
            if constexpr (kSum) dsum[i] += dm;
            if (h) qb += q; else qa += q;
          }
        }
      // dmu and dpre to the scratch, rounded to bf16
      const size_t out0 = static_cast<size_t>(kk) * rows * d;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = h ? rb : ra;
          const int i = 4 * j + 2 * h;
          if (r < rows) {
            const size_t o = out0 + static_cast<size_t>(r) * d + eh + 8 * j + 2 * t;
            *reinterpret_cast<__nv_bfloat162*>(dmu_out + o) =
                __floats2bfloat162_rn(acc[i], acc[i + 1]);
            *reinterpret_cast<__nv_bfloat162*>(dpre_out + o) =
                __floats2bfloat162_rn(acc[32 + i], acc[32 + i + 1]);
          }
        }
      // d log_pi partials: each row's sum over the 16 features of a thread,
      // then over the four lanes t
      qa += __shfl_xor_sync(0xffffffffu, qa, 1);
      qa += __shfl_xor_sync(0xffffffffu, qa, 2);
      qb += __shfl_xor_sync(0xffffffffu, qb, 1);
      qb += __shfl_xor_sync(0xffffffffu, qb, 2);
      if (t == 0) {
        const size_t pl = (static_cast<size_t>(eh / kHalf) * k_total + k) * rows;
        if (ra < rows) dlp_part[pl + ra] = qa;
        if (rb < rows) dlp_part[pl + rb] = qb;
      }
      // bias partials: each column's sum over a warp's 16 rows (both rows of
      // a thread, then lane bits 2..4), then over the four warps in order
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float a = acc[4 * j + c] + acc[4 * j + 2 + c];
          float b = acc[32 + 4 * j + c] + acc[32 + 4 * j + 2 + c];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            a += __shfl_xor_sync(0xffffffffu, a, off);
            b += __shfl_xor_sync(0xffffffffu, b, off);
          }
          if (g == 0) {
            red_wg[warp * kHalf + 8 * j + 2 * t + c] = a;
            red_wg[(4 + warp) * kHalf + 8 * j + 2 * t + c] = b;
          }
        }
      warpgroup_sync(warpgroup);
      {
        const int which = tid / kHalf;  // 0: dmu, 1: dpre
        const int f = tid % kHalf;
        const float* col = red_wg + which * 4 * kHalf + f;
        const float v = ((col[0] + col[kHalf]) + col[2 * kHalf]) + col[3 * kHalf];
        const size_t pi = (static_cast<size_t>(blockIdx.x) * k_total + k) * d + eh + f;
        (which ? bsig_part : bmu_part)[pi] = v;
      }
      async_proxy_fence();  // these generic accesses, before TMA refills the stage
      warpgroup_sync(warpgroup);
      if (lane == 0) barrier_arrive(empty + 8 * (ring + held));
    }
    if constexpr (kSum) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = h ? rb : ra;
          const int i = 4 * j + 2 * h;
          if (r < rows) {
            float2* p = reinterpret_cast<float2*>(dmu_sum + static_cast<size_t>(r) * d + eh +
                                                  8 * j + 2 * t);
            const float2 old = k0 == 0 ? make_float2(0.f, 0.f) : *p;
            *p = make_float2(old.x + dsum[i], old.y + dsum[i + 1]);
          }
        }
    }
  }
}

// The weights' 3-D tensor maps [D_out, K, D_in] over the Linear layout
// (k fixed by the box coordinate: strides D_in and K D_in elements, no copy),
// boxes of 64 D_in x 1 x 64 D_out.
inline int encode_weight_maps(CUtensorMap* map_wm, CUtensorMap* map_ws, const void* wm,
                              const void* ws, int d, int k_total) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(k_total),
                              static_cast<cuuint64_t>(d)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(k_total) * d * 2};
  const cuuint32_t box[3] = {vitad_tma::kBoxInner, 1, kHalf};
  int err = vitad_tma::encode_bf16(map_wm, wm, 3, dims, strides, box);
  if (err == 0) err = vitad_tma::encode_bf16(map_ws, ws, 3, dims, strides, box);
  return err;
}

// Dynamic shared memory of a B2 / B3-terms block at width d, with the
// largest ring depth that fits (at most kMaxStages): 0 when fewer than 2
// stages fit.
inline size_t rows_block_smem(bool resident, int d, int device, int* stages) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return 0;
  const size_t ring_stage = static_cast<size_t>(kConsumers) * (resident ? 2 : 3) * kBoxBytes;
  // room to align to 1024 bytes, the resident x, two barriers a stage and one
  const size_t fixed = 1024 + (resident ? static_cast<size_t>(d / 64) * kBoxBytes : 0) +
                       16 * kConsumers * kMaxStages + 8;
  const size_t room = static_cast<size_t>(optin) > fixed ? (optin - fixed) / ring_stage : 0;
  *stages = room < kMaxStages ? static_cast<int>(room) : kMaxStages;
  return *stages < 2 ? 0 : fixed + *stages * ring_stage;
}

// B2: x_m [R, D] bf16 (x rounded), the weights bf16 in the Linear layout, x
// f32 [R, D], lp [K, R], bm and bs [K, D] f32, ll [R, D] f32.
template <bool kResidentX>
int launch_forward(const void* x_m, const float* x, const float* lp, const void* wm,
                   const void* ws, const float* bm, const float* bs, float* ll, int rows, int d,
                   int k_total, int device, cudaStream_t stream) {
  CUtensorMap map_x, map_wm, map_ws;
  int err = vitad_tma::encode_matrix(&map_x, x_m, rows, d, kRows);
  if (err == 0) err = encode_weight_maps(&map_wm, &map_ws, wm, ws, d, k_total);
  if (err != 0) return err;
  int stages = 0;
  const size_t smem = rows_block_smem(kResidentX, d, device, &stages);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  err = vitad_launch::raise_dynamic_smem(
      reinterpret_cast<const void*>(gmm_forward_wgmma_kernel<kResidentX>), smem, device);
  if (err != 0) return err;
  constexpr int kBlockFeatures = kConsumers * kHalf;
  const dim3 grid((rows + kRows - 1) / kRows, (d + kBlockFeatures - 1) / kBlockFeatures);
  gmm_forward_wgmma_kernel<kResidentX><<<grid, kThreads, smem, stream>>>(
      map_x, map_wm, map_ws, x, lp, bm, bs, ll, rows, d, k_total, stages);
  return static_cast<int>(cudaGetLastError());
}

// B3 terms: as launch_forward, plus g and ll [R, D] f32 and the outputs of
// gmm_terms_wgmma_kernel.
template <bool kResidentX, bool kSum>
int launch_terms(const void* x_m, const float* x, const float* lp, const float* g,
                 const float* ll, const void* wm, const void* ws, const float* bm,
                 const float* bs, int k0, int kc, void* dmu, void* dpre, float* bmu_part,
                 float* bsig_part, float* dlp_part, float* dmu_sum, int rows, int d, int k_total,
                 int device, cudaStream_t stream) {
  CUtensorMap map_x, map_wm, map_ws;
  int err = vitad_tma::encode_matrix(&map_x, x_m, rows, d, kRows);
  if (err == 0) err = encode_weight_maps(&map_wm, &map_ws, wm, ws, d, k_total);
  if (err != 0) return err;
  int stages = 0;
  const size_t smem = rows_block_smem(kResidentX, d, device, &stages);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gmm_terms_wgmma_kernel<kResidentX, kSum>;
  err = vitad_launch::raise_dynamic_smem(reinterpret_cast<const void*>(kernel), smem, device);
  if (err != 0) return err;
  constexpr int kBlockFeatures = kConsumers * kHalf;
  const dim3 grid((rows + kRows - 1) / kRows, (d + kBlockFeatures - 1) / kBlockFeatures);
  kernel<<<grid, kThreads, smem, stream>>>(
      map_x, map_wm, map_ws, x, lp, g, ll, bm, bs, k0, kc, static_cast<__nv_bfloat16*>(dmu),
      static_cast<__nv_bfloat16*>(dpre), bmu_part, bsig_part, dlp_part, dmu_sum, rows, d,
      k_total, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---- B3, part 2 and B4 under bf16: products over the scratch ------------------

namespace gemm {

using namespace vitad_hopper;

constexpr int kConsumers = 2;  // warpgroups; the third holds the producer thread
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBoxBytes = 64 * 64 * 2;  // one TMA box: 64 rows x 64 bf16 (128 bytes)
constexpr int kTile = 128;              // output rows and columns of a block's tile

// Weight gradients: a stage is 64 rows r of [dmu e-half 0 | dmu e-half 1 |
// dpre e-half 0 | dpre e-half 1 | xm i-half 0 | xm i-half 1], six boxes.
constexpr int kWgradStageBytes = 6 * kBoxBytes;
constexpr int kWgradStages = 4;
constexpr int kWgradSmem = kWgradStages * kWgradStageBytes + 1024 + 2 * kWgradStages * 8;

// Persistent over tiles (component kk, 128 e, 128 i), the component slowest,
// so the blocks in flight share one component's dmu/dpre from L2. Consumer
// warpgroup w takes the output rows e0 + 64 w .. + 64 of both gradients
// (two accumulators of 64 x 128, 128 registers a thread); the stage's boxes
// are MN-major operands: A = dmu[kk][64 r, 64 e] (e contiguous), B =
// xm[64 r, 128 i] (i contiguous, two boxes 8 KB apart), contracting over r.
// Boxes wholly past D are not loaded: the products of their stale bytes land
// only in rows or columns past D, which are never stored.
__global__ void __launch_bounds__(kThreads, 1)
gmm_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap map_dmu,
                       const __grid_constant__ CUtensorMap map_dpre,
                       const __grid_constant__ CUtensorMap map_xm, float* __restrict__ dwm,
                       float* __restrict__ dws, int k0, int kc, int rows, int d, int k_total) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t stages = (shared_address(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = stages + kWgradStages * kWgradStageBytes;  // producer -> consumers
  const uint32_t empty = full + 8 * kWgradStages;                  // consumers -> producer
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgradStages; ++s) {
      barrier_init(full + 8 * s, 1);                // the producer's arrive.expect_tx
      barrier_init(empty + 8 * s, kConsumers * 4);  // lane 0 of every consumer warp
    }
    barrier_init_fence();
  }
  __syncthreads();
  const int n_t = (d + kTile - 1) / kTile;  // e tiles = i tiles
  const int tiles = kc * n_t * n_t;
  const int r_steps = (rows + 63) / 64;
  const int warpgroup = threadIdx.x / 128;

  if (warpgroup == kConsumers) {
    registers_release<40>();
    if (threadIdx.x == 128 * kConsumers) {
      int s = 0;
      uint32_t parity = 1;  // fresh empty barriers let the first round pass
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int kk = tile / (n_t * n_t);
        const int e0 = (tile / n_t % n_t) * kTile;
        const int i0 = (tile % n_t) * kTile;
        const int e_boxes = e0 + 64 < d ? 2 : 1, i_boxes = i0 + 64 < d ? 2 : 1;
        for (int rs = 0; rs < r_steps; ++rs) {
          barrier_wait(empty + 8 * s, parity);
          const uint32_t bar = full + 8 * s;
          const uint32_t st = stages + s * kWgradStageBytes;
          barrier_arrive_expect(bar, (2 * e_boxes + i_boxes) * kBoxBytes);
          for (int h = 0; h < e_boxes; ++h) {
            tma_load_3d(st + h * kBoxBytes, &map_dmu, bar, e0 + 64 * h, 64 * rs, kk);
            tma_load_3d(st + (2 + h) * kBoxBytes, &map_dpre, bar, e0 + 64 * h, 64 * rs, kk);
          }
          for (int h = 0; h < i_boxes; ++h)
            tma_load_2d(st + (4 + h) * kBoxBytes, &map_xm, bar, i0 + 64 * h, 64 * rs);
          if (++s == kWgradStages) {
            s = 0;
            parity ^= 1;
          }
        }
      }
    }
  } else {
    registers_acquire<232>();
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    float am[64], as[64];
    int s = 0;
    uint32_t parity = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int kk = tile / (n_t * n_t);
      const int e0 = (tile / n_t % n_t) * kTile;
      const int i0 = (tile % n_t) * kTile;
      int held = 0;  // the stage whose products may still be running
      for (int rs = 0; rs < r_steps; ++rs) {
        barrier_wait(full + 8 * s, parity);
        const uint32_t st = stages + s * kWgradStageBytes;
        const uint64_t a_mu = operand_descriptor_mn(st + warpgroup * kBoxBytes, kBoxBytes);
        const uint64_t a_pre = operand_descriptor_mn(st + (2 + warpgroup) * kBoxBytes, kBoxBytes);
        const uint64_t b = operand_descriptor_mn(st + 4 * kBoxBytes, kBoxBytes);
        wgmma_fence();
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {  // 16 rows r = 2048 bytes = 128 descriptor units
          wgmma_m64n128k16<1, 1>(am, a_mu + 128 * jj, b + 128 * jj, (rs | jj) != 0);
          wgmma_m64n128k16<1, 1>(as, a_pre + 128 * jj, b + 128 * jj, (rs | jj) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the stage before this one has been read: release it
        if (rs > 0 && lane == 0) barrier_arrive(empty + 8 * held);
        held = s;
        if (++s == kWgradStages) {
          s = 0;
          parity ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) barrier_arrive(empty + 8 * held);
      accumulator_fence(am);
      accumulator_fence(as);
      // dW[k][e, i] at row e K + k of the Linear layout; the producer is
      // already loading the next tile's stages
      const int k = k0 + kk;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = e0 + 64 * warpgroup + 16 * warp + g + 8 * h;
        if (e < d) {
          const size_t row = (static_cast<size_t>(e) * k_total + k) * d;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int i = i0 + 8 * j + 2 * t;
            if (i < d) {
              *reinterpret_cast<float2*>(dwm + row + i) =
                  make_float2(am[4 * j + 2 * h], am[4 * j + 2 * h + 1]);
              *reinterpret_cast<float2*>(dws + row + i) =
                  make_float2(as[4 * j + 2 * h], as[4 * j + 2 * h + 1]);
            }
          }
        }
      }
    }
  }
}

// dx: a block's tile is 128 rows x 256 input features; a stage is one of the
// two products for 64 e: [dmu or dpre 128 r x 64 e | Wmu or Wsig 64 e x 256 i
// as four boxes]: 48 KB, 87 FLOP per byte (two products per stage with
// 128-wide tiles were 64 KB and 64 FLOP per byte).
constexpr int kDxCols = 256;
constexpr int kDxStageBytes = 6 * kBoxBytes;
constexpr int kDxStages = 4;
constexpr int kDxSmem = kDxStages * kDxStageBytes + 1024 + 2 * kDxStages * 8;

// Block (128 rows r0.., 256 input features i0.., split blockIdx.z of
// `splits`): the split's components kk in [z kc / splits, (z + 1) kc / splits),
// for each the 64-deep slices of e, for each slice the dmu then the dpre
// product. Consumer warpgroup w takes rows r0 + 64 w .. + 64: A = dmu/dpre
// [64 r, 64 e] K-major (e contiguous), B = W[k][64 e, 256 i] MN-major (i
// contiguous, through the 3-D weight maps), both products into one 64 x 256
// accumulator (128 registers a thread). Boxes wholly past D are not loaded
// (their columns are never stored). With one split the epilogue finishes dx
// (+ the chunks before, - sum_k dmu on the last chunk); with more, it writes
// the split's partial [splits, R, D] for gmm_dx_reduce_kernel.
__global__ void __launch_bounds__(kThreads, 1)
gmm_bwd_x_wgmma_kernel(const __grid_constant__ CUtensorMap map_dmu,
                       const __grid_constant__ CUtensorMap map_dpre,
                       const __grid_constant__ CUtensorMap map_wm,
                       const __grid_constant__ CUtensorMap map_ws,
                       const float* __restrict__ dmu_sum, float* __restrict__ dx,
                       float* __restrict__ dx_part, int k0, int kc, int first, int last,
                       int splits, int rows, int d) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t stages = (shared_address(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = stages + kDxStages * kDxStageBytes;  // producer -> consumers
  const uint32_t empty = full + 8 * kDxStages;               // consumers -> producer
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDxStages; ++s) {
      barrier_init(full + 8 * s, 1);
      barrier_init(empty + 8 * s, kConsumers * 4);
    }
    barrier_init_fence();
  }
  __syncthreads();
  const int r0 = blockIdx.x * kTile;
  const int i0 = blockIdx.y * kDxCols;
  const int z = blockIdx.z;
  const int kk_begin = z * kc / splits, kk_end = (z + 1) * kc / splits;
  const int e_steps = d / 64;
  const int steps = 2 * (kk_end - kk_begin) * e_steps;  // (component, e slice, product)
  const int warpgroup = threadIdx.x / 128;

  if (warpgroup == kConsumers) {
    registers_release<40>();
    if (threadIdx.x == 128 * kConsumers) {
      const int i_boxes = min(kDxCols / 64, (d - i0) / 64);
      for (int step = 0; step < steps; ++step) {
        const int s = step % kDxStages;
        barrier_wait(empty + 8 * s, ((step / kDxStages) & 1) ^ 1);
        const int kk = kk_begin + step / (2 * e_steps);
        const int es = 64 * (step / 2 % e_steps);
        const bool pre = step & 1;
        const uint32_t bar = full + 8 * s;
        const uint32_t st = stages + s * kDxStageBytes;
        barrier_arrive_expect(bar, (2 + i_boxes) * kBoxBytes);
        tma_load_3d(st, pre ? &map_dpre : &map_dmu, bar, es, r0, kk);
        for (int h = 0; h < i_boxes; ++h)
          tma_load_3d(st + (2 + h) * kBoxBytes, pre ? &map_ws : &map_wm, bar, i0 + 64 * h,
                      k0 + kk, es);
      }
    }
  } else {
    registers_acquire<232>();
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    float acc[2 * kDxCols / 4];
    int held = 0;
    for (int step = 0; step < steps; ++step) {
      const int s = step % kDxStages;
      barrier_wait(full + 8 * s, (step / kDxStages) & 1);
      const uint32_t st = stages + s * kDxStageBytes;
      const uint64_t a = operand_descriptor(st + warpgroup * kBoxBytes);
      const uint64_t b = operand_descriptor_mn(st + 2 * kBoxBytes, kBoxBytes);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)  // 16 e: 32 bytes of A, 2048 bytes of B
        wgmma_m64n256k16<0, 1>(acc, a + 2 * jj, b + 128 * jj, (step | jj) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (step > 0 && lane == 0) barrier_arrive(empty + 8 * held);
      held = s;
    }
    wgmma_wait<0>();
    accumulator_fence(acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 64 * warpgroup + 16 * warp + g + 8 * h;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < kDxCols / 8; ++j) {
        const int i = i0 + 8 * j + 2 * t;
        if (i >= d) continue;
        const size_t o = static_cast<size_t>(r) * d + i;
        float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        if (splits == 1) {
          if (!first) {
            const float2 p = *reinterpret_cast<const float2*>(dx + o);
            v = make_float2(p.x + v.x, p.y + v.y);
          }
          if (last) {
            const float2 m = *reinterpret_cast<const float2*>(dmu_sum + o);
            v = make_float2(v.x - m.x, v.y - m.y);
          }
          *reinterpret_cast<float2*>(dx + o) = v;
        } else {
          *reinterpret_cast<float2*>(dx_part + static_cast<size_t>(z) * rows * d + o) = v;
        }
      }
    }
  }
}

// dx = (dx of the chunks before, unless first) + sum_z dx_part[z], in order
// of z, - sum_k dmu on the last chunk; n4 = R D / 4 float4s.
__global__ void gmm_dx_reduce_kernel(const float4* __restrict__ dx_part,
                                     const float4* __restrict__ dmu_sum, float4* __restrict__ dx,
                                     int first, int last, int splits, size_t n4) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 v = first ? make_float4(0.f, 0.f, 0.f, 0.f) : dx[i];
    for (int z = 0; z < splits; ++z) {
      const float4 p = dx_part[z * n4 + i];
      v = make_float4(v.x + p.x, v.y + p.y, v.z + p.z, v.w + p.w);
    }
    if (last) {
      const float4 m = dmu_sum[i];
      v = make_float4(v.x - m.x, v.y - m.y, v.z - m.z, v.w - m.w);
    }
    dx[i] = v;
  }
}

// The scratch [kc, R, D] bf16 as a 3-D tensor map, boxes of 64 e x box_rows
// rows x 1 component: rows past R arrive as zeros.
inline int encode_scratch(CUtensorMap* map, const void* base, int kc, int rows, int d,
                          int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(kc)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {vitad_tma::kBoxInner, static_cast<cuuint32_t>(box_rows), 1};
  return vitad_tma::encode_bf16(map, base, 3, dims, strides, box);
}

int launch_wgrad(const void* x_m, const void* dmu, const void* dpre, float* dwm, float* dws,
                 int k0, int kc, int rows, int d, int k_total, int device, cudaStream_t stream) {
  CUtensorMap map_dmu, map_dpre, map_xm;
  int err = encode_scratch(&map_dmu, dmu, kc, rows, d, 64);
  if (err == 0) err = encode_scratch(&map_dpre, dpre, kc, rows, d, 64);
  if (err == 0) err = vitad_tma::encode_matrix(&map_xm, x_m, rows, d, 64);
  if (err != 0) return err;
  int sms = 0;
  const cudaError_t cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  err = vitad_launch::raise_dynamic_smem(reinterpret_cast<const void*>(gmm_wgrad_wgmma_kernel),
                                         kWgradSmem, device);
  if (err != 0) return err;
  const int n_t = (d + kTile - 1) / kTile;
  const int tiles = kc * n_t * n_t;
  gmm_wgrad_wgmma_kernel<<<tiles < sms ? tiles : sms, kThreads, kWgradSmem, stream>>>(
      map_dmu, map_dpre, map_xm, dwm, dws, k0, kc, rows, d, k_total);
  return static_cast<int>(cudaGetLastError());
}

int launch_dx(const void* dmu, const void* dpre, const void* wm, const void* ws,
              const float* dmu_sum, float* dx, float* dx_part, int k0, int kc, int first,
              int last, int splits, int rows, int d, int k_total, int device,
              cudaStream_t stream) {
  CUtensorMap map_dmu, map_dpre, map_wm, map_ws;
  int err = encode_scratch(&map_dmu, dmu, kc, rows, d, kTile);
  if (err == 0) err = encode_scratch(&map_dpre, dpre, kc, rows, d, kTile);
  if (err == 0) err = wg::encode_weight_maps(&map_wm, &map_ws, wm, ws, d, k_total);
  if (err != 0) return err;
  err = vitad_launch::raise_dynamic_smem(reinterpret_cast<const void*>(gmm_bwd_x_wgmma_kernel),
                                         kDxSmem, device);
  if (err != 0) return err;
  const dim3 grid((rows + kTile - 1) / kTile, (d + kDxCols - 1) / kDxCols, splits);
  gmm_bwd_x_wgmma_kernel<<<grid, kThreads, kDxSmem, stream>>>(
      map_dmu, map_dpre, map_wm, map_ws, dmu_sum, dx, dx_part, k0, kc, first, last, splits,
      rows, d);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits == 1) return err;
  const size_t n4 = static_cast<size_t>(rows) * d / 4;
  const size_t blocks = (n4 + 255) / 256;
  gmm_dx_reduce_kernel<<<blocks < 1024 ? static_cast<unsigned>(blocks) : 1024u, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(dx_part), reinterpret_cast<const float4*>(dmu_sum),
      reinterpret_cast<float4*>(dx), first, last, splits, n4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm

bool bad_shape(int rows, int d, int k_total) {
  return rows < 1 || d < kTile || d % kTile != 0 || d / kTile > 65535 || k_total < 1;
}

bool bad_chunk(int k0, int kc, int k_total) {
  return k0 < 0 || kc < 1 || kc > 65535 || k0 + kc > k_total;
}

int status(cudaStream_t) { return static_cast<int>(cudaGetLastError()); }

// What the entry points report as the kernels they launched.
constexpr int kRouteWgmmaResident = 1, kRouteFma = 2, kRouteWgmmaStreamed = 3, kRouteWgmma = 4;

}  // namespace

// Plain C entry points, bound with ctypes. Every pointer is a contiguous,
// 16-byte aligned device buffer in the layouts of the header; weights are
// bf16 when is_bf16 != 0, else f32; every other buffer is f32 except x_m
// (bf16, under bf16 only) and the dmu/dpre scratch, which is in the weights'
// type. Each launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success), or, for the bf16 kernels, a tensor-map
// error (2001: libcuda has no cuTensorMapEncodeTiled; 3000 + CUresult: it
// refused the map). Each writes to the host int `route` what it launched,
// 0 unless the launch went through: 1 the bf16 wgmma kernel with the block's
// x rows resident in shared memory (D <= 1024; gmm_forward and
// gmm_backward_terms), 3 the same with x streamed, 4 the bf16 wgmma GEMM
// (gmm_backward_weights, gmm_backward_x), 2 the f32 FMA kernel.

extern "C" int gmm_forward(const void* x, const void* x_m, const void* log_pi_t,
                           const void* w_mu, const void* w_sigma, const void* b_mu_t,
                           const void* b_sigma_t, void* ll, int rows, int d, int k_total,
                           int is_bf16, int device, void* stream, int* route) {
  if (route == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *route = 0;
  if (bad_shape(rows, d, k_total) || (is_bf16 && x_m == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* lp = static_cast<const float*>(log_pi_t);
  const float* bm = static_cast<const float*>(b_mu_t);
  const float* bs = static_cast<const float*>(b_sigma_t);
  float* out = static_cast<float*>(ll);
  if (is_bf16) {
    const bool resident = d <= wg::kMaxResidentDim;
    const int rc = resident ? wg::launch_forward<true>(x_m, xf, lp, w_mu, w_sigma, bm, bs, out,
                                                       rows, d, k_total, device, st)
                            : wg::launch_forward<false>(x_m, xf, lp, w_mu, w_sigma, bm, bs, out,
                                                        rows, d, k_total, device, st);
    if (rc == 0) *route = resident ? kRouteWgmmaResident : kRouteWgmmaStreamed;
    return rc;
  }
  const dim3 grid((rows + kTile - 1) / kTile, d / kTile);
  gmm_forward_kernel<<<grid, kThreads, 0, st>>>(xf, lp, static_cast<const float*>(w_mu),
                                                static_cast<const float*>(w_sigma), bm, bs, out,
                                                rows, d, k_total);
  const int rc = status(st);
  if (rc == 0) *route = kRouteFma;
  return rc;
}

// B3's terms over components k0 .. k0 + kc - 1: dmu, dpre [kc, R, D] in the
// weights' type, bmu_part and bsig_part [ceil(R / 64), K, D], dlp_part
// [D / 64, K, R], and, when dmu_sum is not null, sum_k dmu [R, D] (added to
// its contents when k0 > 0). log_pi_t [K, R], b_mu_t and b_sigma_t [K, D].
extern "C" int gmm_backward_terms(const void* x, const void* x_m, const void* log_pi_t,
                                  const void* g, const void* ll, const void* w_mu,
                                  const void* w_sigma, const void* b_mu_t, const void* b_sigma_t,
                                  int k0, int kc, void* dmu, void* dpre, void* bmu_part,
                                  void* bsig_part, void* dlp_part, void* dmu_sum, int rows, int d,
                                  int k_total, int is_bf16, int device, void* stream, int* route) {
  if (route == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *route = 0;
  if (bad_shape(rows, d, k_total) || bad_chunk(k0, kc, k_total) || (is_bf16 && x_m == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fo = [](void* p) { return static_cast<float*>(p); };
  if (is_bf16) {
    const bool resident = d <= wg::kMaxResidentDim;
    int rc;
#define VITAD_TERMS(RES, SUM)                                                                    \
  wg::launch_terms<RES, SUM>(x_m, f(x), f(log_pi_t), f(g), f(ll), w_mu, w_sigma, f(b_mu_t),      \
                             f(b_sigma_t), k0, kc, dmu, dpre, fo(bmu_part), fo(bsig_part),      \
                             fo(dlp_part), fo(dmu_sum), rows, d, k_total, device, st)
    if (dmu_sum != nullptr)
      rc = resident ? VITAD_TERMS(true, true) : VITAD_TERMS(false, true);
    else
      rc = resident ? VITAD_TERMS(true, false) : VITAD_TERMS(false, false);
#undef VITAD_TERMS
    if (rc == 0) *route = resident ? kRouteWgmmaResident : kRouteWgmmaStreamed;
    return rc;
  }
  const dim3 grid((rows + kTile - 1) / kTile, d / kTile);
  gmm_terms_kernel<<<grid, kThreads, 0, st>>>(
      f(x), f(log_pi_t), f(g), f(ll), f(w_mu), f(w_sigma), f(b_mu_t), f(b_sigma_t), k0, kc,
      fo(dmu), fo(dpre), fo(bmu_part), fo(bsig_part), fo(dlp_part), fo(dmu_sum), rows, d,
      k_total);
  const int rc = status(st);
  if (rc == 0) *route = kRouteFma;
  return rc;
}

// B3's weight gradients of components k0 .. k0 + kc - 1 from the chunk's
// scratch, into dw_mu and dw_sigma [D K, D] (Linear layout): under bf16 from
// x_m, under f32 from x.
extern "C" int gmm_backward_weights(const void* x, const void* x_m, const void* dmu,
                                    const void* dpre, void* dw_mu, void* dw_sigma, int k0, int kc,
                                    int rows, int d, int k_total, int is_bf16, int device,
                                    void* stream, int* route) {
  if (route == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *route = 0;
  if (bad_shape(rows, d, k_total) || bad_chunk(k0, kc, k_total) || (is_bf16 && x_m == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const int rc = gemm::launch_wgrad(x_m, dmu, dpre, static_cast<float*>(dw_mu),
                                      static_cast<float*>(dw_sigma), k0, kc, rows, d, k_total,
                                      device, st);
    if (rc == 0) *route = kRouteWgmma;
    return rc;
  }
  const dim3 grid(d / kTile, d / kTile, kc);
  gmm_wgrad_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dmu),
      static_cast<const float*>(dpre), static_cast<float*>(dw_mu), static_cast<float*>(dw_sigma),
      k0, rows, d, k_total);
  const int rc = status(st);
  if (rc == 0) *route = kRouteFma;
  return rc;
}

// B4 over components k0 .. k0 + kc - 1: dx [R, D] = (dx, unless first) +
// the chunk's products (- dmu_sum on the last chunk). Under bf16 the chunk's
// components are split into `splits` ranges (1 .. kc), each into its own
// partial of dx_part [splits, R, D] (unused when splits = 1), summed in order
// of the split; under f32 splits must be 1.
extern "C" int gmm_backward_x(const void* dmu, const void* dpre, const void* w_mu,
                              const void* w_sigma, const void* dmu_sum, void* dx, void* dx_part,
                              int k0, int kc, int first, int last, int splits, int rows, int d,
                              int k_total, int is_bf16, int device, void* stream, int* route) {
  if (route == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *route = 0;
  if (bad_shape(rows, d, k_total) || bad_chunk(k0, kc, k_total) || splits < 1 || splits > kc ||
      splits > 65535 || (splits > 1 && (!is_bf16 || dx_part == nullptr)) ||
      (last && dmu_sum == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ms = static_cast<const float*>(dmu_sum);
  float* out = static_cast<float*>(dx);
  if (is_bf16) {
    const int rc = gemm::launch_dx(dmu, dpre, w_mu, w_sigma, ms, out,
                                   static_cast<float*>(dx_part), k0, kc, first, last, splits,
                                   rows, d, k_total, device, st);
    if (rc == 0) *route = kRouteWgmma;
    return rc;
  }
  const dim3 grid((rows + kTile - 1) / kTile, d / kTile);
  gmm_bwd_x_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(dmu), static_cast<const float*>(dpre),
      static_cast<const float*>(w_mu), static_cast<const float*>(w_sigma), ms, out, k0, kc, first,
      last, rows, d, k_total);
  const int rc = status(st);
  if (rc == 0) *route = kRouteFma;
  return rc;
}
