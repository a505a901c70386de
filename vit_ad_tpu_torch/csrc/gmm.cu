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
// stride K*D_in). B3's biases [D*K] with the same index, B2's component-major
// [K, D]. x, g, ll are [R, D] f32, log_pi [R, K] f32 (B2: [K, R]). The weight
// gradients are written in the Linear layout.
//
// B2 under bf16 (the main path), `gmm_forward_wgmma_kernel`: a block takes
// 64 rows and 128 output features; two consumer warpgroups, each on 64 of
// the features, run wgmma m64n128k16 with x_m as A and [Wmu[k]; Wsig[k]] of
// their 64 features as one 128-row B operand, so mu and pre of an element
// land in the same thread (64 accumulator registers); one producer thread
// feeds each warpgroup's ring of 64-deep stages by TMA (128-byte swizzle,
// mbarrier transaction counts; rows past R arrive as zeros and are not
// stored). Per component k the producer fills warpgroup 0's stages, then
// warpgroup 1's, so one warpgroup's epilogue of k runs while the other's
// products run. The epilogue (density, online logsumexp) stays in registers:
// per thread 32 (row, feature) elements with their f32 x, running max and
// sum. The weights are read in place through 3-D tensor maps
// [D_out, K, D_in] (k fixed by the box coordinate; strides D_in and K D_in
// elements): B3 and B4 read the same bf16 copy, so no component-major copy
// exists. The biases [K, D] and log_pi [K, R] come component-major (a
// transpose in the wrapper, as the JAX wrapper does for log_pi), x rounded
// to bf16 as x_m [R, D] for TMA beside the f32 x the epilogue reads once.
//
//   traffic: a block reads its 64 x rows once and streams 2 x 64 x D bf16
//   weights per warpgroup and component, 64 FLOP per byte from L2. Up to
//   D = 1024 the x rows stay in shared memory (96 KB at 768, 128 KB at 1024)
//   beside rings of 4 (3 at 1024) stages of 16 KB; above, every stage brings
//   its 8 KB slice of x (43 FLOP/B; 4 stages of 24 KB). Blocks of one group
//   of 128 features are launched next to each other (blockIdx.x is the row
//   tile), so the concurrent blocks sweep the same (k, feature) weights and
//   device memory serves each slice about once per wave (at DeiT scoring
//   ~1 GB of weights from HBM, ~139 GB from L2).
//   epilogue: exp of pre, log sigma, a fast division and one exp per
//   logsumexp update (e = exp(-|tv - m|); s = s e + 1 when tv > m, else
//   s + e: the same value as the two-exp update), ~4 special-function
//   operations an element, under the other warpgroup's products.
//   registers: 168 a thread at launch; setmaxnreg gives the consumer
//   warpgroups 232 (the producer keeps 40), and the consumers still spill
//   part of their x values to local memory (120-152 bytes, read from L1
//   once per component).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py --against the
// first kernel, back to back): 19.7 ms at R = 25,088, D = 768, K = 150 (450
// TFLOP/s, 0.455 of the bound; the first kernel 273.9 ms), 9.79 ms at
// R = 12,544 (137.3), 3.50 ms at R = 3,136, D = 1024, K = 100 (376 TFLOP/s;
// 40.3) and 4.15 ms at R = 784, D = 2048, K = 100 (317 TFLOP/s, x streamed;
// 50.4). Not what holds it: the weight stream from L2 (2-block clusters
// sharing each weight tile by TMA multicast read 1-42% slower) nor the depth
// of queued products (two stages in flight: 12-79% slower); one producer
// thread per ring read 2-14% faster at three shapes and 13% slower with x
// streamed (PERF.md).
//
// Rounding: B2's bf16 kernel sums mu and pre in another order than B3's
// recompute (component_products, mma.sync), so the ll that B3 reads is not
// B3's own sum: q = g exp(dens + log_pi - ll) carries the difference of the
// two sums (~1e-6 relative in mu and pre, amplified by z / sigma), within the
// bf16 gradient tolerance of chip_smoke.py (GRAD_RTOL 1e-2, relative to the
// largest entry). The f32 route sums both with the same code.
//
// B2 under f32 and B3, B4: a 64x64 output tile per block of 8 warps (4 x 2,
// 16 x 32 each), the contraction staged 32 deep through shared memory, and
// products by mma.sync m16n8k16 bf16 with f32 accumulation (bf16 policy) or
// by f32 FMA in the same register layout (f32 policy; TF32 stays off). One
// kernel covers the full-width and the output-feature-tiled TPU bodies: the
// output features are always tiled by 64.
//
//   gmm_forward_kernel   (B2, f32) block (64 rows, 64 e): loops over K, the
//                              online logsumexp stays in registers.
//   gmm_terms_kernel     (B3)  block (64 rows, 64 e), a chunk of components:
//                              recomputes mu/pre as the f32 forward does,
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
// What bounds them on the H100: at B=128 (R = 25,088), D=768, K=150 the
// forward does 4 R D^2 K = 8.9 TFLOP (9 ms at the 989 TFLOP/s bf16 peak). The
// mma.sync kernels stage every operand with plain loads and no double
// buffering (64 FLOP per byte of operand traffic), so they are bound by their
// loads, far from either roof (B2's first kernel: 32 TFLOP/s).

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

// ---- B2, f32: the first kernel ---------------------------------------------------

// bm, bs [K, D] and lp [K, R]: the component-major copies the wrapper makes.

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


// ---- B2, bf16: wgmma behind TMA ---------------------------------------------------

namespace fwd {

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
      int slot0 = 0, slot1 = 0;
      uint32_t phase0 = 1, phase1 = 1;  // fresh empty barriers let the first round pass
      for (int k = 0; k < k_total; ++k)
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
            const float mu = acc[i] + (c ? bm2[j].y : bm2[j].x);
            const float pre = acc[32 + i] + (c ? bs2[j].y : bs2[j].x);
            const float sigma = (pre > 0.f ? pre + 1.f : __expf(pre)) + 1e-15f;
            const float z = __fdividef(xv[i] - mu, sigma);
            const float tv = (-__logf(sigma) - kHalfLog2Pi - 0.5f * (z * z)) + (h ? lpb : lpa);
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

// x_m [R, D] bf16 (x rounded), the weights bf16 in the Linear layout read
// through 3-D tensor maps [D_out, K, D_in] (k fixed by the box coordinate:
// strides D_in and K D_in elements, no copy), x f32 [R, D], lp [K, R], bm and
// bs [K, D] f32, ll [R, D] f32.
template <bool kResidentX>
int launch(const void* x_m, const float* x, const float* lp, const void* wm, const void* ws,
           const float* bm, const float* bs, float* ll, int rows, int d, int k_total,
           int device, cudaStream_t stream) {
  CUtensorMap map_x, map_wm, map_ws;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(k_total),
                              static_cast<cuuint64_t>(d)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(k_total) * d * 2};
  const cuuint32_t box[3] = {vitad_tma::kBoxInner, 1, kHalf};
  int err = vitad_tma::encode_matrix(&map_x, x_m, rows, d, kRows);
  if (err == 0) err = vitad_tma::encode_bf16(&map_wm, wm, 3, dims, strides, box);
  if (err == 0) err = vitad_tma::encode_bf16(&map_ws, ws, 3, dims, strides, box);
  if (err != 0) return err;
  int optin = 0;
  const cudaError_t cerr =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  constexpr size_t kRingStageBytes = kConsumers * (kResidentX ? 2 : 3) * kBoxBytes;
  // room to align to 1024 bytes, the resident x, two barriers a stage and one
  const size_t fixed = 1024 + (kResidentX ? static_cast<size_t>(d / 64) * kBoxBytes : 0) +
                       16 * kConsumers * kMaxStages + 8;
  const size_t room = static_cast<size_t>(optin) > fixed ? (optin - fixed) / kRingStageBytes : 0;
  const int stages = room < kMaxStages ? static_cast<int>(room) : kMaxStages;
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fixed + stages * kRingStageBytes;
  err = vitad_launch::raise_dynamic_smem(
      reinterpret_cast<const void*>(gmm_forward_wgmma_kernel<kResidentX>), smem, device);
  if (err != 0) return err;
  constexpr int kBlockFeatures = kConsumers * kHalf;
  const dim3 grid((rows + kRows - 1) / kRows, (d + kBlockFeatures - 1) / kBlockFeatures);
  gmm_forward_wgmma_kernel<kResidentX><<<grid, kThreads, smem, stream>>>(
      map_x, map_wm, map_ws, x, lp, bm, bs, ll, rows, d, k_total, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fwd

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

// What gmm_forward reports as the kernel it launched.
constexpr int kRouteWgmmaResident = 1, kRouteFma = 2, kRouteWgmmaStreamed = 3;

}  // namespace

// Plain C entry points, bound with ctypes. Every pointer is a contiguous,
// 16-byte aligned device buffer in the layouts of the header; weights are
// bf16 when is_bf16 != 0, else f32; every other buffer is f32 except x_m
// (bf16, B2 under bf16 only) and the dmu/dpre scratch, which is in the
// weights' type. Each launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success), or, for B2's bf16 kernel, a tensor-map
// error (2001: libcuda has no cuTensorMapEncodeTiled; 3000 + CUresult: it
// refused the map). gmm_forward writes to the host int `route` the kernel it
// launched: 1 the bf16 wgmma kernel with the x rows resident (D <= 1024), 3
// the same with x streamed, 2 the f32 kernel; 0 unless the launch went
// through.

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
    const bool resident = d <= fwd::kMaxResidentDim;
    const int rc = resident ? fwd::launch<true>(x_m, xf, lp, w_mu, w_sigma, bm, bs, out, rows, d,
                                                k_total, device, st)
                            : fwd::launch<false>(x_m, xf, lp, w_mu, w_sigma, bm, bs, out, rows, d,
                                                 k_total, device, st);
    if (rc == 0) *route = resident ? kRouteWgmmaResident : kRouteWgmmaStreamed;
    return rc;
  }
  const dim3 grid((rows + kTile - 1) / kTile, d / kTile);
  gmm_forward_kernel<float><<<grid, kThreads, 0, st>>>(
      xf, lp, static_cast<const float*>(w_mu), static_cast<const float*>(w_sigma), bm, bs, out,
      rows, d, k_total);
  const int rc = status(st);
  if (rc == 0) *route = kRouteFma;
  return rc;
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
