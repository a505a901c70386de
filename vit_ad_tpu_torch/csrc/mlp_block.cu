// Pre-LN MLP half-block of a ViT block (B6) for Hopper (sm_90a).
//
// Replaces the TPU kernel vit_ad_tpu/ops/pallas/mlp.py::_kernel (pallas_call
// in mlp_block_pallas, public entry mlp_block). For every row of x [R, D]
// (bf16 or f32):
//
//   xf = f32(x);  y = LayerNorm(xf) * scale + bias     (f32 mean, centred variance)
//   h  = T(y) . W1^T + b1                              (f32 accumulation, f32 bias)
//   g  = 0.5 h (1 + tanh(sqrt(2/pi) (h + 0.044715 h^3)))   (f32)
//   o  = T(g) . W2^T + b2                              (f32 accumulation, f32 bias)
//   out = T(xf + o)
//
// T is the type of x and of the weights (bf16 or f32); scale, bias, b1, b2 are
// f32. The weights are read in place in the nn.Linear layout: W1 = fc1.weight
// [H, D], W2 = fc2.weight [D, H] (H = 4D for a ViT), both contiguous along the
// contraction: no transposed copy exists.
//
// What bounds it on the H100: operations. At the DeiT-base shape of a B=128
// batch (R = 25,344, D = 768, H = 3072) the two products are 4 R D H = 239
// GFLOP, 0.242 ms at the 989 TFLOP/s bf16 peak, against 26 us for the bytes (x
// in and out 78 MB, weights 9.4 MB).
//
// bf16: three kernels on one stream, the products on wgmma behind TMA.
// The first version was one fused kernel in the TPU kernel's image (32-row
// tiles, the [32, D] f32 output in registers over the hidden sweep, W1 and W2
// fragments read from L2 by 4-byte loads, mma.sync): 2.820 ms at the shape
// above on an NVIDIA H100 80GB HBM3 at 700 W, 11.7x the bound and 4.25x the
// stock PyTorch tail (0.663 ms). It was held by its weight stream (792 blocks x
// 9.4 MB = 7.5 GB a launch from L2), by mma.sync with every B fragment feeding
// two MMAs, and by 8 warps an SM. A fused block cannot hold more than 64 rows
// of f32 output in an SM's registers, and at 64 rows the weight stream alone
// (3.7 GB from L2) costs the stock tail's whole time. The reason the TPU kernel
// kept the hidden activations on chip does not hold here: written to device
// memory once and read once, y and the hidden are 0.39 GB = 0.12 ms of traffic
// that overlaps the products, under the operations bound. So:
//
//   k0  y = bf16(LayerNorm(x))                   the one-pass LayerNorm kernel
//                                                (layer_norm_common.cuh), [R, D] scratch
//   k1  hidden = bf16(gelu_tanh(y . W1^T + b1))  gemm_bf16_kernel, [R, H] scratch
//   k2  out = bf16(f32(x) + (hidden . W2^T + b2))  gemm_bf16_kernel
//
// with the rounding points of the fused form (y, the GELU output and the
// result, each rounded once from f32). gemm_bf16_kernel computes
// C[M, N] = A[M, K] . B[N, K]^T for K-major bf16 A and B: a persistent block
// per SM walks 128 x 192 output tiles (24 and 6 whole waves of 132 SMs for the
// two products of a B=128 batch); one producer thread keeps a ring of
// four 64-deep A and B tiles in shared memory filled by TMA (128-byte swizzle,
// mbarrier transaction counts; rows past M or N arrive as zeros), two consumer
// warpgroups of 64 rows each run wgmma m64n192k16 on the tiles that have
// arrived, one group of four in flight while the stage before it is released,
// with the accumulator (96 registers a thread) in registers; the producer
// warpgroup gives its registers to the consumers (setmaxnreg). The producer
// runs ahead into the next tile's loads while the consumers apply the
// epilogue: bias and tanh GELU (as h sigmoid(2u): one ex2 and one fast
// division, not tanhf's branches), or bias and the residual on the f32 x, whose
// tile the producer has fetched by TMA during the sweep. The rounded tile
// goes to shared memory in the swizzled layout (bank-conflict free) and
// leaves by TMA stores, which clip rows past M and columns past N and drain
// while the next tile's products run. A first form of the epilogue that
// stored 4 bytes a thread straight from the accumulators spent more time
// storing than multiplying (0.79 ms for the half-block, against 0.20 ms with
// the stores switched off).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W at the shape above, over the
// whole runs of chip_smoke.py that PERF.md lists: 0.44 to 0.45 ms a call back
// to back (k0 0.054 to 0.056, k1 0.22 to 0.24 = 506 to 538 TFLOP/s, k2 0.17 =
// 697 to 712 TFLOP/s), 1.9x the bound, against 0.68 to 0.70 ms for the stock
// tail; by CUDA events around single calls 0.49 to 0.60 ms against 0.67 to
// 0.69 (the host's share of a call moves from run to run) and 2.820 ms for the
// first version.
// So the aim of 0.60 ms is met back to back and only just by events.
// With the LayerNorm's rows kernel as k0 (0.0313 to 0.0316 ms back to back,
// 2.5 of the card's 3.35 TB/s; 0.050 before) the half-block reads 0.41 to
// 0.455 ms back to back on the same card.
// What holds it now: k1's GELU runs on the special-function unit (two
// operations an element) while the tensor cores wait.
//
// The GEMM alone (mlp_gemm_forward) also runs a model-axis shard of a trunk:
// fc1's hidden block with the GELU epilogue, and proj and fc2 on the rank's
// input columns with epilogue 2, which stores the f32 accumulator (no bias, no
// residual) for the sum over the ranks. It leaves by 8-byte stores straight
// from the registers (a thread's two columns; four lanes fill a 32-byte
// sector): an f32 output tile of 128 x 192 would take 96 KB of shared memory
// beside the 160 KB ring. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 15): 0.138-0.142 ms at [25344,1536] x [768,1536]^T
// (427 TFLOP/s), 0.104-0.109 ms at [25344,384] x [768,384]^T, where its
// 78 MB of f32 output is the bound.
//
// f32 (the f32 numerics policy uses the erf GELU, so this is off the main
// path): the first version's fused kernel, its sums by FMA (TF32 stays off),
// for the tight comparison with the plain version.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"
#include "launch_common.cuh"
#include "layer_norm_common.cuh"
#include "tensor_map.cuh"

namespace {

constexpr float kSqrt2OverPi = 0.7978845608028654f;

__device__ __forceinline__ float gelu_tanh(float h) {
  const float inner = kSqrt2OverPi * (h + 0.044715f * h * h * h);
  return 0.5f * h * (1.f + tanhf(inner));
}

// ---- bf16: C = A . B^T on wgmma behind TMA --------------------------------------

namespace gemm {

using namespace vitad_hopper;

// The same function as gelu_tanh, written as h * sigmoid(2 u) with
// u = sqrt(2/pi) (h + 0.044715 h^3), since 0.5 (1 + tanh u) = 1 / (1 + e^-2u):
// one ex2.approx and one fast division instead of tanhf's branches, within
// ~1e-6 relative of it (the result is rounded to bf16, 4e-3). A large negative
// h gives h / inf = -0, as tanh's -1 does.
__device__ __forceinline__ float gelu_tanh_fast(float h) {
  const float u2 = (2.f * kSqrt2OverPi) * (h + 0.044715f * h * h * h);
  return __fdividef(h, 1.f + __expf(-u2));
}

constexpr int kBM = 128;        // rows of an output tile: 64 per consumer warpgroup
constexpr int kBK = 64;         // contraction depth of a stage: 128 bytes, the swizzle span
constexpr int kConsumers = 2;   // warpgroups; the third warpgroup holds the producer thread
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kEpilogueGelu = 0;      // out = bf16(gelu_tanh(acc + bias))
constexpr int kEpilogueResidual = 1;  // out = bf16(f32(resid) + (acc + bias))
constexpr int kEpiloguePartial = 2;   // out = f32(acc): a row-parallel partial sum
// The output tile leaves (and the residual tile enters) through shared memory
// in boxes of 64 rows x 64 columns, 128-byte swizzled like the operands.
constexpr int kBoxBytes = 64 * 64 * 2;

// Columns of an output tile: N = 3072 and 768 are 16 and 4 whole tiles, and a
// B=128 batch's 198 row tiles make 24 and 6 whole waves of the card's 132 SMs;
// 256 (4.5 waves at N = 768, three stages instead of four) read 6-17% slower.
constexpr int kBN = 192;
constexpr int kABytes = kBM * kBK * 2;
constexpr int kStageBytes = (kBM + kBN) * kBK * 2;
constexpr int kStages = 4;
constexpr int kBoxes = kBN / 64;  // per consumer warpgroup
constexpr int kOutBytes = kConsumers * kBoxes * kBoxBytes;
// 160 + 48 KB of the SM's 227: the stages, the output tile, room to align them
// to 1024 bytes, and the barriers (a full and an empty one per stage, two for
// the residual tile)
constexpr int kSmemBytes = kStages * kStageBytes + kOutBytes + 1024 + (2 * kStages + 2) * 8;

template <int EPI>
__global__ void __launch_bounds__(kThreads, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_resid,
                 const __grid_constant__ CUtensorMap map_out, const float* __restrict__ bias,
                 float* __restrict__ out_f32, int m, int n, int k) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t stages = (shared_address(smem_raw) + 1023u) & ~1023u;
  const uint32_t out_tile = stages + kStages * kStageBytes;  // [warpgroup][box][64][64]
  const uint32_t full = out_tile + kOutBytes;                // producer -> consumers
  const uint32_t empty = full + 8 * kStages;                 // consumers -> producer
  const uint32_t resid_full = empty + 8 * kStages;           // the residual tile has landed
  const uint32_t resid_empty = resid_full + 8;               // the output tile has left
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      barrier_init(full + 8 * s, 1);                // the producer's arrive.expect_tx
      barrier_init(empty + 8 * s, kConsumers * 4);  // lane 0 of every consumer warp
    }
    barrier_init(resid_full, 1);
    barrier_init(resid_empty, kConsumers);  // thread 0 of every consumer warpgroup
    barrier_init_fence();
  }
  __syncthreads();

  const int n_tiles = (n + kBN - 1) / kBN;
  const int tiles = ((m + kBM - 1) / kBM) * n_tiles;
  const int k_steps = (k + kBK - 1) / kBK;
  const int warpgroup = threadIdx.x / 128;

  if (warpgroup == kConsumers) {
    registers_release<40>();
    if (threadIdx.x == 128 * kConsumers) {
      int s = 0;
      uint32_t parity = 1;  // fresh empty barriers let the first round pass
      uint32_t resid_parity = 1;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kBM;
        const int n0 = (tile % n_tiles) * kBN;
        for (int ks = 0; ks < k_steps; ++ks) {
          barrier_wait(empty + 8 * s, parity);
          barrier_arrive_expect(full + 8 * s, kStageBytes);
          const uint32_t a_tile = stages + s * kStageBytes;
          tma_load_2d(a_tile, &map_a, full + 8 * s, ks * kBK, m0);
          tma_load_2d(a_tile + kABytes, &map_b, full + 8 * s, ks * kBK, n0);
          if (++s == kStages) {
            s = 0;
            parity ^= 1;
          }
        }
        if (EPI == kEpilogueResidual) {
          // After the tile's operands: the consumers free the output tile of
          // the tile before early in this tile's sweep, and need the residual
          // only at its end.
          barrier_wait(resid_empty, resid_parity);
          resid_parity ^= 1;
          barrier_arrive_expect(resid_full, kOutBytes);
          for (int w = 0; w < kConsumers; ++w)
            for (int box = 0; box < kBoxes; ++box)
              tma_load_2d(out_tile + (w * kBoxes + box) * kBoxBytes, &map_resid, resid_full,
                          n0 + 64 * box, m0 + 64 * w);
        }
      }
    }
  } else {
    registers_acquire<232>();
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const bool leader = threadIdx.x % 128 == 0;  // starts the warpgroup's TMA stores
    // this warpgroup's part of the output tile, as a generic pointer
    const uint32_t out_wg = out_tile + warpgroup * kBoxes * kBoxBytes;
    unsigned char* out_ptr = smem_raw + (out_wg - shared_address(smem_raw));
    // the step of a tile's sweep at which the leader frees the output tile
    const int release_step = k_steps > 1 ? 1 : 0;
    bool stores_pending = false;
    float acc[kBN / 2];
    int s = 0;
    uint32_t parity = 0;
    uint32_t resid_parity = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * kBM;
      const int n0 = (tile % n_tiles) * kBN;
      int held = 0;  // the stage whose MMAs may still be running
      for (int ks = 0; ks < k_steps; ++ks) {
        barrier_wait(full + 8 * s, parity);
        const uint32_t a_tile = stages + s * kStageBytes;
        const uint64_t desc_a = operand_descriptor(a_tile + warpgroup * 64 * 128);
        const uint64_t desc_b = operand_descriptor(a_tile + kABytes);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j)  // 32 bytes along K = 2 descriptor units
          wgmma_m64n192k16(acc, desc_a + 2 * j, desc_b + 2 * j, (ks | j) != 0);
        wgmma_commit();
        if (ks == release_step && leader && stores_pending) {
          // the stores of the tile before have read the output tile by now
          tma_store_wait_read();
          if (EPI == kEpilogueResidual) barrier_arrive(resid_empty);
          stores_pending = false;
        }
        wgmma_wait<1>();  // the step before this one has finished: release its stage
        if (ks > 0 && lane == 0) barrier_arrive(empty + 8 * held);
        held = s;
        if (++s == kStages) {
          s = 0;
          parity ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) barrier_arrive(empty + 8 * held);
      accumulator_fence(acc);

      if (EPI == kEpiloguePartial) {
        // The f32 partial leaves straight from the accumulator registers: a
        // thread's two columns are one 8-byte store, and the four lanes of a
        // row fill a 32-byte sector. No bias, no rounding: the caller sums the
        // partials of every model rank first.
        const int row = m0 + 64 * warpgroup + warp * 16 + g;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          if (col >= n) continue;  // n is even: col + 1 < n too
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = row + 8 * half;
            if (r < m)
              *reinterpret_cast<float2*>(out_f32 + static_cast<size_t>(r) * n + col) =
                  make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
          }
        }
        continue;
      }
      // Epilogue on the accumulator registers (layout: hopper_mma.cuh),
      // through the output tile in shared memory: element (row r of the
      // warpgroup's 64, column c) lies in box c / 64 at byte
      // 128 r + 16 ((c % 64 / 8) ^ (r % 8)) + 2 (c % 8). The 8 rows x 4 lanes
      // of a warp touch 32 distinct banks.
      if (EPI == kEpilogueResidual) {
        barrier_wait(resid_full, resid_parity);
        resid_parity ^= 1;
      } else {
        warpgroup_sync(warpgroup);  // the leader has seen the last stores read the tile
      }
      const int r = warp * 16 + g;  // and r + 8; r % 8 = g
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        float2 b2 = make_float2(0.f, 0.f);
        if (col < n) b2 = *reinterpret_cast<const float2*>(bias + col);  // n is even
        unsigned char* pa = out_ptr + (j / 8) * kBoxBytes + r * 128 + (((j % 8) ^ g) << 4) + 4 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(pa + half * 8 * 128);
          float v0 = acc[4 * j + 2 * half] + b2.x;
          float v1 = acc[4 * j + 2 * half + 1] + b2.y;
          if (EPI == kEpilogueGelu) {
            v0 = gelu_tanh_fast(v0);
            v1 = gelu_tanh_fast(v1);
          } else {
            const float2 xv = __bfloat1622float2(*px);
            v0 = xv.x + v0;
            v1 = xv.y + v1;
          }
          *px = __floats2bfloat162_rn(v0, v1);
        }
      }
      async_proxy_fence();  // the writes above, before the TMA reads them
      warpgroup_sync(warpgroup);
      if (leader) {
        const int row0 = m0 + 64 * warpgroup;
        if (row0 < m) {  // the copy clips rows past m and columns past n of a box
          for (int box = 0; box < kBoxes; ++box)
            if (n0 + 64 * box < n)
              tma_store_2d(&map_out, out_wg + box * kBoxBytes, n0 + 64 * box, row0);
        }
        tma_store_commit();
        stores_pending = true;
      }
    }
    if (leader) tma_store_wait_read();  // shared memory outlives its last reader
  }
}

// out[m, n] = epilogue(a[m, k] . b[n, k]^T): the tensor maps are encoded per
// call (they hold the base pointers) and passed to the kernel by value.
template <int EPI>
int launch(const void* a, const void* b, const float* bias, const void* resid, void* out, int m,
           int n, int k, int device, cudaStream_t stream) {
  CUtensorMap map_a, map_b, map_resid, map_out;
  int err = vitad_tma::encode_matrix(&map_a, a, m, k, kBM);
  if (err == 0) err = vitad_tma::encode_matrix(&map_b, b, n, k, kBN);
  // the partial epilogue stores f32 without this map and never touches it
  if (err == 0) err = vitad_tma::encode_matrix(&map_out, out, m, n, 64);
  // without a residual the kernel never touches this map
  if (err == 0)
    err = vitad_tma::encode_matrix(&map_resid, EPI == kEpilogueResidual ? resid : out, m, n, 64);
  if (err != 0) return err;
  int sms = 0;
  cudaError_t cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  err = vitad_launch::raise_dynamic_smem(
      reinterpret_cast<const void*>(gemm_bf16_kernel<EPI>), kSmemBytes, device);
  if (err != 0) return err;
  const int tiles = ((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  gemm_bf16_kernel<EPI><<<tiles < sms ? tiles : sms, kThreads, kSmemBytes, stream>>>(
      map_a, map_b, map_resid, map_out, bias, static_cast<float*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

int run(int epilogue, const void* a, const void* b, const float* bias, const void* resid,
        void* out, int m, int n, int k, int device, cudaStream_t stream) {
  if (epilogue == kEpilogueGelu)
    return launch<kEpilogueGelu>(a, b, bias, resid, out, m, n, k, device, stream);
  if (epilogue == kEpilogueResidual)
    return launch<kEpilogueResidual>(a, b, bias, resid, out, m, n, k, device, stream);
  if (epilogue == kEpiloguePartial)
    return launch<kEpiloguePartial>(a, b, bias, resid, out, m, n, k, device, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace gemm

// ---- f32: the fused FMA kernel --------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;     // rows of x per block: two 16-row tiles
constexpr int kChunk = 128;   // hidden units per step of the sweep: 16 per warp
constexpr int kMaxDim = 1024;
// row pitch + 4 floats: the 8 rows of a float4 fragment load hit 32 banks
constexpr int kPad = 4;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

// acc[mi][ni] += A[16 mi .. +16, 0 .. 16 ksteps) x B[8 ni .. +8, 0 .. 16 ksteps)^T.
// A lies in shared memory with row pitch lda, B in global memory with row
// pitch ldb, both contiguous along the contraction. Accumulator layout (that
// of an m16n8 MMA tile, g = lane / 4, t = lane % 4): acc[mi][ni][0..1] are row
// 16 mi + g, columns 8 ni + 2t + {0, 1}; acc[mi][ni][2..3] are row
// 16 mi + g + 8, the same columns.
template <int NI>
__device__ __forceinline__ void product(float (&acc)[2][NI][4], const float* a, int lda,
                                        const float* b, size_t ldb, int ksteps, int g, int t) {
  const float* a0 = a + g * lda;
  const float* b0 = b + static_cast<size_t>(2 * t) * ldb;
  for (int k = 0; k < ksteps * 16; k += 4) {
    float4 av[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      av[mi][0] = *reinterpret_cast<const float4*>(a0 + mi * 16 * lda + k);
      av[mi][1] = *reinterpret_cast<const float4*>(a0 + (mi * 16 + 8) * lda + k);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const float* bp = b0 + static_cast<size_t>(ni) * 8 * ldb + k;
      const float4 bv0 = __ldg(reinterpret_cast<const float4*>(bp));
      const float4 bv1 = __ldg(reinterpret_cast<const float4*>(bp + ldb));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        acc[mi][ni][0] = dot4(av[mi][0], bv0, acc[mi][ni][0]);
        acc[mi][ni][1] = dot4(av[mi][0], bv1, acc[mi][ni][1]);
        acc[mi][ni][2] = dot4(av[mi][1], bv0, acc[mi][ni][2]);
        acc[mi][ni][3] = dot4(av[mi][1], bv1, acc[mi][ni][3]);
      }
    }
  }
}

template <int NI>
__device__ __forceinline__ void zero(float (&acc)[2][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <int NT>
constexpr size_t shared_bytes() {
  return static_cast<size_t>(kRows) * (64 * NT + kPad + kChunk + kPad) * sizeof(float);
}

// One block of 8 warps per tile of 32 rows, D = 64 NT: the LayerNorm output
// tile and one 128-wide chunk of GELU output at a time stay in shared memory,
// the [32, D] output accumulator in registers over the hidden sweep. Warp w
// owns 16 hidden units of a chunk and NT n-tiles of 8 output columns:
// [w D/8, (w + 1) D/8).
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
mlp_block_f32_kernel(const float* __restrict__ x, const float* __restrict__ norm_scale,
                     const float* __restrict__ norm_bias, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out, int rows, int hidden,
                     float eps) {
  constexpr int D = 64 * NT;
  constexpr int kLdY = D + kPad;
  constexpr int kLdG = kChunk + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ys = reinterpret_cast<float*>(smem_raw);  // [kRows][kLdY] LayerNorm output
  float* gs = ys + kRows * kLdY;                   // [kRows][kLdG] a chunk of GELU output
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = blockIdx.x * kRows;

  // 1. LayerNorm, one warp per row; lane l holds columns 64 j + 2 l + {0, 1}
#pragma unroll 1
  for (int i = 0; i < kRows / kWarps; ++i) {
    const int lr = warp * (kRows / kWarps) + i;
    const int r = r0 + lr;
    float* yrow = ys + lr * kLdY;
    if (r < rows) {  // the same for the whole warp
      const float* xr = x + static_cast<size_t>(r) * D;
      float v[NT][2];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 p = *reinterpret_cast<const float2*>(xr + 64 * j + 2 * lane);
        v[j][0] = p.x;
        v[j][1] = p.y;
        sum += p.x + p.y;
      }
      const float mean = warp_sum(sum) / static_cast<float>(D);
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float c0 = v[j][0] - mean, c1 = v[j][1] - mean;
        sq += c0 * c0 + c1 * c1;
      }
      const float rstd = 1.f / sqrtf(warp_sum(sq) / static_cast<float>(D) + eps);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = 64 * j + 2 * lane;
        store2(yrow + c, ((v[j][0] - mean) * rstd) * norm_scale[c] + norm_bias[c],
               ((v[j][1] - mean) * rstd) * norm_scale[c + 1] + norm_bias[c + 1]);
      }
    } else {  // rows past R are zeros here and are never stored
#pragma unroll
      for (int j = 0; j < NT; ++j) store2(yrow + 64 * j + 2 * lane, 0.f, 0.f);
    }
  }
  __syncthreads();

  float acc[2][NT][4];
  zero<NT>(acc);
#pragma unroll 1
  for (int c0 = 0; c0 < hidden; c0 += kChunk) {
    // 2. hidden units c0 + 16 warp .. + 16 of all rows
    float h[2][2][4];
    zero<2>(h);
    const int n1 = warp * 16;
    product<2>(h, ys, kLdY, w1 + static_cast<size_t>(c0 + n1) * D, D, D / 16, g, t);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int col = n1 + ni * 8 + 2 * t;
        const float bias0 = b1[c0 + col], bias1 = b1[c0 + col + 1];
        float* gp = gs + (mi * 16 + g) * kLdG + col;
        store2(gp, gelu_tanh(h[mi][ni][0] + bias0), gelu_tanh(h[mi][ni][1] + bias1));
        store2(gp + 8 * kLdG, gelu_tanh(h[mi][ni][2] + bias0), gelu_tanh(h[mi][ni][3] + bias1));
      }
    __syncthreads();
    // 3. this chunk's part of output columns warp D/8 .. + D/8
    product<NT>(acc, gs, kLdG, w2 + static_cast<size_t>(warp * NT * 8) * hidden + c0,
                static_cast<size_t>(hidden), kChunk / 16, g, t);
    __syncthreads();
  }

  // 4. bias, residual, store
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int col = warp * NT * 8 + ni * 8 + 2 * t;
      const float bias0 = b2[col], bias1 = b2[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + mi * 16 + g + 8 * half;
        if (r < rows) {
          const size_t o = static_cast<size_t>(r) * D + col;
          const float2 xv = *reinterpret_cast<const float2*>(x + o);
          store2(out + o, xv.x + (acc[mi][ni][2 * half] + bias0),
                 xv.y + (acc[mi][ni][2 * half + 1] + bias1));
        }
      }
    }
}

template <int NT>
int launch_f32(const float* x, const float* norm_scale, const float* norm_bias, const float* w1,
               const float* b1, const float* w2, const float* b2, float* out, int rows,
               int hidden, float eps, int device, cudaStream_t stream) {
  constexpr size_t bytes = shared_bytes<NT>();
  const int err = vitad_launch::raise_dynamic_smem(
      reinterpret_cast<const void*>(mlp_block_f32_kernel<NT>), bytes, device);
  if (err != 0) return err;
  const unsigned blocks = (static_cast<unsigned>(rows) + kRows - 1) / kRows;
  mlp_block_f32_kernel<NT><<<blocks, kThreads, bytes, stream>>>(
      x, norm_scale, norm_bias, w1, b1, w2, b2, out, rows, hidden, eps);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(int d, const float* x, const float* norm_scale, const float* norm_bias,
                 const float* w1, const float* b1, const float* w2, const float* b2, float* out,
                 int rows, int hidden, float eps, int device, cudaStream_t stream) {
#define VITAD_MLP_CASE(NT)                                                                     \
  case 64 * NT:                                                                                \
    return launch_f32<NT>(x, norm_scale, norm_bias, w1, b1, w2, b2, out, rows, hidden, eps,    \
                          device, stream)
  switch (d) {
    VITAD_MLP_CASE(2);
    VITAD_MLP_CASE(4);
    VITAD_MLP_CASE(6);
    VITAD_MLP_CASE(8);
    VITAD_MLP_CASE(10);
    VITAD_MLP_CASE(12);
    VITAD_MLP_CASE(14);
    VITAD_MLP_CASE(16);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VITAD_MLP_CASE
}

// What mlp_block_forward reports as the kernels it launched.
constexpr int kRouteWgmma = 1, kRouteFma = 2;

}  // namespace

// Plain C entry point, bound with ctypes. x and out are contiguous [rows, d]
// device buffers, w1 [hidden, d] and w2 [d, hidden] contiguous, all of bf16
// (is_bf16 != 0) or f32 and 16-byte aligned; norm_scale, norm_bias, b2 are f32
// [d], b1 f32 [hidden]. d is a multiple of 128 up to 1024, hidden a multiple of
// 128. Under bf16, y [rows, d] and hid [rows, hidden] are bf16 scratch buffers
// of the caller (unused under f32) and the three kernels k0, k1, k2 of the
// header are launched in turn; under f32 the one fused kernel. The branch that
// launches writes which it was to the host int `route` (1 the three bf16
// kernels with the products on wgmma, 2 the fused FMA kernel; 0 unless every
// launch went through). Launches on
// `stream` without synchronising and returns 0, or the first launch's
// cudaGetLastError(), or a tensor-map error (2001: libcuda has no
// cuTensorMapEncodeTiled; 3000 + CUresult: it refused the map).
extern "C" int mlp_block_forward(const void* x, const void* norm_scale, const void* norm_bias,
                                 const void* w1, const void* b1, const void* w2, const void* b2,
                                 void* out, void* y, void* hid, int rows, int d, int hidden,
                                 float eps, int is_bf16, int device, void* stream, int* route) {
  if (route == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *route = 0;
  if (rows < 1 || d < 128 || d > kMaxDim || d % 128 != 0 || hidden < kChunk ||
      hidden % kChunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ns = static_cast<const float*>(norm_scale);
  const float* nb = static_cast<const float*>(norm_bias);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  if (!is_bf16) {
    const int rc =
        dispatch_f32(d, static_cast<const float*>(x), ns, nb, static_cast<const float*>(w1), fb1,
                     static_cast<const float*>(w2), fb2, static_cast<float*>(out), rows, hidden,
                     eps, device, st);
    if (rc == 0) *route = kRouteFma;
    return rc;
  }
  if (y == nullptr || hid == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int rc = vitad_layer_norm::run(x, ns, nb, y, rows, d, eps, true, st);
  if (rc != 0) return rc;
  rc = gemm::run(gemm::kEpilogueGelu, y, w1, fb1, nullptr, hid, rows, hidden, d, device, st);
  if (rc != 0) return rc;
  rc = gemm::run(gemm::kEpilogueResidual, hid, w2, fb2, x, out, rows, d, hidden, device, st);
  if (rc == 0) *route = kRouteWgmma;
  return rc;
}

// One product of the bf16 half-block alone (what k1 and k2 run), and the
// row-parallel step of a model-axis shard: out [m, n] = epilogue(a [m, k] .
// b [n, k]^T) with epilogue 0 = bf16(gelu_tanh(. + bias [n])), 1 =
// bf16(resid [m, n] + (. + bias)), 2 = the f32 sums alone (no bias, no
// residual; out is then f32). a, b, resid and out are contiguous and 16-byte
// aligned, a, b and resid bf16, bias f32 (unread by epilogue 2); n and k are
// multiples of 8. On a launch it writes epilogue + 1 to the host int `route`
// (0 unless the launch went through). Returns as mlp_block_forward does.
extern "C" int mlp_gemm_forward(const void* a, const void* b, const void* bias, const void* resid,
                                void* out, int m, int n, int k, int epilogue, int device,
                                void* stream, int* route) {
  if (route == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *route = 0;
  if (m < 1 || n < 8 || k < 8 || n % 8 != 0 || k % 8 != 0 || epilogue < 0 ||
      epilogue > gemm::kEpiloguePartial ||
      (epilogue != gemm::kEpiloguePartial && bias == nullptr) ||
      (epilogue == gemm::kEpilogueResidual && resid == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = gemm::run(epilogue, a, b, static_cast<const float*>(bias), resid, out, m, n, k,
                           device, static_cast<cudaStream_t>(stream));
  if (rc == 0) *route = epilogue + 1;
  return rc;
}
