// Fused pre-LN MLP half-block of a ViT block (B6) for Hopper (sm_90a).
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
// contraction, which is the column-major B operand of mma.sync: no transposed
// copy exists. Neither the LayerNorm output nor the [R, H] hidden activations
// leave the chip.
//
// What bounds it on the H100: operations. At the DeiT-base shape of a B=128
// batch (R = 25,344, D = 768, H = 3072) the two products are 4 R D H = 239
// GFLOP, 0.242 ms at the 989 TFLOP/s bf16 peak, against 26 us for the bytes (x
// in and out 78 MB, weights 9.4 MB). The TPU design kept both weight matrices
// resident on chip across the row sweep; an SM has 227 KB of shared memory and
// the weights are 9.4 MB, so here every block streams W1 and W2 from L2, and
// the [rows, D] f32 output accumulator must stay in registers across the whole
// hidden sweep. That accumulator sets the tile: 32 rows x D over 8 warps is
// D/8 registers a thread (96 at D = 768, 128 at D = 1024, the widest taken);
// 64 rows would need twice that and spill.
//
// Structure: one block of 8 warps per tile of 32 rows.
//   1. LayerNorm: one warp per row (four rows each), the row in registers
//      between the three sweeps, two warp-shuffle reductions; the normalised
//      tile is kept in shared memory in T. Rows past R are zeros there and
//      are never stored (masked, not padded by a copy).
//   2. The hidden dimension in chunks of 128: warp w computes hidden units
//      [16 w, 16 w + 16) of the chunk for all 32 rows (contraction over D, A
//      from shared memory, B fragments read straight from W1 in L2 through
//      the read-only path: thread (g, t) reads the 4 bytes W1[n + g][k + 2t],
//      a 32-byte sector per row over the two loads of a k-step), adds b1,
//      applies the tanh GELU in f32, rounds to T into shared memory.
//   3. Warp w then adds the chunk's contribution to output columns
//      [w D/8, (w + 1) D/8) for all 32 rows (A = the chunk's activations in
//      shared memory, B fragments from W2, a 128-byte line per row and chunk).
//   4. After the sweep: + b2 + xf (x read again), round, store.
// bf16 products are mma.sync m16n8k16 with f32 accumulation; the f32
// instantiation does the same sums by FMA in the same register layout (TF32
// stays off), for the tight comparison with the plain version. Weight traffic
// is (R/32) x 9.4 MB per launch from L2 and B fragments are not reused across
// more than two MMAs, so this first version is bound by its loads and by
// mma.sync issue, far from the operations bound; wgmma with B in shared memory
// behind TMA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;     // rows of x per block: two m16 tiles
constexpr int kChunk = 128;   // hidden units per step of the sweep: 16 per warp
constexpr int kMaxDim = 1024;
constexpr float kSqrt2OverPi = 0.7978845608028654f;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  // row pitch D + 4 floats: the 8 rows of a float4 fragment load hit 32 banks
  static constexpr int kPad = 4;
  static __device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
template <>
struct Elem<__nv_bfloat16> {
  // row pitch D + 8 bf16 (16 bytes): the 32-bit fragment loads of a warp hit
  // 32 distinct banks
  static constexpr int kPad = 8;
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

__device__ __forceinline__ float gelu_tanh(float h) {
  const float inner = kSqrt2OverPi * (h + 0.044715f * h * h * h);
  return 0.5f * h * (1.f + tanhf(inner));
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const uint16_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
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

// acc[mi][ni] += A[16 mi .. +16, 0 .. 16 ksteps) x B[8 ni .. +8, 0 .. 16 ksteps)^T.
// A lies in shared memory with row pitch lda, B in global memory with row
// pitch ldb, both contiguous along the contraction. Accumulator layout (the
// mma.sync one, also used by the f32 version): acc[mi][ni][0..1] are row
// 16 mi + g, columns 8 ni + 2t + {0, 1}; acc[mi][ni][2..3] are row
// 16 mi + g + 8, the same columns.
template <int NI>
__device__ __forceinline__ void product(float (&acc)[2][NI][4], const __nv_bfloat16* a,
                                        int lda, const __nv_bfloat16* b, size_t ldb,
                                        int ksteps, int g, int t) {
  const uint16_t* a0 = reinterpret_cast<const uint16_t*>(a) + g * lda + 2 * t;
  const uint16_t* b0 = reinterpret_cast<const uint16_t*>(b) + g * ldb + 2 * t;
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const uint16_t* ap = a0 + mi * 16 * lda + ks * 16;
      af[mi][0] = lds32(ap);
      af[mi][1] = lds32(ap + 8 * lda);
      af[mi][2] = lds32(ap + 8);
      af[mi][3] = lds32(ap + 8 * lda + 8);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const uint16_t* bp = b0 + static_cast<size_t>(ni) * 8 * ldb + ks * 16;
      const uint32_t f0 = ldg32(bp);
      const uint32_t f1 = ldg32(bp + 8);
      mma_bf16(acc[0][ni], af[0], f0, f1);
      mma_bf16(acc[1][ni], af[1], f0, f1);
    }
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

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

template <typename T, int NT>
constexpr size_t shared_bytes() {
  return static_cast<size_t>(kRows) * (64 * NT + Elem<T>::kPad + kChunk + Elem<T>::kPad) *
         sizeof(T);
}

// D = 64 NT. Warp w owns NT n-tiles of 8 output columns: [w D/8, (w + 1) D/8).
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1)
mlp_block_kernel(const T* __restrict__ x, const float* __restrict__ norm_scale,
                 const float* __restrict__ norm_bias, const T* __restrict__ w1,
                 const float* __restrict__ b1, const T* __restrict__ w2,
                 const float* __restrict__ b2, T* __restrict__ out, int rows, int hidden,
                 float eps) {
  constexpr int D = 64 * NT;
  constexpr int kLdY = D + Elem<T>::kPad;
  constexpr int kLdG = kChunk + Elem<T>::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ys = reinterpret_cast<T*>(smem_raw);  // [kRows][kLdY] LayerNorm output
  T* gs = ys + kRows * kLdY;               // [kRows][kLdG] a chunk of GELU output
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
    T* yrow = ys + lr * kLdY;
    if (r < rows) {  // the same for the whole warp
      const T* xr = x + static_cast<size_t>(r) * D;
      float v[NT][2];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 p = Elem<T>::load2(xr + 64 * j + 2 * lane);
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
        Elem<T>::store2(yrow + c,
                        ((v[j][0] - mean) * rstd) * norm_scale[c] + norm_bias[c],
                        ((v[j][1] - mean) * rstd) * norm_scale[c + 1] + norm_bias[c + 1]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) Elem<T>::store2(yrow + 64 * j + 2 * lane, 0.f, 0.f);
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
        T* gp = gs + (mi * 16 + g) * kLdG + col;
        Elem<T>::store2(gp, gelu_tanh(h[mi][ni][0] + bias0), gelu_tanh(h[mi][ni][1] + bias1));
        Elem<T>::store2(gp + 8 * kLdG, gelu_tanh(h[mi][ni][2] + bias0),
                        gelu_tanh(h[mi][ni][3] + bias1));
      }
    __syncthreads();
    // 3. this chunk's part of output columns warp D/8 .. + D/8
    product<NT>(acc, gs, kLdG, w2 + static_cast<size_t>(warp * NT * 8) * hidden + c0,
                static_cast<size_t>(hidden), kChunk / 16, g, t);
    __syncthreads();
  }

  // 4. bias, residual on the f32 x, round, store
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
          const float2 xv = Elem<T>::load2(x + o);
          Elem<T>::store2(out + o, xv.x + (acc[mi][ni][2 * half] + bias0),
                          xv.y + (acc[mi][ni][2 * half + 1] + bias1));
        }
      }
    }
}

template <typename T, int NT>
int launch(const void* x, const float* norm_scale, const float* norm_bias, const void* w1,
           const float* b1, const void* w2, const float* b2, void* out, int rows, int hidden,
           float eps, cudaStream_t stream) {
  constexpr size_t bytes = shared_bytes<T, NT>();
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_block_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = (static_cast<unsigned>(rows) + kRows - 1) / kRows;
  mlp_block_kernel<T, NT><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), norm_scale, norm_bias, static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, static_cast<T*>(out), rows, hidden, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* x, const float* norm_scale, const float* norm_bias,
             const void* w1, const float* b1, const void* w2, const float* b2, void* out,
             int rows, int hidden, float eps, cudaStream_t stream) {
#define VITAD_MLP_CASE(NT)                                                                    \
  case 64 * NT:                                                                               \
    return launch<T, NT>(x, norm_scale, norm_bias, w1, b1, w2, b2, out, rows, hidden, eps,    \
                         stream)
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

}  // namespace

// Plain C entry point, bound with ctypes. x and out are contiguous [rows, d]
// device buffers, w1 [hidden, d] and w2 [d, hidden] contiguous, all of bf16
// (is_bf16 != 0) or f32 and 16-byte aligned; norm_scale, norm_bias, b2 are f32
// [d], b1 f32 [hidden]. d is a multiple of 128 up to 1024, hidden a multiple of
// 128. Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int mlp_block_forward(const void* x, const void* norm_scale, const void* norm_bias,
                                 const void* w1, const void* b1, const void* w2, const void* b2,
                                 void* out, int rows, int d, int hidden, float eps, int is_bf16,
                                 int device, void* stream) {
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
  if (is_bf16)
    return dispatch<__nv_bfloat16>(d, x, ns, nb, w1, fb1, w2, fb2, out, rows, hidden, eps, st);
  return dispatch<float>(d, x, ns, nb, w1, fb1, w2, fb2, out, rows, hidden, eps, st);
}
