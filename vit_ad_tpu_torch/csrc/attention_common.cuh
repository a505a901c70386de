// Device code shared by the port's attention kernels (sm_90a):
// vit_attention_qkv.cu (packed-qkv MHSA of the ViT/DeiT blocks) and
// swin_window_attention.cu ((shifted-)window attention of the Swin blocks).
//
// Both compute, per (batch entry, head), softmax(q*scale k^T [+ bias + mask]) v
// for N <= 256 tokens with the head's K and V rows staged once in shared
// memory, f32 scores and softmax, and the probabilities rounded to the input
// dtype exactly where the TPU kernels round them:
//
//   kDefer = false  the NORMALISED probabilities exp(s - m) / l are rounded
//                   before PV (vit_ad_tpu/ops/pallas/window_attention.py
//                   _kernel_qkv :393-398 and _kernel :73-79);
//   kDefer = true   the UNNORMALISED exp(s - m) is rounded, PV accumulates in
//                   f32 and the result is multiplied by 1 / l, the f32 sum of
//                   the unrounded exponentials (_kernel_win :246-255).
//
// bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulate): a warp
// owns 16 query rows. f32 runs on the CUDA cores (FMA): a thread owns one row.
// N fits no MMA tile (198, 196, 49): keys are padded with zero rows in shared
// memory and their scores set to -inf; a finite bias or mask added to -inf
// leaves it -inf, so the order of the two does not matter, and no bias or mask
// element past N is ever read.
//
// Two bf16 forms are built from this header. `attend_tile` is the first one: a
// two-pass softmax over chunks of 64 keys (pass 1: row max and row sum; pass
// 2: the scores again, exponentiate, round, PV), its B fragments read from
// shared memory by 32-bit loads (K) and by four 16-bit loads and two packs per
// MMA (V, which is needed transposed). Counted per warp and chunk that is 96
// MMAs behind 256 shared-memory load instructions: the loads, not the MMAs or
// the memory, set its pace. It serves only what the one-pass form cannot
// hold: the ViT kernel and the window kernels above 208 tokens (windows of
// 15^2 and 16^2). The one-pass form keeps a warp's 16 x N f32 scores in
// registers over one QK^T pass (N <= 208: 26 key tiles of 8, 104 registers a
// thread), from the building blocks below `attend_tile` (`cp_async_16`,
// `ldmatrix_x4`, `ldmatrix_x4_trans`, `exp2_approx`, `scale_bf16x2`):
// staging by cp.async so that loads overlap, and matrix-fragment loads that
// fill the B operands of two MMAs (four 8x8 tiles) with one instruction,
// transposing V on the way. Each source holds its one-pass kernel:
// vit_attention_qkv.cu `attention_one_pass_kernel` (no bias) and
// swin_window_attention.cu `window_one_pass` (bias and mask added to the
// register scores; blocks that pair windows sharing a head and a mask row).
// Both kernels are bound by bytes (the ViT one 46 us at B=128, N=198, the Swin
// one 93 us at stage 0: qkv read once, the output written once). Measured on
// an NVIDIA H100 80GB HBM3 at 700 W, back to back (PERF.md section 6 has the
// runs): the ViT attention 0.201 ms a call through `attend_tile`, 0.110 through
// the one-pass kernel; the Swin attention at stage 0 (shift mask) 1.23 ms
// through `attend_tile`, 0.686 through the one-pass kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vitad_attention {

constexpr int kMaxTokens = 256;

// ---- bf16: mma.sync tensor-core path ---------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;                 // one m16 tile per warp
constexpr int kQTile = kWarps * kRowsPerWarp;    // 128 query rows per block pass
constexpr int kKeyChunk = 64;                    // keys per softmax chunk
constexpr float kLog2e = 1.4426950408889634f;

// keys padded to whole chunks
__host__ __device__ __forceinline__ int padded_keys(int n) {
  return (n + kKeyChunk - 1) / kKeyChunk * kKeyChunk;
}

// dynamic shared memory of one block: K and V of one head, row pitch HD + 8
inline size_t bf16_smem_bytes(int n, int head_dim) {
  return 2 * static_cast<size_t>(padded_keys(n)) * (head_dim + 8) * sizeof(uint16_t);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // one cvt.rn.bf16x2.f32
  return *reinterpret_cast<const uint32_t*>(&v);
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

// Stage one head's K and V rows into shared memory (row pitch HD + 8: rows
// stay 16-byte aligned and the fragment loads touch 32 distinct banks), 16
// bytes per load, zeros past n (a zero V row keeps 0 * garbage from turning
// into NaN). `k` and `v` point at row 0 of the head's slice; consecutive rows
// are `row_stride` elements apart. The caller synchronises the block.
template <int HD>
__device__ __forceinline__ void stage_kv(uint16_t* ks, uint16_t* vs, const uint16_t* k,
                                         const uint16_t* v, size_t row_stride, int n, int np) {
  constexpr int LD = HD + 8;
  constexpr int kVec = 8;
  constexpr int kChunksPerRow = HD / kVec;
  for (int i = threadIdx.x; i < np * kChunksPerRow; i += blockDim.x) {
    const int r = i / kChunksPerRow;
    const int col = (i % kChunksPerRow) * kVec;
    uint4 kv = make_uint4(0, 0, 0, 0);
    uint4 vv = make_uint4(0, 0, 0, 0);
    if (r < n) {
      kv = *reinterpret_cast<const uint4*>(k + r * row_stride + col);
      vv = *reinterpret_cast<const uint4*>(v + r * row_stride + col);
    }
    *reinterpret_cast<uint4*>(ks + r * LD + col) = kv;
    *reinterpret_cast<uint4*>(vs + r * LD + col) = vv;
  }
}

// A fragments of q*scale (rounded to bf16) for query rows ra and rb = ra + 8,
// straight from device memory. Register j holds row (j&1 ? rb : ra), columns
// 2t+{0,1} (+8 when j&2). Rows past n are zero. `q` points at row 0 of the
// head's slice.
template <int HD>
__device__ __forceinline__ void load_q_fragments(uint32_t (&qa)[HD / 16][4], const uint16_t* q,
                                                 size_t row_stride, int ra, int rb, int n,
                                                 int t, float scale) {
#pragma unroll
  for (int kstep = 0; kstep < HD / 16; ++kstep) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (j & 1) ? rb : ra;
      const int col = kstep * 16 + t * 2 + ((j & 2) ? 8 : 0);
      float lo = 0.f, hi = 0.f;
      if (r < n) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(q + r * row_stride + col);
        lo = __bfloat162float(__ushort_as_bfloat16(static_cast<uint16_t>(v & 0xffff))) * scale;
        hi = __bfloat162float(__ushort_as_bfloat16(static_cast<uint16_t>(v >> 16))) * scale;
      }
      qa[kstep][j] = pack_bf16(lo, hi);
    }
  }
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

// s += bias (+ mask) for the keys of one chunk below n. bias_a / bias_b (and
// mask_a / mask_b, or nullptr) point at the f32 [n] rows of this thread's two
// query rows; (s + bias) + mask, the TPU kernel's order.
__device__ __forceinline__ void add_bias_chunk(float (&s)[kKeyChunk / 8][4], const float* bias_a,
                                               const float* bias_b, const float* mask_a,
                                               const float* mask_b, int kc, int t, int n) {
#pragma unroll
  for (int nt = 0; nt < kKeyChunk / 8; ++nt) {
    const int key = kc + nt * 8 + t * 2;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (key + j < n) {
        s[nt][j] += bias_a[key + j];
        s[nt][2 + j] += bias_b[key + j];
        if (mask_a != nullptr) {
          s[nt][j] += mask_a[key + j];
          s[nt][2 + j] += mask_b[key + j];
        }
      }
    }
  }
}

// Attention output of one warp's 16 query rows (fragments `qa`) against the
// staged keys: o[dn][0..1] are row g, columns dn*8+2t+{0,1}; o[dn][2..3] row
// g+8. With kBias the f32 bias rows (and mask rows, unless nullptr) of the
// thread's two query rows are added to the scores in both passes.
template <int HD, bool kDefer, bool kBias>
__device__ __forceinline__ void attend_tile(float (&o)[HD / 8][4],
                                            const uint32_t (&qa)[HD / 16][4],
                                            const uint16_t* ks, const uint16_t* vs, int n, int np,
                                            const float* bias_a, const float* bias_b,
                                            const float* mask_a, const float* mask_b, int g,
                                            int t) {
  constexpr int LD = HD + 8;
  // Pass 1: row max and row sum of exp(s - max), f32.
  float s[kKeyChunk / 8][4];
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  for (int kc = 0; kc < np; kc += kKeyChunk) {
    score_chunk<HD>(s, qa, ks, kc, g, t, n);
    if (kBias) add_bias_chunk(s, bias_a, bias_b, mask_a, mask_b, kc, t, n);
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
    // chunk 0 holds key 0 (finite, bias and the -100 mask included), so the
    // new max is finite from the first chunk on
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
  // the probability of score x in row a / b as it is rounded before PV:
  // normalised, or (kDefer) the bare exponential
  const float pre_a = kDefer ? 1.f : inv_a, pre_b = kDefer ? 1.f : inv_b;
  auto prob_a = [&](float x) { return exp2f(fmaf(x, kLog2e, -off_a)) * pre_a; };
  auto prob_b = [&](float x) { return exp2f(fmaf(x, kLog2e, -off_b)) * pre_b; };

  // Pass 2: probabilities, rounded to bf16, times V.
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  for (int kc = 0; kc < np; kc += kKeyChunk) {
    score_chunk<HD>(s, qa, ks, kc, g, t, n);
    if (kBias) add_bias_chunk(s, bias_a, bias_b, mask_a, mask_b, kc, t, n);
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
  if (kDefer) {
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      o[dn][0] *= inv_a;
      o[dn][1] *= inv_a;
      o[dn][2] *= inv_b;
      o[dn][3] *= inv_b;
    }
  }
}

// Store one warp's output tile, rounded to bf16. `out` points at row 0 of the
// head's slice; rows are `c` elements apart.
template <int HD>
__device__ __forceinline__ void store_tile(uint16_t* out, size_t c, int ra, int rb, int n, int t,
                                           const float (&o)[HD / 8][4]) {
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    const int col = dn * 8 + t * 2;
    if (ra < n)
      *reinterpret_cast<uint32_t*>(out + ra * c + col) = pack_bf16(o[dn][0], o[dn][1]);
    if (rb < n)
      *reinterpret_cast<uint32_t*>(out + rb * c + col) = pack_bf16(o[dn][2], o[dn][3]);
  }
}

// ---- bf16: cp.async staging and matrix-fragment loads -----------------------

__device__ __forceinline__ uint32_t shared_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory without passing through
// registers; both addresses 16-byte aligned. Completion by commit / wait.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending committed groups of this thread are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8x8 bf16 tiles from shared memory: lanes 8 i .. 8 i + 7 give the
// 16-byte aligned addresses of the rows of tile i, and every lane (g = lane /
// 4, t = lane % 4) receives r[i] = tile i [g][2t .. 2t + 1]: the layout of an
// mma.sync A fragment, and of a B fragment when the tile's rows run along n.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The same with every tile transposed: r[i] = tile i [2t .. 2t + 1][g], a B
// fragment when the tile's rows run along k (V [key][d] for PV).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// 2^x by the special-function unit (2 ulp; results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two packed bf16 values times `scale` in f32, rounded back to bf16: q*scale
// as `load_q_fragments` rounds it.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float scale) {
  return pack_bf16(__uint_as_float(v << 16) * scale, __uint_as_float(v & 0xffff0000u) * scale);
}

// ---- f32: FMA path ----------------------------------------------------------

constexpr int kF32Threads = 128;  // one query row per thread

inline size_t f32_smem_bytes(int n, int head_dim) {
  return 2 * static_cast<size_t>(n) * head_dim * sizeof(float);
}

// Stage one head's K and V rows (f32, row pitch HD), 16 bytes per load.
template <int HD>
__device__ __forceinline__ void stage_kv_f32(float* ks, float* vs, const float* k, const float* v,
                                             size_t row_stride, int n) {
  constexpr int kVec = 4;
  constexpr int kChunksPerRow = HD / kVec;
  for (int i = threadIdx.x; i < n * kChunksPerRow; i += blockDim.x) {
    const int r = i / kChunksPerRow;
    const int col = (i % kChunksPerRow) * kVec;
    *reinterpret_cast<float4*>(ks + r * HD + col) =
        *reinterpret_cast<const float4*>(k + r * row_stride + col);
    *reinterpret_cast<float4*>(vs + r * HD + col) =
        *reinterpret_cast<const float4*>(v + r * row_stride + col);
  }
}

// One query row (q already times scale) against the staged keys; `bias_row`
// and `mask_row` (or nullptr) are the row's f32 [n] bias and mask. Every
// thread of a warp reads the same K row: a shared-memory broadcast.
template <int HD, bool kDefer, bool kBias>
__device__ __forceinline__ void attend_row_f32(float (&o)[HD], const float (&q)[HD],
                                               const float* ks, const float* vs, int n,
                                               const float* bias_row, const float* mask_row) {
  auto score = [&](int j) {
    const float* kr = ks + j * HD;
    float sc = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) sc = fmaf(q[d], kr[d], sc);
    if (kBias) {
      sc += bias_row[j];
      if (mask_row != nullptr) sc += mask_row[j];
    }
    return sc;
  };
  // Pass 1: online row max and sum.
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < n; ++j) {
    const float sc = score(j);
    if (sc > m) {
      l = l * expf(m - sc) + 1.f;
      m = sc;
    } else {
      l += expf(sc - m);
    }
  }
  // Pass 2: probabilities times V.
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float e = expf(score(j) - m);
    const float p = kDefer ? e : e / l;
    const float* vr = vs + j * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = fmaf(p, vr[d], o[d]);
  }
  if (kDefer) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] *= inv;
  }
}

}  // namespace vitad_attention
