// One coupling step of the normalizing flow's tail for Hopper (sm_90a): F1.
//
// Ports no TPU kernel: the JAX flow (vit_ad_tpu/models/flow.py `_step_apply`)
// leaves this elementwise tail to XLA, which fuses it. In eager PyTorch the
// same tail was some two dozen launches a step (mul, add, atan, exp,
// logaddexp, log, two sums, cat, index_select and copies), half of them
// strided passes over channel slices. This kernel is that tail in one launch.
//
// For one step of an AllInOneBlock (models/flow.py), with C = c1 + c2 channels
// carried as two plane-contiguous halves x1 [B, c1, H, W] and x2 [B, c2, H, W],
// the output of the subnet's second convolution before its bias a [B, 2 c2,
// H, W], that bias [2 c2], the global scale g and offset o [C] and the
// permutation perm [C], it computes in f32, with the rounding points of the
// plain step on the card:
//
//   a' = a + bias                            (the add PyTorch makes after a
//                                             cuDNN convolution, one pass less)
//   s  = coeff * atanf(0.1f * a'[:, :c2])    (coeff = clamp * 0.636)
//   t  = 0.1f * a'[:, c2:]
//   x2' = x2 * expf(s) + t                   (a multiply, then an add: no FMA)
//   scale = 0.2f * logaddexp(0, 0.5f * g)    (PyTorch's logaddexp formula)
//   out[:, i] = cat(x1, x2')[:, perm[i]] * scale[perm[i]] + o[perm[i]]
//   logdet[b] = sum(s[b]) + H W * sum_c logf(scale[c])
//
// and stores out[:, :c1] to y1 [B, c1, H, W] and out[:, c1:] to y2 [B, c2, H,
// W], each written once at its permuted place: the halves the next step reads
// (its first convolution takes y1 as it is). No cat, no gather.
//
// What bounds it on the H100: bytes. Each element of x1, x2 and a is read once
// and each of y written once, ~20 flops per coupled element against 16 bytes
// (DeiT-base NF at B = 128, [128, 768, 14, 14]: 231 MB, 69 us at 3.35 TB/s).
// So the kernel reads each plane once with 16-byte loads where a plane's
// length H W is a multiple of 4 (scalar loads otherwise: 7 x 7 maps), keeps the
// step's per-channel scale, offset and source index in shared memory, and
// reduces the logdet without a second pass and without float atomics: the
// blocks of one image form a thread-block cluster, each block sums its share
// of s in a fixed order into its shared memory, and after a cluster barrier the
// first block reads the others' partials through distributed shared memory,
// in rank order. A batch scores the same on every run.
//
// Grid: one cluster of kMaxCluster (8, fewer for C < 8) blocks per image,
// block r of the cluster taking output channels [r * chunk, (r + 1) * chunk).
// The block's threads tile the plane: `lanes` threads along a plane (its
// vectors rounded up to whole warps, up to the block size), `planes` planes at
// once, both read from H W. The block size is 512 threads, and 1024 where the
// batch's blocks are fewer than the card's SMs (small batches of large maps),
// so that more of each image is in flight. Measured on an NVIDIA H100 80GB
// HBM3 at 700 W, back to back, against a device copy moving as many bytes
// (PERF.md): 0.1148 ms at [128, 768, 14, 14] (lanes not rounded to warps
// 0.1193; 256 threads 0.1269, 1024 threads 0.1744; copy 0.0792), 0.0599 ms at
// [8, 256, 56, 56] with 1024 threads (512 threads 0.0929; copy 0.0289), 0.0199
// ms at [32, 768, 7, 7] with 512 (1024 threads 0.0285). Taking a block's
// coupled planes before its passed-through ones was slower (0.1312 ms).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;
constexpr int kThreads = 512;       // a block
constexpr int kWideThreads = 1024;  // where the batch's blocks are fewer than the SMs
constexpr int kMaxWarps = kWideThreads / 32;
constexpr int kMaxChannels = 1 << 14;
constexpr int kRouteVector = 1;  // 16-byte loads and stores
constexpr int kRouteScalar = 2;

struct Args {
  const float* x1;
  const float* x2;
  const float* a;
  const float* bias;
  const float* g;
  const float* o;
  const long long* perm;
  float* y1;
  float* y2;
  float* logdet;
  long long x1_batch;  // batch strides of x1 and x2, in floats
  long long x2_batch;
  int c1, c2, hw;
  int nvec;    // vectors a plane
  int lanes;   // threads along a plane
  int planes;  // planes a block works on at once
  int chunk;   // output channels a block
  float coeff;
};

__device__ __forceinline__ float affine_scale(float g) {
  // 0.2 * logaddexp(0, 0.5 g) as PyTorch computes it: max(a, b) +
  // log1p(exp(-|a - b|)), each operation rounded on its own.
  const float h = __fmul_rn(0.5f, g);
  const float lse = __fadd_rn(fmaxf(0.0f, h), log1pf(expf(-fabsf(__fsub_rn(0.0f, h)))));
  return __fmul_rn(0.2f, lse);
}

template <int VEC>
struct Plane;

template <>
struct Plane<4> {
  static __device__ __forceinline__ void load(const float* p, int v, float (&x)[4]) {
    const float4 q = reinterpret_cast<const float4*>(p)[v];
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, int v, const float (&y)[4]) {
    reinterpret_cast<float4*>(p)[v] = make_float4(y[0], y[1], y[2], y[3]);
  }
};

template <>
struct Plane<1> {
  static __device__ __forceinline__ void load(const float* p, int v, float (&x)[1]) {
    x[0] = p[v];
  }
  static __device__ __forceinline__ void store(float* p, int v, const float (&y)[1]) {
    p[v] = y[0];
  }
};

// Sum over the block in a fixed order (a shuffle tree a warp, then the warps'
// sums in order by thread 0); the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, nwarps = (blockDim.x + 31) >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < nwarps; ++w) total = __fadd_rn(total, scratch[w]);
  __syncthreads();
  return total;
}

template <int VEC, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS) flow_coupling_kernel(const Args args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* scale_s = reinterpret_cast<float*>(smem_raw);  // [chunk]
  float* offset_s = scale_s + args.chunk;                // [chunk]
  int* src_s = reinterpret_cast<int*>(offset_s + args.chunk);  // [chunk]
  float* scratch = reinterpret_cast<float*>(src_s + args.chunk);  // [kMaxWarps]
  __shared__ float partial;  // this block's sum of s, read by rank 0 of the cluster

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int c1 = args.c1, c2 = args.c2, channels = c1 + c2;
  const int k0 = rank * args.chunk;
  const int k1 = min(channels, k0 + args.chunk);
  const size_t hw = static_cast<size_t>(args.hw);

  for (int k = threadIdx.x; k < k1 - k0; k += blockDim.x) {
    const long long src = args.perm[k0 + k];
    if (src < 0 || src >= channels) __trap();  // not a permutation of the channels
    src_s[k] = static_cast<int>(src);
    scale_s[k] = affine_scale(args.g[src]);
    offset_s[k] = args.o[src];
  }
  __syncthreads();

  const float* x1 = args.x1 + b * args.x1_batch;
  const float* x2 = args.x2 + b * args.x2_batch;
  const float* a = args.a + static_cast<size_t>(b) * 2 * c2 * hw;
  float* y1 = args.y1 + static_cast<size_t>(b) * c1 * hw;
  float* y2 = args.y2 + static_cast<size_t>(b) * c2 * hw;
  const int q = threadIdx.x / args.lanes, r = threadIdx.x % args.lanes;
  float ssum = 0.0f;
  if (q < args.planes) {
    for (int k = k0 + q; k < k1; k += args.planes) {
      const int src = src_s[k - k0];
      const float sc = scale_s[k - k0], of = offset_s[k - k0];
      float* out = k < c1 ? y1 + k * hw : y2 + (k - c1) * hw;
      if (src < c1) {
        const float* in = x1 + src * hw;
        for (int v = r; v < args.nvec; v += args.lanes) {
          float x[VEC];
          Plane<VEC>::load(in, v, x);
#pragma unroll
          for (int e = 0; e < VEC; ++e) x[e] = __fadd_rn(__fmul_rn(x[e], sc), of);
          Plane<VEC>::store(out, v, x);
        }
      } else {
        const int j = src - c1;
        const float* in = x2 + j * hw;
        const float* as = a + j * hw;
        const float* at = a + (c2 + j) * hw;
        const float bs = args.bias[j], bt = args.bias[c2 + j];
        for (int v = r; v < args.nvec; v += args.lanes) {
          float x[VEC], s[VEC], t[VEC];
          Plane<VEC>::load(in, v, x);
          Plane<VEC>::load(as, v, s);
          Plane<VEC>::load(at, v, t);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            s[e] = __fmul_rn(args.coeff, atanf(__fmul_rn(__fadd_rn(s[e], bs), 0.1f)));
            const float coupled =
                __fadd_rn(__fmul_rn(x[e], expf(s[e])), __fmul_rn(__fadd_rn(t[e], bt), 0.1f));
            x[e] = __fadd_rn(__fmul_rn(coupled, sc), of);
            ssum = __fadd_rn(ssum, s[e]);
          }
          Plane<VEC>::store(out, v, x);
        }
      }
    }
  }

  const float mine = block_sum(ssum, scratch);
  if (threadIdx.x == 0) partial = mine;
  // rank 0 also sums log(scale) over every channel, in a fixed order
  float logs = 0.0f;
  if (rank == 0) {
    float l = 0.0f;
    for (int c = threadIdx.x; c < channels; c += blockDim.x)
      l = __fadd_rn(l, logf(affine_scale(args.g[c])));
    logs = block_sum(l, scratch);
  }
  cluster.sync();  // every block's partial is in its shared memory
  if (rank == 0 && threadIdx.x == 0) {
    float total = 0.0f;
    for (unsigned int i = 0; i < cluster.num_blocks(); ++i)
      total = __fadd_rn(total, *cluster.map_shared_rank(&partial, i));
    args.logdet[b] = __fadd_rn(total, __fmul_rn(static_cast<float>(args.hw), logs));
  }
  cluster.sync();  // no block leaves while rank 0 may still read its shared memory
}

template <int VEC, int MAX_THREADS>
int launch(const Args& args, int batch, int cluster, int threads, size_t smem, cudaStream_t stream,
           int device) {
  const void* kernel = reinterpret_cast<const void*>(&flow_coupling_kernel<VEC, MAX_THREADS>);
  const int rc = vitad_launch::raise_dynamic_smem(kernel, smem, device);
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, flow_coupling_kernel<VEC, MAX_THREADS>, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Plain C entry point, bound with ctypes. x1 [batch, c1, hw] and x2 [batch,
// c2, hw] are f32 with contiguous planes and batch strides x1_batch, x2_batch
// (in floats); a is contiguous f32 [batch, 2 c2, hw] and bias f32 [2 c2]; g
// and o are f32 [c1 + c2]; perm is int64 [c1 + c2]; y1 [batch, c1, hw], y2
// [batch, c2, hw] and logdet [batch] are contiguous f32 outputs. Launches on
// `stream` without synchronising and returns the CUDA error code (0 on
// success); writes to the host int `route` the form it launched (1 16-byte
// vectors, 2 scalar; 0 unless the launch went through). A perm entry outside
// [0, c1 + c2) traps.
extern "C" int flow_coupling_forward(const void* x1, const void* x2, const void* a,
                                     const void* bias, const void* g, const void* o,
                                     const void* perm, void* y1, void* y2, void* logdet,
                                     int batch, int c1, int c2, int hw,
                                     long long x1_batch, long long x2_batch, float coeff,
                                     int device, void* stream, int* route) {
  if (route == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *route = 0;
  const int channels = c1 + c2;
  if (batch < 1 || batch > 65535 || c1 < 1 || c2 < 1 || hw < 1 || channels > kMaxChannels ||
      x1_batch < static_cast<long long>(c1) * hw || x2_batch < static_cast<long long>(c2) * hw)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const bool vector = hw % 4 == 0 && x1_batch % 4 == 0 && x2_batch % 4 == 0 && aligned16(x1) &&
                      aligned16(x2) && aligned16(a) && aligned16(y1) && aligned16(y2);
  int cluster = kMaxCluster;
  while (cluster > channels) cluster /= 2;
  Args args;
  args.x1 = static_cast<const float*>(x1);
  args.x2 = static_cast<const float*>(x2);
  args.a = static_cast<const float*>(a);
  args.bias = static_cast<const float*>(bias);
  args.g = static_cast<const float*>(g);
  args.o = static_cast<const float*>(o);
  args.perm = static_cast<const long long*>(perm);
  args.y1 = static_cast<float*>(y1);
  args.y2 = static_cast<float*>(y2);
  args.logdet = static_cast<float*>(logdet);
  args.x1_batch = x1_batch;
  args.x2_batch = x2_batch;
  args.c1 = c1;
  args.c2 = c2;
  args.hw = hw;
  args.coeff = coeff;
  args.chunk = (channels + cluster - 1) / cluster;
  args.nvec = vector ? hw / 4 : hw;
  const bool wide = batch * cluster < sms;
  const int limit = wide ? kWideThreads : kThreads;
  // whole warps along a plane: no warp straddles two planes of different kinds
  args.lanes = args.nvec < limit ? (args.nvec + 31) / 32 * 32 : limit;
  args.planes = limit / args.lanes;
  if (args.planes > args.chunk) args.planes = args.chunk;
  const int threads = (args.planes * args.lanes + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(args.chunk) * 3 * sizeof(float) +
                      kMaxWarps * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (wide)
    rc = vector ? launch<4, kWideThreads>(args, batch, cluster, threads, smem, s, device)
                : launch<1, kWideThreads>(args, batch, cluster, threads, smem, s, device);
  else
    rc = vector ? launch<4, kThreads>(args, batch, cluster, threads, smem, s, device)
                : launch<1, kThreads>(args, batch, cluster, threads, smem, s, device);
  if (rc == 0) *route = vector ? kRouteVector : kRouteScalar;
  return rc;
}
