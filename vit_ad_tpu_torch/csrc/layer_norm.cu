// One-pass LayerNorm over the last dimension for Hopper (sm_90a).
//
// Replaces the TPU kernel vit_ad_tpu/ops/pallas/layer_norm.py::_kernel
// (pallas_call in layer_norm_pallas, public entry layer_norm). For every row of
// x [rows, D] (bf16 or f32), in f32:
//
//   mean = sum(x) / D;  var = sum((x - mean)^2) / D
//   out  = ((x - mean) * rsqrt(var + eps)) * scale + bias      (stored in x's dtype)
//
// the centred variance of the TPU kernel, not E[x^2] - mean^2. scale and bias
// are f32 [D].
//
// What bounds it on the H100: bytes. Each element is read once and written
// once (the Swin-T stage-0 block norm at B=128: [401408, 96] bf16, 154 MB, 46 us
// at 3.35 TB/s) against ~8 flops per element. So the row is held in registers
// between the three sweeps (sum, centred squares, normalise), with 16-byte
// loads and stores, warp-shuffle reductions, no shared memory and no second
// read of x. The plain PyTorch expression makes an f32 copy of x, several f32
// temporaries and a cast back.
//
// bf16 rows of D = 8 LPR NV (LPR in {4, 8, 16, 32} lanes a row, NV in
// {1, 2, 3, 4, 6, 8} 16-byte vectors a lane: every Swin-T and ViT width) take
// the rows kernel: 32 / LPR rows a warp, every lane busy (D = 96: 4 lanes a
// row, 8 rows a warp; 384: 16 lanes, 2 rows; 768: 32 lanes, 1 row), each
// lane's scale and bias loaded once as float4s and kept in registers. From
// D = 384 the grid holds only as many blocks as the card runs at once and the
// warps stride over the row groups, issuing the next group's loads before
// this group's reductions; below, one warp per group of rows (7% faster at
// D = 96). The first form, one warp per row with scalar scale and bias loads
// in the store loop, left 20 of 32 lanes idle at D = 96, kept one row's bytes
// in flight per warp and issued 16 scalar loads per 16-byte vector stored.
// Measured back to back on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
// --against the first form): 0.0566 / 0.0307 / 0.0117 / 0.0083 / 0.0313 ms at
// [401408,96] / [100352,192] / [25088,384] / [6272,768] / [25344,768] against
// 0.1151 / 0.0521 / 0.0260 / 0.0143 / 0.0500, and F.layer_norm on the same
// bf16 rows 0.457 / 0.131 / 0.0402 / 0.0194 / 0.0551; the bound by bytes is
// 0.0460 / 0.0230 / 0.0115 / 0.0058 / 0.0232. (The [6272,768] rows, 9.6 MB,
// stay in L2 when the calls follow each other, so the bound by device memory
// is no floor there.)
//
// Every other input takes the first form, one warp per row: f32 (vectors of
// 4), a bf16 width without such a split, and, with vectors of 1, a D that is
// no multiple of the vector width or a buffer that is not 16-byte aligned.
// Any D up to 2048 is taken.
//
// The kernels and their launch code live in layer_norm_common.cuh, which
// mlp_block.cu includes too: the LayerNorm step of the fused MLP half-block is
// this kernel.

#include "layer_norm_common.cuh"

// Plain C entry point, bound with ctypes. x and out are contiguous [rows, d]
// device buffers of bf16 (is_bf16 != 0) or f32; scale and bias are contiguous
// f32 [d]; 1 <= d <= 2048. Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success); writes to the host int `route`
// the kernel it launched (1 the rows kernel, 2 one warp per row; 0 unless the
// launch went through).
extern "C" int layer_norm_forward(const void* x, const void* scale, const void* bias, void* out,
                                  int rows, int d, float eps, int is_bf16, int device,
                                  void* stream, int* route) {
  if (route == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *route = 0;
  if (rows < 1 || d < 1 || d > vitad_layer_norm::kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int launched = 0;
  const int rc = vitad_layer_norm::run(x, static_cast<const float*>(scale),
                                       static_cast<const float*>(bias), out, rows, d, eps,
                                       is_bf16 != 0, static_cast<cudaStream_t>(stream), &launched);
  if (rc == 0) *route = launched;
  return rc;
}
