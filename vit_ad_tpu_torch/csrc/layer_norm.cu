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
// at 3.35 TB/s) against ~8 flops per element. So the design is one warp per
// row, the row held in registers between the three sweeps (sum, centred
// squares, normalise), 16-byte loads and stores, two warp-shuffle reductions,
// no shared memory and no second read of x. The plain PyTorch expression makes
// an f32 copy of x, several f32 temporaries and a cast back.
//
// Any D up to 2048 is taken. Lane l holds vectors l, l + 32, ... of the row;
// vectors past D are masked, so D = 96 or 192 (fewer than 32 vectors of 8)
// never reads past the row. A D that is no multiple of the vector width, or a
// buffer that is not 16-byte aligned, takes the same kernel with vectors of 1.
//
// The kernel and its launch code live in layer_norm_common.cuh, which
// mlp_block.cu includes too: the LayerNorm step of the fused MLP half-block is
// this kernel.

#include "layer_norm_common.cuh"

// Plain C entry point, bound with ctypes. x and out are contiguous [rows, d]
// device buffers of bf16 (is_bf16 != 0) or f32; scale and bias are contiguous
// f32 [d]; 1 <= d <= 2048. Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
extern "C" int layer_norm_forward(const void* x, const void* scale, const void* bias, void* out,
                                  int rows, int d, float eps, int is_bf16, int device,
                                  void* stream) {
  if (rows < 1 || d < 1 || d > vitad_layer_norm::kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return vitad_layer_norm::run(x, static_cast<const float*>(scale),
                               static_cast<const float*>(bias), out, rows, d, eps, is_bf16 != 0,
                               static_cast<cudaStream_t>(stream));
}
