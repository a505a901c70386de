"""One-pass LayerNorm over the last dimension.

Port of `vit_ad_tpu/ops/pallas/layer_norm.py::layer_norm` (:130), whose TPU
kernel `_kernel` (:53) becomes the hand-written Hopper kernel
`vit_ad_tpu_torch/csrc/layer_norm.cu` (see its header for what bounds it on
the H100 and what the design does about it).

`layer_norm` launches that kernel for a CUDA tensor, and raises where it
cannot. For a CPU tensor it runs the plain PyTorch version
`layer_norm_reference`, the expression of the JAX package's `_xla_layer_norm`
(:117). Its backward recomputes through the plain version, as the JAX custom
VJP does (:144-147): the TPU kernel had no backward kernel either.
"""

from __future__ import annotations

import torch

# Kernel launches made by `layer_norm` (a plain count, read by chip_smoke.py
# to show that the main path went through the kernel).
launches = 0

MAX_DIM = 2048
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """Plain LayerNorm over the last dim: f32 mean, centred variance,
    rsqrt(var + eps), scale, bias, stored in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    centred = xf - mean
    var = centred.square().mean(dim=-1, keepdim=True)
    y = centred * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def check_kernel_shape(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> int:
    """Raise unless the CUDA kernel takes this input: bf16 or f32, at least
    one row, 1 ≤ D ≤ 2048, scale and bias [D]. Returns D."""
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"layer_norm kernel takes bf16 or f32, got {x.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if not 1 <= d <= MAX_DIM or x.numel() == 0:
        raise ValueError(f"layer_norm kernel takes [..., D] with 1 <= D <= {MAX_DIM} and at "
                         f"least one row, got shape {tuple(x.shape)}")
    if tuple(scale.shape) != (d,) or tuple(bias.shape) != (d,):
        raise ValueError(f"scale and bias must be [{d}], got {tuple(scale.shape)} and "
                         f"{tuple(bias.shape)}")
    return d


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    global launches
    from vit_ad_tpu_torch.ops.cuda.build import device_index, load_library

    d = check_kernel_shape(x, scale, bias)
    x = x.contiguous()
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    err = load_library().layer_norm_forward(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), x.numel() // d, d,
        float(eps), int(x.dtype == torch.bfloat16), device_index(x),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error {err}")
    launches += 1
    return out


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        if x.device.type == "cuda":
            return _launch(x, scale, bias, eps)
        if x.device.type == "cpu":
            return layer_norm_reference(x, scale, bias, eps)
        raise RuntimeError(f"layer_norm has no path for device {x.device}")

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = layer_norm_reference(*ins, ctx.eps)
            return (*torch.autograd.grad(out, ins, grad), None)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Differentiable one-pass LayerNorm over the last dim, in x's dtype: the
    Hopper kernel on CUDA tensors, the plain version on CPU tensors, backward
    by recomputation through the plain version."""
    return _LayerNorm.apply(x, scale, bias, eps)
