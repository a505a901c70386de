"""One-pass LayerNorm over the last dimension.

Port of `vit_ad_tpu/ops/pallas/layer_norm.py::layer_norm` (:130), whose TPU
kernel `_kernel` (:53) becomes the hand-written Hopper kernel
`vit_ad_tpu_torch/csrc/layer_norm.cu` (see its header for what bounds it on
the H100 and what the design does about it).

`layer_norm` launches that kernel for a CUDA tensor through the registered
op `vit_ad_tpu_torch::layer_norm` (`layer_norm_op`, which `torch.export`
carries into a native serving bundle), and raises where it cannot. For a CPU
tensor it runs the plain PyTorch version `layer_norm_reference`, the
expression of the JAX package's `_xla_layer_norm` (:117). Its backward
recomputes through the plain version, as the JAX custom VJP does (:144-147):
the TPU kernel had no backward kernel either.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Kernel launches made by `layer_norm` (a plain count, read by chip_smoke.py
# to show that the main path went through the kernel), and those the C entry
# reported as the rows kernel (`layer_norm_route`).
launches = 0
rows_launches = 0

MAX_DIM = 2048
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# What layer_norm_forward reports through its `route` out-parameter.
_ROUTES = {1: "rows", 2: "warp_per_row"}
# The rows kernel's forms: D = 8 LPR NV, LPR lanes per row, NV 16-byte vectors
# per lane (csrc/layer_norm_common.cuh `dispatch_rows`).
_ROWS_LANES, _ROWS_VECTORS = (4, 8, 16, 32), (1, 2, 3, 4, 6, 8)


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


@functools.lru_cache(maxsize=None)
def layer_norm_route(d: int, dtype: torch.dtype) -> str:
    """The kernel the C entry launches for contiguous, 16-byte aligned rows
    of width `d`: bf16 rows whose D / 8 vectors split as LPR lanes x NV
    vectors ("rows": several rows a warp, D < 384 included), else one warp
    per row ("warp_per_row": f32, and bf16 widths without such a split)."""
    if dtype not in _KERNEL_DTYPES or not 1 <= d <= MAX_DIM:
        raise ValueError(f"layer_norm kernel takes bf16 or f32 with 1 <= D <= {MAX_DIM}, got "
                         f"{dtype} and D={d}")
    if dtype == torch.bfloat16 and d % 8 == 0 and any(
            (d // 8) % nv == 0 and (d // 8) // nv in _ROWS_LANES for nv in _ROWS_VECTORS):
        return "rows"
    return "warp_per_row"


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    global launches, rows_launches
    from vit_ad_tpu_torch.ops.cuda.build import aligned_buffer, device_index, load_library

    d = check_kernel_shape(x, scale, bias)
    x = aligned_buffer(x, x.dtype)
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    route = ctypes.c_int(0)
    err = load_library().layer_norm_forward(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), x.numel() // d, d,
        float(eps), int(x.dtype == torch.bfloat16), device_index(x),
        torch.cuda.current_stream(x.device).cuda_stream, ctypes.byref(route),
    )
    if err:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error {err}")
    took, want = _ROUTES.get(route.value), layer_norm_route(d, x.dtype)
    if took != want:
        raise RuntimeError(f"layer_norm launched route {route.value} ({took}), expected {want}")
    launches += 1
    rows_launches += took == "rows"
    return out


@torch.library.custom_op("vit_ad_tpu_torch::layer_norm", mutates_args=(), device_types="cuda")
def layer_norm_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """One launch of the kernel (B7) on CUDA tensors, as a registered op."""
    return _launch(x, scale, bias, eps)


@layer_norm_op.register_fake
def _(x, scale, bias, eps):
    check_kernel_shape(x, scale, bias)
    return x.new_empty(x.shape)


def _forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float) -> torch.Tensor:
    if x.device.type == "cuda":
        return layer_norm_op(x, scale, bias, eps)
    if x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps)
    raise RuntimeError(f"layer_norm has no path for device {x.device}")


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _forward(x, scale, bias, eps)

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
    by recomputation through the plain version. Where no gradient is wanted
    the autograd node is skipped (its host time is a short kernel's own)."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, scale, bias, eps)
    return _forward(x, scale, bias, eps)
