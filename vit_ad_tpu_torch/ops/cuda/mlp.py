"""Fused pre-LN MLP half-block of a ViT block: x + fc2(gelu_tanh(fc1(LN(x)))).

Port of `vit_ad_tpu/ops/pallas/mlp.py::mlp_block` (:136), whose TPU kernel
`_kernel` (:44) becomes the hand-written Hopper kernel
`vit_ad_tpu_torch/csrc/mlp_block.cu` (see its header for what bounds it on the
H100 and what the design does about it).

`mlp_block` launches that kernel for a CUDA tensor, and raises where it
cannot: under bf16 three kernels behind one entry point (the one-pass
LayerNorm, then the two products on `wgmma` behind TMA with the GELU and the
residual in their epilogues, `mlp_route` = "wgmma"), under f32 one fused FMA
kernel ("fma"); the launch is the body of the registered op
`vit_ad_tpu_torch::mlp_block`, which `torch.export` carries into a native
serving bundle. For a CPU tensor it runs the plain PyTorch version
`ops/mlp.mlp_block_reference`. Its backward recomputes through the plain
version, as the JAX custom VJP recomputes through its XLA expression
(:152-154): the TPU kernel had no backward kernel either. `use_fused_mlp`
is the shape half of the JAX gate `use_pallas_mlp` (:160); the opt-in half
is the encoder's `fused_mlp` argument.

`gemm_step` is one product of the bf16 route alone, with the GELU, the
residual or the f32-partial epilogue: a model-axis shard of a trunk runs its
MLP and attention projections through it where `use_gemm_step` admits the
widths (`models/tensor_parallel.py`). It counts its launches like
`mlp_block`, by the epilogue the C entry point reports.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vit_ad_tpu_torch.ops.mlp import (
    EPILOGUE_GELU,
    EPILOGUE_PARTIAL,
    EPILOGUE_RESIDUAL,
    gemm_step_reference,
    mlp_block_reference,
)

# Kernel launches made by `mlp_block` (a plain count, read by chip_smoke.py to
# show that the main path went through the kernel).
launches = 0
# Of those, the calls for which the C entry point reported the bf16 route
# (LayerNorm kernel + two wgmma products); the rest took the f32 kernel.
wgmma_launches = 0
# `mlp_route`'s names for what `mlp_block_forward` reports as launched
ROUTE_NAMES = {1: "wgmma", 2: "fma"}

# Kernel launches made by `gemm_step`, and of those the launches by the
# epilogue `mlp_gemm_forward` reported through its `route` out-parameter
gemm_launches = 0
gemm_route_launches = {"gelu": 0, "residual": 0, "partial": 0}
GEMM_ROUTE_NAMES = {EPILOGUE_GELU + 1: "gelu", EPILOGUE_RESIDUAL + 1: "residual",
                    EPILOGUE_PARTIAL + 1: "partial"}
last_gemm_route = ""

# The f32 kernel keeps a block's [32, D] output accumulator in registers: D/8
# a thread
MAX_DIM = 1024
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def use_fused_mlp(d: int, hidden: int) -> bool:
    """Whether the kernel takes a block of width `d` with `hidden` hidden
    units: both multiples of 128 (the JAX gate's rule) and d ≤ 1024."""
    return 0 < d <= MAX_DIM and hidden > 0 and d % 128 == 0 and hidden % 128 == 0


def mlp_route(d: int, hidden: int, dtype: torch.dtype) -> str:
    """Which kernels `mlp_block` launches for a CUDA tensor of this width and
    dtype: "wgmma" (bf16: every width the gate admits), "fma" (f32), or ""
    where it raises."""
    if not use_fused_mlp(d, hidden) or dtype not in _KERNEL_DTYPES:
        return ""
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def check_kernel_shape(x, norm_w, norm_b, w1, b1, w2, b2) -> tuple:
    """Raise unless the CUDA kernel takes these inputs; return (D, H)."""
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"mlp_block kernel takes bf16 or f32, got {x.dtype}")
    d = x.shape[-1] if x.dim() else 0
    hidden = w1.shape[0] if w1.dim() == 2 else 0
    if not use_fused_mlp(d, hidden) or x.numel() == 0:
        raise ValueError(f"mlp_block kernel takes [..., D] with D and H multiples of 128, "
                         f"D <= {MAX_DIM} and at least one row, got x {tuple(x.shape)} and "
                         f"fc1.weight {tuple(w1.shape)}")
    for name, t, shape in (("norm_w", norm_w, (d,)), ("norm_b", norm_b, (d,)),
                           ("w1", w1, (hidden, d)), ("b1", b1, (hidden,)),
                           ("w2", w2, (d, hidden)), ("b2", b2, (d,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} (nn.Linear layouts), got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"mlp_block inputs lie on {x.device} and {t.device}")
    for name, w in (("w1", w1), ("w2", w2)):
        if w.dtype != x.dtype:
            raise TypeError(f"{name} must have x's dtype {x.dtype}, got {w.dtype}")
    return d, hidden


def _launch(x, norm_w, norm_b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    global launches, wgmma_launches
    from vit_ad_tpu_torch.ops.cuda.build import aligned_buffer, device_index, load_library

    d, hidden = check_kernel_shape(x, norm_w, norm_b, w1, b1, w2, b2)
    wgmma = mlp_route(d, hidden, x.dtype) == "wgmma"
    rows = x.numel() // d
    xb, w1b, w2b = (aligned_buffer(t, x.dtype) for t in (x, w1, w2))
    nw, nb, b1b, b2b = (aligned_buffer(t, torch.float32) for t in (norm_w, norm_b, b1, b2))
    out = torch.empty_like(xb)
    # scratch of the bf16 route: the LayerNorm output and the hidden activations
    y = torch.empty_like(xb) if wgmma else None
    hid = torch.empty((rows, hidden), dtype=x.dtype, device=x.device) if wgmma else None
    took = ctypes.c_int(0)
    err = load_library().mlp_block_forward(
        xb.data_ptr(), nw.data_ptr(), nb.data_ptr(), w1b.data_ptr(), b1b.data_ptr(),
        w2b.data_ptr(), b2b.data_ptr(), out.data_ptr(), y.data_ptr() if wgmma else None,
        hid.data_ptr() if wgmma else None, rows, d, hidden, float(eps), int(wgmma),
        device_index(x), torch.cuda.current_stream(x.device).cuda_stream, ctypes.byref(took),
    )
    if err:
        raise RuntimeError(f"mlp_block kernel launch failed: error {err} (a CUDA runtime code, "
                           f"or a tensor-map code of csrc/mlp_block.cu)")
    launches += 1
    wgmma_launches += int(ROUTE_NAMES[took.value] == "wgmma")
    return out  # xb, and so out, has x's shape


@torch.library.custom_op("vit_ad_tpu_torch::mlp_block", mutates_args=(), device_types="cuda")
def mlp_block_op(x: torch.Tensor, norm_w: torch.Tensor, norm_b: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """One launch of the kernel (B6) on CUDA tensors, as a registered op."""
    return _launch(x, norm_w, norm_b, w1, b1, w2, b2, eps)


@mlp_block_op.register_fake
def _(x, norm_w, norm_b, w1, b1, w2, b2, eps):
    check_kernel_shape(x, norm_w, norm_b, w1, b1, w2, b2)
    return x.new_empty(x.shape)


def use_gemm_step(n: int, k: int, dtype: torch.dtype) -> bool:
    """Whether a shard's product of w [N, K] takes `gemm_step`: bf16, with N
    and K multiples of 128 (the rule of `use_fused_mlp`)."""
    return dtype == torch.bfloat16 and n > 0 and k > 0 and n % 128 == 0 and k % 128 == 0


def _check_gemm_step(a, w, bias, epilogue, resid) -> None:
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or a.dim() != 2 \
            or w.dim() != 2 or a.shape[1] != w.shape[1] or w.device != a.device:
        raise ValueError(f"gemm_step takes bf16 matrices a [M, K] and w [N, K] on one device, "
                         f"got {a.dtype} {tuple(a.shape)} on {a.device} and {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    if epilogue + 1 not in GEMM_ROUTE_NAMES or (epilogue != EPILOGUE_PARTIAL and bias is None) \
            or (epilogue == EPILOGUE_RESIDUAL and resid is None):
        raise ValueError(f"gemm_step epilogue {epilogue}: 0 GELU and 1 residual take an f32 "
                         f"bias [N], 1 a residual [M, N] too, 2 (the f32 partial) neither")


def gemm_step(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], epilogue: int,
              resid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One product of the bf16 route alone: bf16(gelu_tanh(a . w^T + bias))
    with `EPILOGUE_GELU`, bf16(f32(resid) + (a . w^T + bias)) with
    `EPILOGUE_RESIDUAL`, the f32 a . w^T with `EPILOGUE_PARTIAL` (bias may be
    None). a [M, K], w [N, K] and resid [M, N] are bf16, bias f32 [N]. The
    kernel on CUDA tensors (one launch counted), the plain version
    `ops/mlp.gemm_step_reference` on CPU tensors; no gradient."""
    _check_gemm_step(a, w, bias, epilogue, resid)
    if a.device.type == "cuda":
        return gemm_step_op(a, w, bias, epilogue, resid)
    if a.device.type == "cpu":
        return gemm_step_reference(a, w, bias, epilogue, resid)
    raise RuntimeError(f"gemm_step has no path for device {a.device}")


@torch.library.custom_op("vit_ad_tpu_torch::mlp_gemm", mutates_args=(), device_types="cuda")
def gemm_step_op(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], epilogue: int,
                 resid: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of `gemm_step`'s kernel, as a registered op."""
    global gemm_launches, last_gemm_route
    from vit_ad_tpu_torch.ops.cuda.build import aligned_buffer, device_index, load_library

    _check_gemm_step(a, w, bias, epilogue, resid)
    a, w = aligned_buffer(a, a.dtype), aligned_buffer(w, a.dtype)
    if bias is not None:
        bias = aligned_buffer(bias, torch.float32)
    if resid is not None:
        resid = aligned_buffer(resid, a.dtype)
    dtype = torch.float32 if epilogue == EPILOGUE_PARTIAL else a.dtype
    out = torch.empty((a.shape[0], w.shape[0]), dtype=dtype, device=a.device)
    took = ctypes.c_int(0)
    err = load_library().mlp_gemm_forward(
        a.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        None if resid is None else resid.data_ptr(), out.data_ptr(), a.shape[0], w.shape[0],
        a.shape[1], epilogue, device_index(a), torch.cuda.current_stream(a.device).cuda_stream,
        ctypes.byref(took),
    )
    if err:
        raise RuntimeError(f"mlp gemm kernel launch failed: error {err}")
    gemm_launches += 1
    last_gemm_route = GEMM_ROUTE_NAMES[took.value]
    gemm_route_launches[last_gemm_route] += 1
    return out


@gemm_step_op.register_fake
def _(a, w, bias, epilogue, resid):
    _check_gemm_step(a, w, bias, epilogue, resid)
    dtype = torch.float32 if epilogue == EPILOGUE_PARTIAL else a.dtype
    return a.new_empty((a.shape[0], w.shape[0]), dtype=dtype)


def _forward(x, norm_w, norm_b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    if x.device.type == "cuda":
        return mlp_block_op(x, norm_w, norm_b, w1, b1, w2, b2, eps)
    if x.device.type == "cpu":
        return mlp_block_reference(x, norm_w, norm_b, w1, b1, w2, b2, eps)
    raise RuntimeError(f"mlp_block has no path for device {x.device}")


class _MlpBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, norm_w, norm_b, w1, b1, w2, b2, eps):
        ctx.save_for_backward(x, norm_w, norm_b, w1, b1, w2, b2)
        ctx.eps = eps
        return _forward(x, norm_w, norm_b, w1, b1, w2, b2, eps)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = mlp_block_reference(*ins, ctx.eps)
            return (*torch.autograd.grad(out, ins, grad), None)


def mlp_block(x: torch.Tensor, norm_w: torch.Tensor, norm_b: torch.Tensor, w1: torch.Tensor,
              b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """Differentiable x + fc2(gelu_tanh(fc1(LN(x)))) in x's dtype. x [..., D];
    norm_w, norm_b [D] and the biases b1 [H], b2 [D] are taken in f32; w1
    [H, D] and w2 [D, H] are fc1.weight and fc2.weight in x's dtype. The
    Hopper kernel on CUDA tensors, the plain version on CPU tensors, backward
    by recomputation through the plain version."""
    ins = (x, norm_w, norm_b, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return _MlpBlock.apply(*ins, eps)
    return _forward(*ins, eps)
