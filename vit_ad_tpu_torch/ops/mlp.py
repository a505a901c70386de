"""Plain PyTorch version of the fused pre-LN MLP half-block.

The function `x + fc2(gelu_tanh(fc1(layer_norm(x))))` of
`vit_ad_tpu/ops/pallas/mlp.py::_kernel` (:44), with that kernel's rounding
points, which are also those of the Hopper kernel `csrc/mlp_block.cu`: f32
LayerNorm statistics and affine, matmul operands rounded to the weights' dtype,
f32 accumulation, f32 biases, tanh GELU and residual add in f32, one rounding
to x's dtype at the end. (The stock tail of `models/vit._block_apply` rounds
the hidden activations and the residual to the compute dtype instead.) Used by
the tests, for CPU tensors, and by the wrapper's recompute backward.

`gemm_step_reference` is the plain version of one product of the kernel's
bf16 route alone (`ops/cuda/mlp.gemm_step`), with its three epilogues: the
GELU step, the residual step, and the f32 partial a model-axis shard's
row-parallel product leaves for the sum over the ranks (`models/
tensor_parallel.py`).
"""

from __future__ import annotations

import math

from typing import Optional

import torch

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    inner = _SQRT_2_OVER_PI * (h + 0.044715 * h * h * h)
    return 0.5 * h * (1.0 + torch.tanh(inner))


# Epilogues of one product (`gemm_step`; the C side's numbering)
EPILOGUE_GELU, EPILOGUE_RESIDUAL, EPILOGUE_PARTIAL = 0, 1, 2


def product_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [..., K] rounded to w's dtype, times w [N, K] transposed, summed in
    f32 (exact products of the rounded operands)."""
    return a.to(w.dtype).float() @ w.float().t()


def gemm_step_reference(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                        epilogue: int, resid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a [M, K] . w [N, K]^T summed in f32, then: `EPILOGUE_GELU`
    a's dtype(gelu_tanh(. + bias)); `EPILOGUE_RESIDUAL` a's dtype(f32(resid)
    + (. + bias)); `EPILOGUE_PARTIAL` the f32 sums alone (bias unread)."""
    acc = product_f32(a, w)
    if epilogue == EPILOGUE_PARTIAL:
        return acc
    if epilogue == EPILOGUE_GELU:
        return gelu_tanh(acc + bias.float()).to(a.dtype)
    if epilogue == EPILOGUE_RESIDUAL:
        return (resid.float() + (acc + bias.float())).to(a.dtype)
    raise ValueError(f"no epilogue {epilogue}: 0 GELU, 1 residual, 2 f32 partial")


def mlp_block_reference(x: torch.Tensor, norm_w: torch.Tensor, norm_b: torch.Tensor,
                        w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """x [..., D]; norm_w, norm_b [D]; w1 [H, D], b1 [H], w2 [D, H], b2 [D]
    (the nn.Linear layouts of fc1 and fc2) → [..., D] in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    centred = xf - mean
    var = centred.square().mean(dim=-1, keepdim=True)
    y = (centred * torch.rsqrt(var + eps)) * norm_w.float() + norm_b.float()
    g = gelu_tanh(product_f32(y, w1) + b1.float())
    o = product_f32(g, w2) + b2.float()
    return (xf + o).to(x.dtype)
