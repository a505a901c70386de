"""Plain PyTorch version of the fused pre-LN MLP half-block.

The function `x + fc2(gelu_tanh(fc1(layer_norm(x))))` of
`vit_ad_tpu/ops/pallas/mlp.py::_kernel` (:44), with that kernel's rounding
points, which are also those of the Hopper kernel `csrc/mlp_block.cu`: f32
LayerNorm statistics and affine, matmul operands rounded to the weights' dtype,
f32 accumulation, f32 biases, tanh GELU and residual add in f32, one rounding
to x's dtype at the end. (The stock tail of `models/vit._block_apply` rounds
the hidden activations and the residual to the compute dtype instead.) Used by
the tests, for CPU tensors, and by the wrapper's recompute backward.
"""

from __future__ import annotations

import math

import torch

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    inner = _SQRT_2_OVER_PI * (h + 0.044715 * h * h * h)
    return 0.5 * h * (1.0 + torch.tanh(inner))


def _product_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [..., K] rounded to w's dtype, times w [N, K] transposed, summed in
    f32 (exact products of the rounded operands)."""
    return a.to(w.dtype).float() @ w.float().t()


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
    g = gelu_tanh(_product_f32(y, w1) + b1.float())
    o = _product_f32(g, w2) + b2.float()
    return (xf + o).to(x.dtype)
