"""Shared building blocks for the backbones (port of
`vit_ad_tpu/models/layers.py`: `PatchEmbed` :27, `resolve_gelu_approx` :58,
the inference half of `FusedBatchNorm` :149, `LayerNorm` :227), and the cache
of compute-dtype weight copies the encoders share."""

from __future__ import annotations

import math
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.ops.cuda.layer_norm import layer_norm


class PatchEmbed(nn.Module):
    """Image → patch tokens via a stride=patch conv. The conv weight is the
    timm `patch_embed.proj` layout [D, 3, p, p]; input and output follow the
    JAX layouts: [B, H, W, 3] in, [B, P, D] out."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768) -> None:
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """`weight`/`bias`: `proj`'s parameters in the compute dtype (the
        encoder's cached copies)."""
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=self.patch_size)
        return y.flatten(2).transpose(1, 2)  # [B, h*w, D]


def resolve_gelu_approx(dtypes: DtypePolicy, gelu_tanh: Optional[bool] = None) -> bool:
    """The GELU-flavour policy every backbone follows: tanh under bf16 compute,
    exact erf under f32; `VITAD_EXACT_GELU=1` pins exact erf everywhere."""
    if os.environ.get("VITAD_EXACT_GELU"):
        return False
    if gelu_tanh is not None:
        return gelu_tanh
    return dtypes.compute_dtype == torch.bfloat16


def trunc_normal_(t: torch.Tensor, std: float, generator: Optional[torch.Generator]) -> None:
    """N(0, std²) truncated at ±2 std (flax `truncated_normal` semantics)."""
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax `lecun_normal`: N(0, 1/fan_in) truncated at ±2 std, with the
    variance the truncation removes restored."""
    trunc_normal_(t, math.sqrt(1.0 / fan_in) / 0.87962566103423978, generator)


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm`'s parameters (`weight`, `bias`) with the forward of the
    JAX package's module: f32 statistics (bf16 variance is too coarse), cast
    to the compute dtype. By default `F.layer_norm` on the f32 cast; `fused`
    takes the one-pass kernel `ops/cuda/layer_norm.layer_norm`, which stores
    in x's dtype (the JAX package's `VITAD_PALLAS_LN=1`, given when the model
    is built rather than read from the environment)."""

    def __init__(self, dim: int, eps: float = 1e-6, dtypes: DtypePolicy = DtypePolicy(),
                 fused: bool = False) -> None:
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtypes.compute_dtype
        self.fused = fused

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            y = layer_norm(x, self.weight, self.bias, self.eps)
        else:
            y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class FusedBatchNorm(nn.BatchNorm2d):
    """Inference BatchNorm over NCHW maps that stays in the compute dtype
    (JAX `FusedBatchNorm` :149, its `use_running_average` path): per channel
    `mul = rsqrt(var + eps) * weight` in f32 from the f32 running statistics,
    cast once, then `(x - mean) * mul + bias` on the map in x's dtype, in that
    op order. Parameters and buffers are `nn.BatchNorm2d`'s, so torchvision
    state dicts load. The port never trains a trunk that has one: the training
    half is not ported and a module in training mode raises."""

    def __init__(self, channels: int, eps: float = 1e-5) -> None:
        super().__init__(channels, eps=eps)

    def folded(self, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(mean, mul, bias) as [1, C, 1, 1] tensors of `dtype`."""
        mul = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        return tuple(t.to(dtype).view(1, -1, 1, 1)
                     for t in (self.running_mean, mul, self.bias))

    def forward(self, x: torch.Tensor,
                folded: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """`folded`: a cached `self.folded(x.dtype)`."""
        if self.training:
            raise NotImplementedError(
                "FusedBatchNorm: only the inference path is ported (the trunks that use it "
                "are frozen); call .eval() on the model")
        mean, mul, bias = self.folded(x.dtype) if folded is None else folded
        return (x - mean) * mul + bias


class ComputeWeights:
    """Compute-dtype copies of a module's matmul weights, and whatever else
    `make(dtype)` derives from the parameters. They are cached and made
    again only when a parameter changed (storage or in-place version); while
    gradients flow to the parameters they are made per call. (JAX casts them
    once per call outside its block scan.)"""

    def __init__(self) -> None:
        self._key: Optional[tuple] = None
        self._cast: Optional[Dict[str, Any]] = None

    def get(self, module: nn.Module, dtypes: DtypePolicy,
            make: Callable[[torch.dtype], Dict[str, Any]]) -> Dict[str, Any]:
        cd = dtypes.compute_dtype
        if torch.is_grad_enabled() and any(p.requires_grad for p in module.parameters()):
            return make(cd)
        key = tuple((p.data_ptr(), p._version, p.device) for p in module.parameters())
        if key != self._key:
            with torch.inference_mode(False), torch.no_grad():
                self._cast = make(cd)
            self._key = key
        return self._cast
