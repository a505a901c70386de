"""Shared building blocks for the transformer backbones (port of
`vit_ad_tpu/models/layers.py`: `PatchEmbed` :27, `resolve_gelu_approx` :58)."""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_ad_tpu_torch.config import DtypePolicy


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
