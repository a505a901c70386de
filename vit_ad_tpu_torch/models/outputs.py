"""Typed model outputs (port of `vit_ad_tpu/models/outputs.py`)."""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Protocol

import torch


class EncoderOutput(NamedTuple):
    """patch_embedding: [B, P, D] patch tokens; latent: [B, D] cls token."""

    patch_embedding: torch.Tensor
    latent: torch.Tensor


class Encoder(Protocol):
    """What the pipelines need of a frozen trunk (`models/vit.ViTEncoder`,
    `models/swin.SwinTransformer`): an `nn.Module` that maps preprocessed
    images [B, H, W, 3] to an `EncoderOutput` and names the shape of its
    patch tokens."""

    embed_dim: int     # D of patch_embedding [B, P, D]
    num_patches: int   # P

    def __call__(self, x: torch.Tensor, block_index: int = 0) -> EncoderOutput: ...

    def parameters(self) -> Iterator[torch.nn.Parameter]: ...

    def to(self, *args, **kwargs) -> "Encoder": ...

    def eval(self) -> "Encoder": ...


class FlowOutput(NamedTuple):
    """loss: scalar NLL; anomaly_score_map: [B, H, W] upsampled to img_size."""

    loss: torch.Tensor
    anomaly_score_map: torch.Tensor


class AutoEncoderOutput(NamedTuple):
    """latent: [B, D] (the vanilla AE: its [s, s, 768] map flattened in NHWC
    order, as the JAX module flattens it); reconstruction: [B, H, W, 3];
    patch_embedding: [B, P, D] for the transformer AEs, else None."""

    latent: torch.Tensor
    reconstruction: torch.Tensor
    patch_embedding: Optional[torch.Tensor] = None
