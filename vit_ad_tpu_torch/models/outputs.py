"""Typed model outputs (port of `vit_ad_tpu/models/outputs.py`)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class EncoderOutput(NamedTuple):
    """patch_embedding: [B, P, D] patch tokens; latent: [B, D] cls token."""

    patch_embedding: torch.Tensor
    latent: torch.Tensor


class FlowOutput(NamedTuple):
    """loss: scalar NLL; anomaly_score_map: [B, H, W] upsampled to img_size."""

    loss: torch.Tensor
    anomaly_score_map: torch.Tensor
