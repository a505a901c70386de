"""Bilinear interpolation with both align_corners conventions (port of
`vit_ad_tpu/ops/resize.py`). The JAX package wrote its own gather version
because `jax.image.resize` matches neither torch convention; here
`F.interpolate` is the convention itself."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def interpolate_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                         align_corners: bool = False) -> torch.Tensor:
    """Resize the two middle spatial dims of [B, H, W, C] (or the trailing
    dims of [B, H, W]) to (out_h, out_w). Non-float input is computed in f32."""
    squeeze = x.dim() == 3
    if not x.is_floating_point():
        x = x.float()
    nchw = x.unsqueeze(1) if squeeze else x.permute(0, 3, 1, 2)
    out = F.interpolate(nchw, size=(out_h, out_w), mode="bilinear",
                        align_corners=align_corners)
    return out[:, 0] if squeeze else out.permute(0, 2, 3, 1)
