"""FastFlow-style 2-D normalizing flow anomaly head (port of
`vit_ad_tpu/models/flow.py`).

The module tree is the reference's FrEIA layout: `fast_flow_decoder.
module_list.{i}` AllInOneBlocks with `subnet.{0,2}` convs, `global_scale`,
`global_offset` and the `w_perm`/`w_perm_inv` permutation matrices, plus the
reference's unused `layer_norm` member — the state dict
`utils/torch_convert.export_nf_head` emits, loaded with strict=True. Each
block's permutation index is derived from its `w_perm` as `convert_nf_head`
does (perm[i] = argmax_j w_perm[i, j]) and refreshed on every load.

Step semantics (JAX `_step_apply` :95), all in f32: x1 = first C - C//2
channels, x2 = the rest; a = 0.1 * conv(relu(conv(x1))) with 3x3 (even
steps) or 1x1 (odd steps) kernels; s = 2.0 * 0.636 * atan(a[:C//2]), t =
a[C//2:]; x2 ← x2 * exp(s) + t; global affine with scale 0.2 * softplus(0.5 p);
then out[:, i] = y[:, perm[i]], an index gather (the JAX one-hot matmul was a
TPU workaround, flow.py:81-92). Internally the flow runs NCHW; its public
functions keep the JAX layouts ([B, H', W', C] in, [B, H, W] maps out).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vit_ad_tpu_torch.models.outputs import FlowOutput
from vit_ad_tpu_torch.ops.resize import interpolate_bilinear

# softplus_{beta=0.5} parameter value p with 0.1 * softplus(p) == 1.0
_GLOBAL_SCALE_INIT = 2.0 * math.log(math.exp(5.0) - 1.0)


def default_perms(n_steps: int, num_channels: int) -> np.ndarray:
    """Deterministic per-step channel permutations (rng seed = step index),
    identical to the JAX package's."""
    return np.stack(
        [np.random.default_rng(i).permutation(num_channels) for i in range(n_steps)]
    ).astype(np.int32)


def _refresh_perm(module: "AllInOneBlock", incompatible_keys) -> None:
    with torch.no_grad():
        module.perm.copy_(module.w_perm[:, :, 0, 0].argmax(dim=1))


class AllInOneBlock(nn.Module):
    """One FrEIA AllInOneBlock step (affine coupling + global affine + fixed
    channel permutation), forward and exact inverse on NCHW f32 maps."""

    def __init__(self, channels: int, hidden: int, kernel: int, perm: Sequence[int],
                 clamp: float = 2.0, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.split1 = channels - channels // 2
        self.split2 = channels // 2
        self.clamp = clamp
        self.subnet = nn.Sequential(
            nn.Conv2d(self.split1, hidden, kernel, padding=kernel // 2),
            nn.ReLU(),
            nn.Conv2d(hidden, 2 * self.split2, kernel, padding=kernel // 2),
        )
        self.global_scale = nn.Parameter(torch.full((1, channels, 1, 1), _GLOBAL_SCALE_INIT))
        self.global_offset = nn.Parameter(torch.zeros(1, channels, 1, 1))
        perm_t = torch.as_tensor(np.asarray(perm), dtype=torch.long)
        w_perm = torch.zeros(channels, channels)
        w_perm[torch.arange(channels), perm_t] = 1.0
        self.register_buffer("w_perm", w_perm[:, :, None, None].clone())
        self.register_buffer("w_perm_inv", w_perm.t().contiguous()[:, :, None, None])
        self.register_buffer("perm", perm_t.clone(), persistent=False)
        self.register_load_state_dict_post_hook(_refresh_perm)
        for conv in (self.subnet[0], self.subnet[2]):  # He uniform, zero bias
            nn.init.kaiming_uniform_(conv.weight, nonlinearity="relu", generator=generator)
            nn.init.zeros_(conv.bias)

    def _coupling(self, x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        a = self.subnet(x1) * 0.1
        s = self.clamp * 0.636 * torch.atan(a[:, : self.split2])
        return s, a[:, self.split2:]

    def _affine_scale(self) -> torch.Tensor:
        g = self.global_scale
        return 0.2 * torch.logaddexp(torch.zeros_like(g), 0.5 * g)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h, w = x.shape[2], x.shape[3]
        x1, x2 = x[:, : self.split1], x[:, self.split1:]
        s, t = self._coupling(x1)
        x2 = x2 * torch.exp(s) + t
        logdet = s.sum(dim=(1, 2, 3))
        scale = self._affine_scale()
        y = torch.cat([x1, x2], dim=1) * scale + self.global_offset
        logdet = logdet + h * w * torch.log(scale).sum()
        return y.index_select(1, self.perm), logdet

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        y = torch.empty_like(y).index_copy_(1, self.perm, y)
        y = (y - self.global_offset) / self._affine_scale()
        x1, x2 = y[:, : self.split1], y[:, self.split1:]
        s, t = self._coupling(x1)
        return torch.cat([x1, (x2 - t) * torch.exp(-s)], dim=1)


class _SequenceINN(nn.Module):
    """FrEIA SequenceINN's attribute layout (`module_list`)."""

    def __init__(self, blocks: Sequence[nn.Module]) -> None:
        super().__init__()
        self.module_list = nn.ModuleList(blocks)


class NormalizingFlow(nn.Module):
    """Stack of `flow_steps` AllInOneBlocks, kernels alternating 3x3 (even
    steps) / 1x1 (odd steps), hidden width int((C - C//2) * hidden_ratio).
    `perms` defaults to `default_perms`; a loaded state dict's `w_perm`
    replaces them."""

    def __init__(self, num_channels: int, img_size: int, num_patches: int,
                 hidden_ratio: float = 1.0, flow_steps: int = 8, clamp: float = 2.0,
                 perms: Optional[Sequence[Sequence[int]]] = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        c = num_channels
        self.num_channels = c
        self.img_size = img_size
        self.num_patches = num_patches
        hidden = int((c - c // 2) * hidden_ratio)
        perms = default_perms(flow_steps, c) if perms is None else np.asarray(perms)
        if len(perms) != flow_steps:
            raise ValueError(f"perms has {len(perms)} entries, need {flow_steps}")
        self.fast_flow_decoder = _SequenceINN([
            AllInOneBlock(c, hidden, 3 if i % 2 == 0 else 1, perms[i], clamp, generator)
            for i in range(flow_steps)
        ])
        side = math.isqrt(num_patches)
        self.layer_norm = nn.LayerNorm([c, side, side])  # reference member, unused

    @property
    def steps(self) -> nn.ModuleList:
        return self.fast_flow_decoder.module_list

    @property
    def perms(self) -> np.ndarray:
        return np.stack([b.perm.cpu().numpy() for b in self.steps]).astype(np.int32)

    def _transform_nchw(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        z = x.float().permute(0, 3, 1, 2).contiguous()
        logdet = torch.zeros(z.shape[0], dtype=torch.float32, device=z.device)
        for blk in self.steps:
            z, ld = blk(z)
            logdet = logdet + ld
        return z, logdet

    def transform(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, H, W, C] → (z [B, H, W, C], logdet [B])."""
        z, logdet = self._transform_nchw(x)
        return z.permute(0, 2, 3, 1), logdet

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        x = z.float().permute(0, 3, 1, 2).contiguous()
        for blk in reversed(self.steps):
            x = blk.inverse(x)
        return x.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> FlowOutput:
        """Loss + anomaly map (reference NormalizingFlow.forward, :118-145).
        x: [B, H', W', C] feature map."""
        z, logdet = self._transform_nchw(x)
        zz = z * z
        loss = torch.mean(0.5 * zz.sum(dim=(1, 2, 3)) - logdet)
        anomaly = 1.0 - torch.exp(-0.5 * zz.mean(dim=1))  # [B, H', W']
        anomaly_map = interpolate_bilinear(anomaly, self.img_size, self.img_size,
                                           align_corners=False)
        return FlowOutput(loss=loss, anomaly_score_map=anomaly_map)


def patch_tokens_to_map(patch_embedding: torch.Tensor) -> torch.Tensor:
    """[B, P, D] → [B, √P, √P, D] (reference LearnerNF.py:140-144)."""
    b, p, d = patch_embedding.shape
    side = math.isqrt(p)
    return patch_embedding.reshape(b, side, side, d)
