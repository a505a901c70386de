"""Plain PyTorch DeiT / ViT trunk (Touvron et al., arXiv:2012.12877; timm's
`VisionTransformer` and `DistilledVisionTransformer`), read from a timm state
dict.

Pre-LN blocks: x += proj(attention(LN1(x))), x += fc2(gelu(fc1(LN2(x)))),
LayerNorm eps 1e-6, then the final LayerNorm; the patch tokens are the rows
after the prefix tokens (cls, and dist for the distilled model). Everything
is float32 with TF32 off, computed in blocks of images. Departures from the
published model, both stated by the configuration file: the GELU is the
configuration's (`gelu`: "tanh" is the tanh approximation the measured
program runs under bfloat16, "erf" the published exact GELU), and the
products' operands are rounded to `precision.round_to` of the configuration's
stated precision (float32, that is unchanged, in the reference; one step
lower in the control). Image preprocessing is x / 255 standardised by the
configuration's mean and std.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from reference.precision import product_precision, round_to

LN_EPS = 1e-6


def preprocess(images_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 [N, H, W, 3] → float32 [N, 3, H, W], standardised."""
    x = images_u8.float() / 255.0
    m = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).permute(0, 3, 1, 2)


class DeiT:
    """The trunk of `cfg` on the tensors of a timm state dict `sd`."""

    def __init__(self, sd: Dict[str, torch.Tensor], cfg: dict, control: bool = False) -> None:
        self.sd = sd
        self.depth = int(cfg["depth"])
        self.heads = int(cfg["num_heads"])
        self.patch = int(cfg["patch_size"])
        self.prefix = int(cfg["num_prefix_tokens"])
        self.gelu = {"tanh": "tanh", "erf": "none"}[cfg["gelu"]]
        self.prec = product_precision(cfg["trunk_dtype"], control)

    def _linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w, b = self.sd[name + ".weight"], self.sd[name + ".bias"]
        return round_to(x, self.prec) @ round_to(w, self.prec).t() + b.float()

    def _ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.sd[name + ".weight"].float(),
                            self.sd[name + ".bias"].float(), LN_EPS)

    def _attention(self, x: torch.Tensor, i: int) -> torch.Tensor:
        n, t, d = x.shape
        hd = d // self.heads
        qkv = self._linear(x, f"blocks.{i}.attn.qkv").reshape(n, t, 3, self.heads, hd)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))  # [N, H, T, hd]
        logits = round_to(q, self.prec) @ round_to(k, self.prec).transpose(-1, -2)
        p = torch.softmax(logits / math.sqrt(hd), dim=-1)
        out = round_to(p, self.prec) @ round_to(v, self.prec)
        return self._linear(out.transpose(1, 2).reshape(n, t, d), f"blocks.{i}.attn.proj")

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Preprocessed images [N, 3, H, W] → the final-normed tokens."""
        sd = self.sd
        w = round_to(sd["patch_embed.proj.weight"], self.prec)
        y = F.conv2d(round_to(x, self.prec), w, sd["patch_embed.proj.bias"].float(),
                     stride=self.patch)
        y = y.flatten(2).transpose(1, 2)
        pre = [sd["cls_token"]] + ([sd["dist_token"]] if self.prefix == 2 else [])
        pre = torch.cat(pre, dim=1).float().expand(y.shape[0], -1, -1)
        x = torch.cat([pre, y], dim=1) + sd["pos_embed"].float()
        for i in range(self.depth):
            x = x + self._attention(self._ln(x, f"blocks.{i}.norm1"), i)
            h = F.gelu(self._linear(self._ln(x, f"blocks.{i}.norm2"), f"blocks.{i}.mlp.fc1"),
                       approximate=self.gelu)
            x = x + self._linear(h, f"blocks.{i}.mlp.fc2")
        return self._ln(x, "norm")

    @torch.no_grad()
    def patch_features(self, images_u8: torch.Tensor, mean, std,
                       block: int = 32) -> torch.Tensor:
        """uint8 [N, H, W, 3] on the device → patch tokens [N, P, D] float32,
        `block` images at a time."""
        out = [self.tokens(preprocess(images_u8[s:s + block], mean, std))[:, self.prefix:]
               for s in range(0, images_u8.shape[0], block)]
        return torch.cat(out)
