"""Plain PyTorch FastFlow-style normalizing flow (Yu et al., arXiv:2111.07677)
with FrEIA's `AllInOneBlock` semantics, read from a FrEIA `SequenceINN` state
dict (`module_list.{i}.*`).

One step on an NCHW map with C channels: x1 = the first C - C//2 channels,
x2 = the rest; a = 0.1 * conv2(relu(conv1(x1))) (3x3 kernels on even steps,
1x1 on odd, "same" padding); s = clamp * 0.636 * atan(a[:, :C//2]) with
clamp 2, t = a[:, C//2:]; x2 = x2 * exp(s) + t; log-det sum(s). Then the
global affine y = x * scale + offset with scale = 0.1 * softplus_{beta=0.5}
(global_scale), log-det H * W * sum(log scale), and the fixed permutation,
applied as FrEIA applies it: a 1x1 convolution with `w_perm`.

The head's loss per image is 0.5 * sum(z^2) - logdet; its anomaly map is
1 - exp(-0.5 * mean_c z^2), upsampled bilinearly (align_corners=False) to the
image size (the reference repo's NormalizingFlow.forward). Float32, TF32 off;
the control rounds the convolutions' operands one step below the stated
precision (`precision.py`).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from reference.precision import product_precision, round_to

CLAMP = 2.0


class Flow:
    def __init__(self, sd: Dict[str, torch.Tensor], cfg: dict, control: bool = False) -> None:
        self.sd = sd
        self.steps = int(cfg["flow_steps"])
        self.prec = product_precision(cfg["head_dtype"], control)

    def _conv(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return F.conv2d(round_to(x, self.prec), round_to(w, self.prec), b,
                        padding=w.shape[-1] // 2)

    def transform(self, x: torch.Tensor, params: Dict[str, torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N, C, H, W] float32 → (z [N, C, H, W], logdet [N]). `params`
        (default: the state dict) may hold tensors that require gradients."""
        p = self.sd if params is None else params
        c, h, w = x.shape[1], x.shape[2], x.shape[3]
        c2 = c // 2
        c1 = c - c2
        logdet = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        for i in range(self.steps):
            k = f"module_list.{i}."
            x1, x2 = x[:, :c1], x[:, c1:]
            a = self._conv(F.relu(self._conv(x1, p[k + "subnet.0.weight"],
                                             p[k + "subnet.0.bias"])),
                           p[k + "subnet.2.weight"], p[k + "subnet.2.bias"]) * 0.1
            s = CLAMP * 0.636 * torch.atan(a[:, :c2])
            x2 = x2 * torch.exp(s) + a[:, c2:]
            logdet = logdet + s.sum(dim=(1, 2, 3))
            scale = 0.1 * F.softplus(p[k + "global_scale"], beta=0.5)
            y = torch.cat([x1, x2], dim=1) * scale + p[k + "global_offset"]
            logdet = logdet + h * w * torch.log(scale).sum()
            x = F.conv2d(y, p[k + "w_perm"].float())
        return x, logdet


def tokens_to_map(tokens: torch.Tensor) -> torch.Tensor:
    """Patch tokens [N, P, D] → the NCHW map [N, D, sqrt(P), sqrt(P)]."""
    n, p, d = tokens.shape
    side = math.isqrt(p)
    return tokens.reshape(n, side, side, d).permute(0, 3, 1, 2)


def nf_loss_per_image(z: torch.Tensor, logdet: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(z * z, dim=(1, 2, 3)) - logdet


def anomaly_maps(z: torch.Tensor, img_size: int) -> torch.Tensor:
    """[N, C, h, w] → [N, img_size, img_size]."""
    a = 1.0 - torch.exp(-0.5 * torch.mean(z * z, dim=1))
    return F.interpolate(a[:, None], size=(img_size, img_size), mode="bilinear",
                         align_corners=False)[:, 0]
