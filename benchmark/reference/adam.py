"""Adam with coupled L2 weight decay (Kingma and Ba, arXiv:1412.6980, with
the decay added to the gradient before the moments, as `torch.optim.Adam`'s
`weight_decay` and the reference repo's heads use it), in float32."""

from __future__ import annotations

import math
from typing import Dict

import torch

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


class Adam:
    def __init__(self, lr: float, weight_decay: float) -> None:
        self.lr, self.wd = lr, weight_decay
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """Update `params` in place; return the gradients as the moments took
        them (the raw gradient plus weight_decay times the parameter). A
        parameter with no gradient is left as it is, as torch's Adam leaves
        one whose `.grad` is None."""
        self.t += 1
        bc1 = 1.0 - BETA1 ** self.t
        bc2 = 1.0 - BETA2 ** self.t
        taken = {}
        for name, p in params.items():
            if name not in grads:
                continue
            g = grads[name] + self.wd * p
            taken[name] = g
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            m.mul_(BETA1).add_(g, alpha=1.0 - BETA1)
            v.mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
            p.sub_(self.lr / bc1 * m / (v.sqrt() / math.sqrt(bc2) + EPS))
        return taken
