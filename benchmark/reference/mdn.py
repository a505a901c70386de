"""Plain PyTorch Gaussian mixture density head (the reference repo's
MixtureDensityNetwork: three `nn.Linear` heads `pi` D→K, `sigma` D→D·K and
`mu` D→D·K over each patch token), read from its state dict.

For a token x (D features) and component k: pi = softmax of the pi head's
logits (with Gumbel noise while training: the logits plus -log(-log u) for a
uniform u, the reference's gumbel_softmax at tau 1; u is mapped to
u * (1 - 1e-20) + 1e-20 so that no log sees 0), sigma[d, k] =
elu(pre[d, k]) + 1 + 1e-15 with pre the sigma head's output viewed as
[D, K], mu[d, k] likewise, and per feature
  ll[d] = logsumexp_k(log(pi[k] + 1e-15) + log N(x[d]; mu[d, k], sigma[d, k])).
The training loss is -mean(ll) over images, tokens and features; the scoring
payload is mean_d ll per token. Float32 with TF32 off, `rows` tokens at a
time; the control rounds the products' operands one step below the stated
precision (`precision.py`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from reference.precision import product_precision, round_to

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


class MDN:
    def __init__(self, sd: Dict[str, torch.Tensor], cfg: dict, control: bool = False) -> None:
        self.sd = sd
        self.k = int(cfg["num_gaussians"])
        self.prec = product_precision(cfg["head_dtype"], control)
        self.pi_prec = product_precision(cfg["pi_dtype"], control)

    def gumbel(self, u: torch.Tensor) -> torch.Tensor:
        return -torch.log(-torch.log(u * (1.0 - 1e-20) + 1e-20))

    def log_likelihood(self, x: torch.Tensor, u: Optional[torch.Tensor] = None,
                       params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Tokens x [R, D] (and, while training, uniforms u [R, K]) →
        ll [R, D]."""
        p = self.sd if params is None else params
        r, d = x.shape
        logits = (round_to(x, self.pi_prec) @ round_to(p["pi.weight"], self.pi_prec).t()
                  + p["pi.bias"])
        if u is not None:
            logits = logits + self.gumbel(u)
        log_pi = torch.log(torch.softmax(logits, dim=-1) + 1e-15)
        xm = round_to(x, self.prec)
        pre = (xm @ round_to(p["sigma.weight"], self.prec).t() + p["sigma.bias"]).view(r, d,
                                                                                        self.k)
        sigma = F.elu(pre) + 1.0 + 1e-15
        mu = (xm @ round_to(p["mu.weight"], self.prec).t() + p["mu.bias"]).view(r, d, self.k)
        log_n = -torch.log(sigma) - HALF_LOG_2PI - 0.5 * torch.square((x[..., None] - mu) / sigma)
        return torch.logsumexp(log_pi[:, None, :] + log_n, dim=-1)

    @torch.no_grad()
    def token_scores(self, feats: torch.Tensor, rows: int = 784) -> torch.Tensor:
        """Features [N, P, D] → mean_d ll [N, P], `rows` tokens at a time."""
        n, p, d = feats.shape
        flat = feats.reshape(-1, d)
        out = [self.log_likelihood(flat[s:s + rows]).mean(dim=-1)
               for s in range(0, flat.shape[0], rows)]
        return torch.cat(out).reshape(n, p)
