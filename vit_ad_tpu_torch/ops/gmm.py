"""Gaussian-mixture density math of the MDN head (port of
`vit_ad_tpu/ops/gmm.py`).

  log N(x; mu, sigma)   = -log(sigma) - log(2 pi)/2 - ((x - mu)/sigma)^2 / 2
  ll[b,p,d]             = logsumexp_k(log(pi~[b,p,k] + 1e-15)
                                      + log N(x[b,p,d]; mu[b,p,d,k], sigma[b,p,d,k]))
  mdn_loss              = -mean(ll)
  probability_map[b,p]  = exp(mean_d ll[b,p,d] - max over the batch)

Functions keep the JAX package's layouts: weights [D_in, D_out, K], biases
[D_out, K]. `fused_log_likelihood` streams K in chunks with an online
logsumexp and checkpoints each chunk, as the JAX scan does (:123); it is the
plain version of the Hopper kernels in `ops/cuda/gmm.py` (B2), and its
autograd is the plain version of their backwards (B3, B4).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
# Large-but-finite stand-in for -inf (JAX `_NEG_BIG`): every exp() argument
# stays finite, so no NaN reaches a gradient.
_NEG_BIG = -1e30


def log_gaussian_density(sigma: torch.Tensor, mu: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Elementwise log of the univariate normal density."""
    return -torch.log(sigma) - _HALF_LOG_2PI - 0.5 * torch.square((x - mu) / sigma)


def mixture_log_weights(pi_logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                        tau: float = 1.0, uniform: Optional[torch.Tensor] = None,
                        softmax: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                        ) -> torch.Tensor:
    """log(softmax-or-gumbel-softmax(pi) + 1e-15). With `generator` the
    logits get Gumbel noise -log(-log u), u uniform in [1e-20, 1) (the
    reference's gumbel_softmax(tau=1)); without it, the deterministic
    softmax (the eval path). `uniform`: the draw of u in [0, 1), made
    already (a mesh shard's part of the global draw); `softmax`: the softmax
    over the last axis (a sharded one on a mesh)."""
    logits = pi_logits.float()
    if uniform is None and generator is not None:
        uniform = torch.rand(logits.shape, generator=generator, device=logits.device,
                             dtype=logits.dtype)
    if uniform is not None:
        logits = (logits - torch.log(-torch.log(uniform * (1.0 - 1e-20) + 1e-20))) / tau
    return torch.log((torch.softmax(logits, dim=-1) if softmax is None else softmax(logits))
                     + 1e-15)


def log_likelihood_dense(x: torch.Tensor, pi_logits: torch.Tensor, sigma: torch.Tensor,
                         mu: torch.Tensor, generator: Optional[torch.Generator] = None,
                         tau: float = 1.0) -> torch.Tensor:
    """The reference's materialized form: x [B,P,D], pi [B,P,K], sigma/mu
    [B,P,D,K] → [B,P,D]. For tests and tiny models."""
    log_pi = mixture_log_weights(pi_logits, generator, tau)
    dens = log_gaussian_density(sigma, mu, x[..., None])
    return torch.logsumexp(log_pi[:, :, None, :] + dens, dim=-1)


def _round(t: torch.Tensor, matmul_dtype: torch.dtype) -> torch.Tensor:
    """A matmul operand rounded to `matmul_dtype` and held in f32, so the
    product runs in f32 on exact bf16 values (bf16 x bf16 is exact in f32):
    the arithmetic of the card's bf16 kernel with f32 accumulation."""
    return t if matmul_dtype == torch.float32 else t.to(matmul_dtype).float()


def sigma_from_pre(pre: torch.Tensor) -> torch.Tensor:
    """elu(pre) + 1 + 1e-15 in the TPU kernels' exact form,
    where(pre > 0, pre + 1, exp(pre)) + 1e-15 (elu(pre) + 1 would round
    exp(pre) - 1 + 1 and lose exp(pre)'s low bits). The exp branch sees
    min(pre, 0), so its unused gradient is never inf * 0."""
    return torch.where(pre > 0, pre + 1.0, torch.exp(torch.clamp(pre, max=0.0))) + 1e-15


def _chunk_terms(xf, xm, lp, ws, bs, wm, bm):
    """log_pi + log N for one chunk of components: [B,P,D,Kc]."""
    pre = torch.einsum("bpd,dek->bpek", xm, ws) + bs
    sigma = sigma_from_pre(pre)
    mu = torch.einsum("bpd,dek->bpek", xm, wm) + bm
    return lp[:, :, None, :] + log_gaussian_density(sigma, mu, xf[..., None])


def log_likelihood_from_log_pi(x: torch.Tensor, log_pi: torch.Tensor, w_sigma: torch.Tensor,
                               b_sigma: torch.Tensor, w_mu: torch.Tensor, b_mu: torch.Tensor,
                               k_chunk: int = 8,
                               matmul_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-feature log-likelihood [B,P,D] from log mixture weights
    [B,P,K], streaming K in chunks of `k_chunk` with an online logsumexp
    from the -1e30 sentinel. Peak memory is [B,P,D,k_chunk]; each chunk is
    recomputed in the backward (`torch.utils.checkpoint`). The matmul
    operands x and the weights are rounded to `matmul_dtype`; x - mu uses
    f32 x."""
    k = log_pi.shape[-1]
    xf = x.float()
    xm = _round(xf, matmul_dtype)
    w_sigma, w_mu = _round(w_sigma.float(), matmul_dtype), _round(w_mu.float(), matmul_dtype)
    m = torch.full(xf.shape, _NEG_BIG, dtype=torch.float32, device=xf.device)
    s = torch.zeros_like(m)
    for k0 in range(0, k, k_chunk):
        sl = slice(k0, k0 + k_chunk)
        args = (xf, xm, log_pi[..., sl], w_sigma[..., sl], b_sigma[..., sl], w_mu[..., sl],
                b_mu[..., sl])
        if torch.is_grad_enabled():
            t = checkpoint(_chunk_terms, *args, use_reentrant=False)
        else:
            t = _chunk_terms(*args)
        new_m = torch.maximum(m, t.amax(dim=-1))
        s = s * torch.exp(m - new_m) + torch.exp(t - new_m[..., None]).sum(dim=-1)
        m = new_m
    return m + torch.log(s)


def fused_log_likelihood(x: torch.Tensor, w_pi: torch.Tensor, b_pi: torch.Tensor,
                         w_sigma: torch.Tensor, b_sigma: torch.Tensor, w_mu: torch.Tensor,
                         b_mu: torch.Tensor, generator: Optional[torch.Generator] = None,
                         tau: float = 1.0, k_chunk: int = 8,
                         matmul_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fused MDN head + mixture log-likelihood (JAX `fused_log_likelihood`
    :77). x [B,P,D]; w_pi [D,K], b_pi [K]; w_sigma/w_mu [D,D,K], b_sigma/
    b_mu [D,K] → [B,P,D]. The pi head runs in f32."""
    xf = x.float()
    logits = torch.einsum("bpd,dk->bpk", xf, w_pi.float()) + b_pi.float()
    log_pi = mixture_log_weights(logits, generator, tau)
    return log_likelihood_from_log_pi(xf, log_pi, w_sigma, b_sigma.float(), w_mu,
                                      b_mu.float(), k_chunk, matmul_dtype)


def mdn_loss_from_log_likelihood(ll: torch.Tensor) -> torch.Tensor:
    """NLL loss."""
    return -torch.mean(ll)


def probability_map(ll: torch.Tensor) -> torch.Tensor:
    """[B,P] per-patch probability, normalized by the batch max."""
    per_patch = torch.mean(ll, dim=2)
    return torch.exp(per_patch - torch.max(per_patch))
