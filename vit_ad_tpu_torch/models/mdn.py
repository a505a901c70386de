"""Gaussian mixture density network anomaly head (port of
`vit_ad_tpu/models/mdn.py::GaussianMDN` :34).

Three linear heads over per-patch features: pi D→K mixture logits, sigma
D→D*K (sigma = elu + 1 + 1e-15) and mu D→D*K. Parameters are the reference's
`pi`/`sigma`/`mu` nn.Linear modules (reference
src/classes/MixtureDensityNetwork.py:129-141), so
`vit_ad_tpu/utils/torch_convert.export_mdn_head` output loads with
strict=True; the GMM kernels read that layout in place. The matmul-type
copies of the sigma and mu heads that the kernels take are cached while the
head is frozen (`kernel_operands`).

On a mesh (`parallel/`) a head holds K/M of a K-mixture's components
(`parallel/sharding.shard_mdn`, `place`): its log-likelihood takes the global
mixture weights from the sharded pi logits, runs the GMM kernels on its own
components (a shard is simply a smaller head to them) and merges the model
ranks' partial log-likelihoods with a logsumexp.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.layers import ComputeWeights, trunc_normal_
from vit_ad_tpu_torch.ops import gmm
from vit_ad_tpu_torch.ops.cuda.gmm import gmm_log_likelihood, kernel_operands


class GaussianMDN(nn.Module):
    def __init__(self, features: int, num_gaussians: int, dtypes: DtypePolicy = DtypePolicy(),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.features = features
        self.num_gaussians = num_gaussians
        self.dtypes = dtypes
        self.pi = nn.Linear(features, num_gaussians)
        self.sigma = nn.Linear(features, features * num_gaussians)
        self.mu = nn.Linear(features, features * num_gaussians)
        self._kernel_operands = ComputeWeights(type(self)._operands, card_only=True)
        # the mesh (a `parallel.context.MeshContext`) and this head's
        # components of the full mixture, set by `place`
        self.mesh: Any = None
        self.components = slice(0, num_gaussians)
        self.total_gaussians = num_gaussians
        self.reset_parameters(generator)

    def place(self, mesh: Any, components: slice, total: int) -> None:
        """Make this head the shard `components` of a `total`-component
        head on `mesh`."""
        self.mesh, self.components, self.total_gaussians = mesh, components, total

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX init: xavier-normal (flax's truncated form) on the flat
        weights, mu bias 0.001, the other biases 0."""
        for lin in (self.pi, self.sigma, self.mu):
            fan_out, fan_in = lin.weight.shape
            std = math.sqrt(2.0 / (fan_in + fan_out)) / 0.87962566103423978
            trunc_normal_(lin.weight.data, std, generator)
            nn.init.zeros_(lin.bias)
        nn.init.constant_(self.mu.bias, 0.001)

    def log_pi(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               tau: float = 1.0) -> torch.Tensor:
        """log mixture weights [..., K] from the f32 pi head; Gumbel noise
        from `generator` when one is given."""
        logits = F.linear(x.float(), self.pi.weight.float(), self.pi.bias.float())
        if self.mesh is None:
            return gmm.mixture_log_weights(logits, generator, tau)
        # this shard's components of the single-device draw: the global
        # shape drawn from this rank's copy of the generator, its rows and
        # components kept
        u = None if generator is None else self.mesh.draw_rows(
            torch.rand, (*logits.shape[:-1], self.total_gaussians), generator=generator,
            device=logits.device, dtype=logits.dtype)[..., self.components]
        return gmm.mixture_log_weights(logits, tau=tau, uniform=u, softmax=self._mesh_softmax)

    def _mesh_softmax(self, logits: torch.Tensor) -> torch.Tensor:
        """The softmax over all K of this shard's logits: from the max
        (all-reduced, no gradient) and the sum of exponentials (all-reduced,
        with gradient)."""
        top = self.mesh.model_max(logits.detach().amax(dim=-1, keepdim=True))
        e = torch.exp(logits - top)
        return e / self.mesh.reduce_sum(e.sum(dim=-1, keepdim=True), "model")

    def kernel_operands(self) -> Dict[str, torch.Tensor]:
        """The sigma and mu heads as the GMM kernels take them
        (`ops/cuda/gmm.kernel_operands`: the weights in the compute dtype, the
        biases component-major). Cached and made again only when a parameter
        changed (storage or in-place version); while gradients flow to the
        parameters they are made per call, as the JAX package casts per call."""
        return self._kernel_operands.get(self, self.dtypes)

    def _operands(self, cd: torch.dtype) -> Dict[str, torch.Tensor]:
        return kernel_operands(self.sigma.weight, self.sigma.bias, self.mu.weight, self.mu.bias,
                               cd)

    def log_likelihood(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                       tau: float = 1.0) -> torch.Tensor:
        """Per-feature log-likelihood [B,P,D]: the GMM kernels (B2, B3, B4)
        on CUDA tensors, `ops/gmm`'s plain version on CPU tensors; matmul
        operands in the policy's compute dtype. x is cast to f32 once, so the
        f32 dx of the pi head and of the mixture are summed before the cast
        back. On a mesh with a model axis, the f32 x enters through an
        identity whose backward sums the shards' partial dx, and the shards'
        log-likelihoods merge by a logsumexp whose backward keeps this rank's
        slice (`MeshContext.gather_own_grad`)."""
        sharded = self.mesh is not None and self.mesh.model_size > 1
        xf = x.float()
        if sharded:
            xf = self.mesh.replicate_in(xf)
        ll = gmm_log_likelihood(xf, self.log_pi(xf, generator, tau), self.sigma.weight,
                                self.sigma.bias, self.mu.weight, self.mu.bias,
                                self.dtypes.compute_dtype,
                                self.kernel_operands() if x.is_cuda else None)
        return torch.logsumexp(self.mesh.gather_own_grad(ll), dim=0) if sharded else ll

    def loss(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return gmm.mdn_loss_from_log_likelihood(self.log_likelihood(x, generator))

    def probability_map(self, x: torch.Tensor,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, P] per-patch probability map."""
        return gmm.probability_map(self.log_likelihood(x, generator))
