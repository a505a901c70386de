"""Variational auto-encoder (port of `vit_ad_tpu/models/vae.py`; reference
src/classes/VariationalAutoEncoder.py, dead code there: no MODEL_DICT key
builds it, SURVEY.md §2.3).

The vanilla CNN encoder → its [s, s, 768] map flattened in (h, w, c) order,
as the JAX module flattens its tokens → `fc_mu` and `fc_log_var` (ELU + 1 +
1e-15 positivity, reference :35-54) → z = mu + exp(½ log_var)·ε → the small
decoder from the latent. ε is passed in, or drawn from an explicit
`torch.Generator`. State-dict keys: `encoder.*` (`VanillaCNNEncoder`),
`fc_mu.*`, `fc_log_var.*`, `decoder.*` (`SmallDecoder` with z_space =
latent_dim); `utils/convert.vae_state_dict_from_jax` gives them from the JAX
variables. Inputs are preprocessed images [B, H, W, 3].
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.cnn import CHANNELS, VanillaCNNEncoder
from vit_ad_tpu_torch.models.decoders import SmallDecoder
from vit_ad_tpu_torch.models.layers import init_conv_layers
from vit_ad_tpu_torch.models.outputs import AutoEncoderOutput


class VariationalAutoEncoder(nn.Module):
    def __init__(self, img_size: int = 224, latent_dim: int = 256,
                 dtypes: DtypePolicy = DtypePolicy(),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.img_size, self.latent_dim, self.dtypes = img_size, latent_dim, dtypes
        s = math.ceil(img_size / 32)
        self.flatten_size = CHANNELS[-1] * s * s
        self.encoder = VanillaCNNEncoder(img_size, dtypes, generator)
        self.fc_mu = nn.Linear(self.flatten_size, latent_dim)
        self.fc_log_var = nn.Linear(self.flatten_size, latent_dim)
        init_conv_layers(self.fc_mu, generator)
        init_conv_layers(self.fc_log_var, generator)
        self.decoder = SmallDecoder(img_size, z_space=latent_dim, dtypes=dtypes,
                                    generator=generator)

    def _dense(self, z: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
        cd = self.dtypes.compute_dtype
        return F.linear(z.to(cd), lin.weight.to(cd), lin.bias.to(cd))

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, log_var) [B, latent_dim] f32; the encoder's BatchNorms take
        batch statistics in train mode."""
        z = self.encoder(x).patch_embedding
        z = z.reshape(z.shape[0], -1)
        mu = self._dense(z, self.fc_mu)
        log_var = F.elu(self._dense(z, self.fc_log_var)) + 1.0 + 1e-15
        return mu.float(), log_var.float()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents [B, latent_dim] → reconstructions [B, H, W, 3]."""
        return self.decoder(z).permute(0, 2, 3, 1)

    def forward_with_posterior(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None
                               ) -> Tuple[AutoEncoderOutput, torch.Tensor, torch.Tensor]:
        """(output, mu, log_var) from ONE encode, so that the KL term
        penalizes the posterior the reconstruction's z was drawn from (JAX
        :66-79). ε [B, latent_dim] is `eps`, else standard normal from
        `generator` on x's device."""
        mu, log_var = self.encode(x)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, device=mu.device)
        z = mu + torch.exp(0.5 * log_var) * eps
        return AutoEncoderOutput(latent=z, reconstruction=self.decode(z)), mu, log_var

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> AutoEncoderOutput:
        return self.forward_with_posterior(x, eps, generator)[0]

    @staticmethod
    def kl_loss(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
        """KL(q || N(0, 1)), the batch mean (reference :57-62)."""
        return torch.mean(kl_per_example(mu, log_var))


def kl_per_example(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """-½ Σ (1 + log_var - mu² - exp(log_var)) over the latent, per row."""
    return -0.5 * torch.sum(1 + log_var - mu ** 2 - torch.exp(log_var), dim=-1)
