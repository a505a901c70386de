"""Conv decoders of the reconstruction head (port of
`vit_ad_tpu/models/decoders.py`; reference src/classes/CnnDecoder.py).

  * SmallDecoder: DecoderVanillaCNN (CnnDecoder.py:16-117): an optional MLP
    z → 2z → 768·s·s unflattened channel-first to [768, s, s], then five
    ConvTranspose stages 768 → 384 → 192 → 96 → 48 → 3, each with BatchNorm
    and ReLU, the last with BatchNorm and tanh; `linear_end` is
    DecoderCNNLinEnd (:120-155): ReLU and a linear 3x3 conv instead of tanh.
  * ResNetDecoder: DecoderResNetVariableEmbeddingSize (:158-196): fc
    emb → 2·emb → 2048, the ReverseResNet trunk to [64, img/4, img/4],
    nearest upsampling to img/2, the 7x7 stride-2 transposed conv, BatchNorm,
    tanh.

State-dict keys are the reference's, as the JAX exporters emit them
(`utils/torch_convert.export_small_decoder` :858, `export_resnet_decoder`
:920): the small decoder registers each ConvTranspose twice, as
`recon_conv{i}` and as `decoder_cnn.{3(i-1)}` (the BatchNorms only at
`decoder_cnn.{3(i-1)+1}`), and the final conv of `linear_end` as
`linear_end` and `decoder_cnn.14`; both names hold the same module objects.
Decoders take [B, z] latents or NCHW maps and return NCHW [B, 3, H, W].
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.cnn import CHANNELS
from vit_ad_tpu_torch.models.layers import FusedBatchNorm, init_conv_layers
from vit_ad_tpu_torch.models.reverse_resnet import ReverseResNet, conv_transpose

DECODER_CHANNELS = (384, 192, 96, 48, 3)


def _linear(x: torch.Tensor, m: nn.Linear, cd: torch.dtype) -> torch.Tensor:
    return F.linear(x, m.weight.to(cd), m.bias.to(cd))


class SmallDecoder(nn.Module):
    """The 5-stage transposed-conv decoder ("small decoder"): a [B, 768, s, s]
    map (`z_space=0`) or a [B, z_space] latent → [B, 3, 32s, 32s] with
    s = ceil(img/32)."""

    def __init__(self, img_size: int = 224, z_space: int = 0, linear_end: bool = False,
                 dtypes: DtypePolicy = DtypePolicy(),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.img_size, self.z_space, self.has_linear_end = img_size, z_space, linear_end
        self.dtypes = dtypes
        self.side = math.ceil(img_size / 32)
        width = CHANNELS[-1]
        if z_space:
            self.decoder_lin = nn.Sequential(
                nn.Linear(z_space, 2 * z_space), nn.ReLU(),
                nn.Linear(2 * z_space, width * self.side * self.side), nn.ReLU())
        stages, cin = [], width
        for i, ch in enumerate(DECODER_CHANNELS):
            last = i == len(DECODER_CHANNELS) - 1
            # torch ConvTranspose2d(3, s2, p1, op1) (reference CnnDecoder.py:47-117)
            act = (nn.Conv2d(3, 3, 3, padding=1) if linear_end else nn.Tanh()) if last \
                else nn.ReLU()
            stages += [nn.ConvTranspose2d(cin, ch, 3, stride=2, padding=1, output_padding=1),
                       FusedBatchNorm(ch), act]
            cin = ch
        self.decoder_cnn = nn.Sequential(*stages)
        for i in range(len(DECODER_CHANNELS)):
            setattr(self, f"recon_conv{i + 1}", self.decoder_cnn[3 * i])
        if linear_end:
            self.linear_end = self.decoder_cnn[14]
        init_conv_layers(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.dtypes.compute_dtype
        x = x.to(cd)
        if self.z_space:
            x = F.relu(_linear(x, self.decoder_lin[0], cd))
            x = F.relu(_linear(x, self.decoder_lin[2], cd))
            x = x.view(x.shape[0], CHANNELS[-1], self.side, self.side)  # channel-first
        x = x.contiguous(memory_format=torch.channels_last)
        for i in range(len(DECODER_CHANNELS)):
            x = self.decoder_cnn[3 * i + 1](conv_transpose(x, self.decoder_cnn[3 * i], cd)).to(cd)
            if i < len(DECODER_CHANNELS) - 1:
                x = F.relu(x)
        if self.has_linear_end:
            end = self.decoder_cnn[14]
            return F.conv2d(F.relu(x), end.weight.to(cd), end.bias.to(cd), padding=1)
        return torch.tanh(x)


class ResNetDecoder(ReverseResNet):
    """The variable-embedding ResNet decoder of the transformer AEs: a
    [B, embedding_size] latent → [B, 3, img, img] in [-1, 1]. The trunk's
    layers, `de_conv1` and `bn1` sit at the module's root, beside `fc1.0` and
    `fc2.0`, as in the reference's keys."""

    def __init__(self, embedding_size: int, img_size: int = 224,
                 dtypes: DtypePolicy = DtypePolicy(),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(img_size, dtypes, generator)
        self.embedding_size = embedding_size
        self.fc1 = nn.Sequential(nn.Linear(embedding_size, 2 * embedding_size), nn.ReLU())
        self.fc2 = nn.Sequential(nn.Linear(2 * embedding_size, 2048), nn.ReLU())
        init_conv_layers(self.fc1, generator)
        init_conv_layers(self.fc2, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cd = self.dtypes.compute_dtype
        x = F.relu(_linear(z.to(cd), self.fc1[0], cd))
        return super().forward(F.relu(_linear(x, self.fc2[0], cd)))
