"""Mirror-image ResNet decoder (port of `vit_ad_tpu/models/reverse_resnet.py`;
reference ReverseResNet, src/classes/resnet/ReverseResNet.py:106-252).

Transposed-conv bottlenecks in the stage layout (3, 6, 4, 3), walking
2048 → 1024 → 512 → 256 → 64 channels while upsampling 1 → img/32 → img/4,
then nearest upsampling to img/2, a 7x7 stride-2 transposed conv to 3
channels, BatchNorm and tanh. As in the JAX package, nearest upsampling
stands in for the reference's MaxUnpool2d.

Module layout and state-dict keys are the reference's (`layer{n}.{i}.conv{1,2,3}`,
`bn{1,2,3}`, `upsample.{0,1}`, `de_conv1`, `bn1`), with its
`ConvTranspose2d(k, s, padding=p, output_padding=op)` settings, so the JAX
exporters' output (`utils/torch_convert.export_reverse_resnet` :934,
`export_resnet_decoder` :920) loads with strict=True. Maps are NCHW in
channels_last memory; convolutions run in the policy's compute dtype, the
BatchNorms are `layers.FusedBatchNorm` (f32 batch statistics in training).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.layers import FusedBatchNorm, init_conv_layers

LAYERS = (3, 6, 4, 3)  # reference ReverseResNet layers (ReverseResNet.py:115)
# (layer, planes, in channels, out channels, blocks, stride of the last block),
# layer4 first: the encoder's stages in reverse
STAGES = ((4, 512, 2048, 1024, LAYERS[3], 2), (3, 256, 1024, 512, LAYERS[2], 2),
          (2, 128, 512, 256, LAYERS[1], 2), (1, 64, 256, 64, LAYERS[0], 1))


def upsample_nearest(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B, C, h, h] → [B, C, size, size] nearest (JAX `_upsample_nearest`
    :39): a repeat where size divides evenly, else `jax.image.resize`'s
    nearest, which samples at half-pixel centres: torch's "nearest-exact"
    (not "nearest") in both cases."""
    if x.shape[-2] == size:
        return x
    return F.interpolate(x, size=(size, size), mode="nearest-exact")


def conv_transpose(x: torch.Tensor, m: nn.ConvTranspose2d, cd: torch.dtype) -> torch.Tensor:
    """`m` applied in the compute dtype (weights cast per call)."""
    bias = None if m.bias is None else m.bias.to(cd)
    return F.conv_transpose2d(x, m.weight.to(cd), bias, m.stride, m.padding, m.output_padding)


def _convt(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
           bias: bool = False) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, cout, k, stride=stride, padding=padding,
                              output_padding=stride - 1, bias=bias)


class ReverseBottleneck(nn.Module):
    """Transposed bottleneck: 1x1 (in → planes) → 3x3 transposed (stride) →
    1x1 (planes → out), residual; `upsample` (1x1 transposed at the stride +
    BatchNorm) on the identity where the channels or the size change."""

    def __init__(self, cin: int, planes: int, cout: int, stride: int = 1,
                 upsample: bool = False) -> None:
        super().__init__()
        self.conv3, self.bn3 = _convt(cin, planes, 1), FusedBatchNorm(planes)
        self.conv2, self.bn2 = _convt(planes, planes, 3, stride, padding=1), FusedBatchNorm(planes)
        self.conv1, self.bn1 = _convt(planes, cout, 1), FusedBatchNorm(cout)
        self.upsample = (nn.Sequential(_convt(cin, cout, 1, stride), FusedBatchNorm(cout))
                         if upsample else None)

    def forward(self, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        out = F.relu(self.bn3(conv_transpose(x, self.conv3, cd)).to(cd))
        out = F.relu(self.bn2(conv_transpose(out, self.conv2, cd)).to(cd))
        out = self.bn1(conv_transpose(out, self.conv1, cd)).to(cd)
        if self.upsample is not None:
            x = self.upsample[1](conv_transpose(x, self.upsample[0], cd)).to(cd)
        return F.relu(out + x)


class ReverseResNet(nn.Module):
    """[B, 2048] (or [B, 2048, 1, 1]) → a reconstruction [B, 3, img, img] in
    [-1, 1] (JAX `ReverseResNet` :98). `trunk` is the cnns-only path of JAX
    `ReverseResNetTrunk` (:139; reference `_forward_cnns_only`,
    ReverseResNet.py:234-242), whose layers `ResNetDecoder` shares."""

    def __init__(self, img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.img_size = img_size
        self.dtypes = dtypes
        for layer, planes, cin, cout, blocks, stride in STAGES:
            setattr(self, f"layer{layer}", nn.Sequential(
                *[ReverseBottleneck(cin, planes, cin) for _ in range(blocks - 1)],
                ReverseBottleneck(cin, planes, cout, stride, upsample=True)))
        # reference de_conv1: k7 s2 p3 op1 (ReverseResNet.py:128-130)
        self.de_conv1 = _convt(64, 3, 7, stride=2, padding=3)
        self.bn1 = FusedBatchNorm(3)
        init_conv_layers(self, generator)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 2048] or [B, 2048, 1, 1] → [B, 64, img/4, img/4]."""
        cd = self.dtypes.compute_dtype
        if x.ndim == 2:
            x = x[:, :, None, None]
        x = upsample_nearest(x.to(cd), self.img_size // 32)
        x = x.contiguous(memory_format=torch.channels_last)
        for layer, *_ in STAGES:
            for blk in getattr(self, f"layer{layer}"):
                x = blk(x, cd)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.dtypes.compute_dtype
        x = upsample_nearest(self.trunk(x), self.img_size // 2)
        return torch.tanh(self.bn1(conv_transpose(x, self.de_conv1, cd)).to(cd))
