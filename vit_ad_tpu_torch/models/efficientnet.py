"""EfficientNet-B4 CNN encoder (port of `vit_ad_tpu/models/efficientnet.py`).

The B4-scaled MBConv trunk of NVIDIA's `efficientnet_widese_b4` (width 1.4,
depth 1.8 over the B0 block table: 32 blocks at 224 px): stem conv3x3/s2,
then inverted-bottleneck blocks (1x1 expand, depthwise kxk, squeeze-excite
sized from the EXPANDED width — "widese" —, 1x1 project, identity residual
where the shape allows), then the 1x1 head conv to 1792 channels. Every conv
has no bias and is followed by a BatchNorm (eps 1e-3) and, but for the
project conv, SiLU. Output: the head map's tokens [B, 49, 1792] at 224 px
and their mean as the latent.

Module layout and state-dict keys are NVIDIA's, the layout
`utils/torch_convert.convert_efficientnet` (:365) reads: `stem.{conv,bn}`,
`layer{L}.block{j}.{expand,depsep,proj}.{conv,bn}`,
`layer{L}.block{j}.se.{squeeze,expand}` (Linears) and `features.{conv,bn}`;
the classifier of NVIDIA's file is not part of the trunk. The block table
is a constructor argument (B0's by default), so a smaller table gives a toy
trunk on the same code path.

Cast points follow the JAX module: the maps are in the compute dtype, the
BatchNorms are `layers.FusedBatchNorm` in eval form on cached folded
statistics, the squeeze-excite mean is taken on the compute-dtype map (f32
sum, compute-dtype result, as `jnp.mean` of bf16). Convolutions, the
depthwise ones included, are cuDNN's on NCHW tensors in channels_last memory:
the JAX package has no kernel on this trunk. Its `VITAD_EFFNET_HARDSWISH`
measurement switch is not carried over.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.layers import (
    ComputeWeights,
    FusedBatchNorm,
    conv_bn,
    init_conv_layers,
)
from vit_ad_tpu_torch.models.outputs import EncoderOutput

BN_EPS = 1e-3
# (expand_ratio, channels, repeats, stride, kernel): the EfficientNet-B0 base
B0_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
# B4 scaling
WIDTH, DEPTH = 1.4, 1.8
SE_RATIO = 0.25


def round_channels(c: float, divisor: int = 8) -> int:
    c *= WIDTH
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


def round_repeats(r: int) -> int:
    return int(math.ceil(DEPTH * r))


class ConvBN(nn.Module):
    """A conv without bias and its BatchNorm, under NVIDIA's names."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 groups: int = 1) -> None:
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                              groups=groups, bias=False)
        self.bn = FusedBatchNorm(cout, eps=BN_EPS)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, squeeze: int) -> None:
        super().__init__()
        self.squeeze = nn.Linear(channels, squeeze)
        self.expand = nn.Linear(squeeze, channels)


class MBConv(nn.Module):
    """Inverted bottleneck with widese squeeze-excite (JAX `MBConv`)."""

    def __init__(self, cin: int, cout: int, expand: int, kernel: int, stride: int) -> None:
        super().__init__()
        mid = cin * expand
        self.expand = ConvBN(cin, mid) if expand != 1 else None
        self.depsep = ConvBN(mid, mid, kernel, stride, groups=mid)
        self.se = SqueezeExcite(mid, max(1, int(mid * SE_RATIO)))
        self.proj = ConvBN(mid, cout)
        self.residual = stride == 1 and cin == cout


def _conv_bn(x: torch.Tensor, m: ConvBN, w: Dict[str, Any], name: str,
             act: bool = True) -> torch.Tensor:
    weight, folded = w[name]
    y = conv_bn(x, m.conv, m.bn, weight, None, folded)
    return F.silu(y) if act else y


def _mbconv_apply(x: torch.Tensor, blk: MBConv, w: Dict[str, Any], pre: str) -> torch.Tensor:
    h = x if blk.expand is None else _conv_bn(x, blk.expand, w, f"{pre}.expand")
    h = _conv_bn(h, blk.depsep, w, f"{pre}.depsep")
    sq_w, sq_b, ex_w, ex_b = w[f"{pre}.se"]
    s = h.mean(dim=(2, 3))  # [B, mid] in the compute dtype
    s = F.linear(F.silu(F.linear(s, sq_w, sq_b)), ex_w, ex_b)
    h = h * torch.sigmoid(s)[:, :, None, None]
    h = _conv_bn(h, blk.proj, w, f"{pre}.proj", act=False)
    return h + x if blk.residual else h


class EfficientNetEncoder(nn.Module):
    """B4-scaled EfficientNet trunk, frozen (its BatchNorms run on their
    running statistics: keep it in eval mode). Input [B, H, W, 3] float
    (preprocessed), output `EncoderOutput` with the head map's tokens
    [B, (H/32)², 1792] and their mean. `blocks` is the B0-style block table
    the B4 scaling applies to. Parameters are made on the CPU from
    `generator` (LeCun normal convs and Linears, unit BatchNorms, as the JAX
    init)."""

    def __init__(self, img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
                 generator: Optional[torch.Generator] = None,
                 blocks: Sequence[Tuple[int, int, int, int, int]] = B0_BLOCKS) -> None:
        super().__init__()
        self.img_size = img_size
        self.dtypes = dtypes
        self.embed_dim = round_channels(1280)
        stem = round_channels(32)
        self.stem = ConvBN(3, stem, 3, 2)
        cin, side = stem, (img_size + 1) // 2
        for li, (expand, ch, reps, stride, kernel) in enumerate(blocks):
            cout = round_channels(ch)
            layer = nn.Module()
            for r in range(round_repeats(reps)):
                layer.add_module(f"block{r}", MBConv(cin, cout, expand, kernel,
                                                     stride if r == 0 else 1))
                cin = cout
            if stride == 2:
                side = (side + 1) // 2
            setattr(self, f"layer{li + 1}", layer)
        self.n_layers = len(blocks)
        self.features = ConvBN(cin, self.embed_dim)
        self.num_patches = side * side
        self._compute_weights = ComputeWeights(type(self)._cast_weights)
        init_conv_layers(self, generator)
        self.eval()

    def layers(self):
        """(name, MBConv) of every block, in order."""
        for li in range(1, self.n_layers + 1):
            for name, blk in getattr(self, f"layer{li}").named_children():
                yield f"layer{li}.{name}", blk

    def compute_weights(self) -> Dict[str, Any]:
        """Conv weights (channels_last) and folded BatchNorms in the compute
        dtype, and the squeeze-excite Linears; cached until a parameter
        changes (`layers.ComputeWeights`)."""
        return self._compute_weights.get(self, self.dtypes)

    def _cast_weights(self, cd: torch.dtype) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, m in self.named_modules():
            if isinstance(m, ConvBN):
                out[name] = (m.conv.weight.to(cd).contiguous(memory_format=torch.channels_last),
                             m.bn.folded(cd))
            elif isinstance(m, SqueezeExcite):
                out[name] = tuple(t.to(cd) for t in (m.squeeze.weight, m.squeeze.bias,
                                                     m.expand.weight, m.expand.bias))
        return out

    def forward(self, x: torch.Tensor, block_index: int = 0) -> EncoderOutput:
        """`block_index` is accepted and ignored, as in the JAX module."""
        w = self.compute_weights()
        xm = x.to(self.dtypes.compute_dtype).permute(0, 3, 1, 2)  # channels_last NCHW view
        xm = _conv_bn(xm, self.stem, w, "stem")
        for name, blk in self.layers():
            xm = _mbconv_apply(xm, blk, w, name)
        xm = _conv_bn(xm, self.features, w, "features")
        tokens = xm.permute(0, 2, 3, 1).reshape(x.shape[0], -1, self.embed_dim)
        return EncoderOutput(patch_embedding=tokens, latent=tokens.mean(dim=1))


def efficientnet_b4(img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
                    generator: Optional[torch.Generator] = None) -> EfficientNetEncoder:
    """EfficientNet-B4 widese: reference EfficientNetEncoder
    (CnnEncoder.py:106-126)."""
    return EfficientNetEncoder(img_size=img_size, dtypes=dtypes, generator=generator)
