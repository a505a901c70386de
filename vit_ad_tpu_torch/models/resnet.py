"""ResNet-50 encoder with FastFlow-style trainable per-stage LayerNorms (port
of `vit_ad_tpu/models/resnet.py`: `Bottleneck` :40, `ResNet50` :80,
`_stage_layer_norm` :113, `ResNetEncoder` :125).

Standard bottleneck-v1.5 ResNet-50 (stage channels 256/512/1024/2048 at scales
4/8/16/32), frozen; a trainable LayerNorm over each whole stage map with a
per-element affine. Module layout and state-dict keys are the reference
ResNetEncoder's: the torchvision trunk under `res_net.` (`fc` included, never
read) and `norms.{i}` = `nn.LayerNorm([C, H/s, W/s])`, the layout
`vit_ad_tpu/utils/torch_convert.export_resnet_encoder` (:977) emits, so its
output loads with strict=True.

Inputs are [B, H, W, 3] like the other encoders and the stage maps come back
as [B, h, w, C]; inside, the maps are NCHW tensors in channels_last memory
(the NHWC bytes), which is what cuDNN's tensor-core convolutions take without
a transpose. Convolutions run in the policy's compute dtype on cached casts of
the frozen weights, the BatchNorms are `layers.FusedBatchNorm`, the stage
LayerNorm statistics are f32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.layers import ComputeWeights, FusedBatchNorm, conv_bn, lecun_normal_
from vit_ad_tpu_torch.models.outputs import EncoderOutput

STAGE_CHANNELS = (256, 512, 1024, 2048)
STAGE_SCALES = (4, 8, 16, 32)
LAYERS = (3, 4, 6, 3)
STAGE_LN_EPS = 1e-5


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    # explicit symmetric padding, as torch and the JAX model pad
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)


class Bottleneck(nn.Module):
    """torchvision bottleneck v1.5: 1x1 → 3x3 (stride) → 1x1 (4x), residual."""

    def __init__(self, cin: int, planes: int, stride: int, downsample: bool) -> None:
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, planes, 1), FusedBatchNorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, stride), FusedBatchNorm(planes)
        self.conv3, self.bn3 = _conv(planes, planes * 4, 1), FusedBatchNorm(planes * 4)
        self.downsample = (nn.Sequential(_conv(cin, planes * 4, 1, stride),
                                         FusedBatchNorm(planes * 4)) if downsample else None)


def _conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn: FusedBatchNorm, w: Dict[str, object],
             name_conv: str, name_bn: str) -> torch.Tensor:
    return conv_bn(x, conv, bn, w[name_conv], None, w[name_bn])


def _bottleneck_apply(x: torch.Tensor, blk: Bottleneck, w: Dict[str, object],
                      pre: str) -> torch.Tensor:
    out = F.relu(_conv_bn(x, blk.conv1, blk.bn1, w, f"{pre}.conv1", f"{pre}.bn1"))
    out = F.relu(_conv_bn(out, blk.conv2, blk.bn2, w, f"{pre}.conv2", f"{pre}.bn2"))
    out = _conv_bn(out, blk.conv3, blk.bn3, w, f"{pre}.conv3", f"{pre}.bn3")
    if blk.downsample is not None:
        x = _conv_bn(x, blk.downsample[0], blk.downsample[1], w, f"{pre}.downsample.0",
                     f"{pre}.downsample.1")
    return F.relu(out + x)


class ResNet50(nn.Module):
    """The trunk, torchvision's modules and keys; `forward` returns the four
    stage maps (NCHW, channels_last memory) in the compute dtype."""

    def __init__(self, dtypes: DtypePolicy = DtypePolicy()) -> None:
        super().__init__()
        self.dtypes = dtypes
        self.conv1, self.bn1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False), \
            FusedBatchNorm(64)
        cin = 64
        for li, (blocks, planes) in enumerate(zip(LAYERS, (64, 128, 256, 512))):
            layer = []
            for bi in range(blocks):
                layer.append(Bottleneck(cin, planes, 2 if (bi == 0 and li > 0) else 1, bi == 0))
                cin = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
        self.fc = nn.Linear(2048, 1000)  # the classifier: kept for the keys, never read
        self._compute_weights = ComputeWeights(type(self)._cast_weights)

    def _cast_weights(self, cd: torch.dtype) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for name, m in self.named_modules():
            if isinstance(m, nn.Conv2d):
                out[name] = m.weight.to(cd).contiguous(memory_format=torch.channels_last)
            elif isinstance(m, FusedBatchNorm):
                out[name] = m.folded(cd)
        return out

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [B, H, W, 3] → the four stage maps [B, C_i, H/s_i, W/s_i]."""
        cd = self.dtypes.compute_dtype
        w = self._compute_weights.get(self, self.dtypes)
        x = x.to(cd).permute(0, 3, 1, 2)  # NCHW view of the NHWC bytes: channels_last
        x = F.relu(_conv_bn(x, self.conv1, self.bn1, w, "conv1", "bn1"))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        stages = []
        for li in range(1, 5):
            for bi, blk in enumerate(getattr(self, f"layer{li}")):
                x = _bottleneck_apply(x, blk, w, f"layer{li}.{bi}")
            stages.append(x)
        return stages


def stage_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = STAGE_LN_EPS,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LayerNorm over the whole [C, H, W] map of each image with a per-element
    affine (torch `LayerNorm([C, H, W])`; JAX `_stage_layer_norm` :113): f32
    mean and biased variance, rsqrt(var + eps), weight, bias, cast."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(1, 2, 3), unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(out_dtype)


class ResNetEncoder(nn.Module):
    """Frozen ResNet-50 trunk + trainable stage norms (reference ResNetEncoder).

    `forward` returns the stage-4 map flattened to [B, P, 2048] and its global
    average as the latent; `stage_features` returns the LayerNorm'd stage maps
    [B, h, w, C] in the compute dtype. Only the stage norms have
    `requires_grad`; the trunk runs under `no_grad` and must stay in eval
    mode. Parameters are made on the CPU from `generator` (LeCun-normal
    convolutions, unit BatchNorms and norms, as the JAX init)."""

    def __init__(self, img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.img_size = img_size
        self.dtypes = dtypes
        self.res_net = ResNet50(dtypes)
        self.norms = nn.ModuleList(
            nn.LayerNorm([c, img_size // s, img_size // s], eps=STAGE_LN_EPS)
            for c, s in zip(STAGE_CHANNELS, STAGE_SCALES))
        self.reset_parameters(generator)
        self.res_net.requires_grad_(False)
        self.eval()

    @property
    def embed_dim(self) -> int:
        return STAGE_CHANNELS[-1]

    @property
    def num_patches(self) -> int:
        return (self.img_size // STAGE_SCALES[-1]) ** 2

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.res_net.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight.data, m.weight[0].numel(), generator)
            elif isinstance(m, FusedBatchNorm):
                m.reset_parameters()
        nn.init.zeros_(self.res_net.fc.weight)
        nn.init.zeros_(self.res_net.fc.bias)
        for norm in self.norms:
            norm.reset_parameters()

    def forward(self, x: torch.Tensor, block_index: int = 0) -> EncoderOutput:
        with torch.no_grad():
            final = self.res_net(x)[-1]
        return EncoderOutput(patch_embedding=final.flatten(2).transpose(1, 2),
                             latent=final.mean(dim=(2, 3)))

    def stage_features(self, x: torch.Tensor,
                       stages: Sequence[int] = (0, 1, 2, 3)) -> List[torch.Tensor]:
        """The LayerNorm'd maps [B, h, w, C] of the requested stages, in the
        order asked (the JAX method returns all four; the heads read two, and
        an eager port computes only those)."""
        with torch.no_grad():
            maps = self.res_net(x)
        cd = self.dtypes.compute_dtype
        return [stage_layer_norm(maps[i], self.norms[i].weight, self.norms[i].bias,
                                 out_dtype=cd).permute(0, 2, 3, 1) for i in stages]


def resnet50_encoder(img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
                     generator: Optional[torch.Generator] = None) -> ResNetEncoder:
    """ResNet-50 + stage norms: reference ResNetEncoder (CnnEncoder.py:129)."""
    return ResNetEncoder(img_size=img_size, dtypes=dtypes, generator=generator)
