"""Vanilla CNN encoder (port of `vit_ad_tpu/models/cnn.py`; reference
EncoderVanillaCNN, src/classes/CnnEncoder.py:16-103).

Five stages of conv3x3 (stride 1) → BatchNorm → ReLU → max-pool 3/2/1,
channels 3 → 48 → 96 → 192 → 384 → 768; a 224-px image becomes a 7x7x768
map. Module layout and state-dict keys are the reference's, which registers
each conv twice: as `conv{i}` and inside the `encoder` Sequential at index
4(i-1), with the BatchNorms only there (4(i-1)+1). Both names hold the same
module objects, so `state_dict()` emits both and strict loads of the JAX
`export_vanilla_encoder` (`utils/torch_convert.py:1425`) layout pass.
Inputs are [B, H, W, 3]; inside, NCHW maps in channels_last memory.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.layers import FusedBatchNorm, init_conv_layers
from vit_ad_tpu_torch.models.outputs import EncoderOutput

CHANNELS = (48, 96, 192, 384, 768)


class VanillaCNNEncoder(nn.Module):
    """The encoder of the vanilla auto-encoder, also a registry trunk
    (`enc_cnn`). Its BatchNorms train with the auto-encoder (train mode) and
    run on the running statistics in eval mode. Parameters are made on the
    CPU from `generator`."""

    def __init__(self, img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.img_size = img_size
        self.dtypes = dtypes
        layers, cin = [], 3
        for ch in CHANNELS:
            layers += [nn.Conv2d(cin, ch, 3, padding=1), FusedBatchNorm(ch), nn.ReLU(),
                       nn.MaxPool2d(3, stride=2, padding=1)]
            cin = ch
        self.encoder = nn.Sequential(*layers)
        for i in range(len(CHANNELS)):
            setattr(self, f"conv{i + 1}", self.encoder[4 * i])
        init_conv_layers(self, generator)

    @property
    def embed_dim(self) -> int:
        return CHANNELS[-1]

    @property
    def num_patches(self) -> int:
        # each max-pool (3, stride 2, pad 1) gives ceil(n/2): 100 px → 4x4, not 3x3
        side = self.img_size
        for _ in CHANNELS:
            side = -(-side // 2)
        return side * side

    def feature_map(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 3] → the stage-5 map [B, 768, s, s] in the compute dtype."""
        cd = self.dtypes.compute_dtype
        h = x.to(cd).permute(0, 3, 1, 2)  # NCHW view of the NHWC bytes: channels_last
        for i in range(len(CHANNELS)):
            conv, bn = self.encoder[4 * i], self.encoder[4 * i + 1]
            h = F.conv2d(h, conv.weight.to(cd), conv.bias.to(cd), padding=1)
            h = F.relu(bn(h).to(cd))
            h = F.max_pool2d(h, 3, stride=2, padding=1)
        return h

    def forward(self, x: torch.Tensor, block_index: int = 0) -> EncoderOutput:
        """Patch tokens [B, s·s, 768] and their mean; `block_index` is
        accepted and ignored, as in the JAX module."""
        tokens = self.feature_map(x).flatten(2).transpose(1, 2)
        return EncoderOutput(patch_embedding=tokens, latent=tokens.mean(dim=1))

