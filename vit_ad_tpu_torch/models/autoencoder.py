"""Auto-encoders of the reconstruction head (port of
`vit_ad_tpu/models/autoencoder.py`; reference CnnAutoEncoder.py and
TransformerAutoEncoder.py).

  * VanillaAutoEncoder: the vanilla CNN encoder + the small decoder on its
    map; trains end to end, BatchNorms included.
  * ResNetAutoEncoder: the frozen ResNet-50 encoder + ReverseResNet (or the
    small decoder on the 2048 latent).
  * TransformerAutoEncoder: a frozen transformer trunk + ResNetDecoder (or the
    small decoder) on its latent: the cls token of DeiT and ViT, the mean
    token of Swin, NesT and EfficientFormer; it also returns the patch tokens.

Inputs are preprocessed images [B, H, W, 3]; `AutoEncoderOutput.reconstruction`
is [B, H, W, 3], a view of the decoders' NCHW (channels_last) output. The
frozen encoders stay in eval mode whatever `.train()` is given (the JAX
modules run them with `train=False` while the decoder trains, :71) and run
without gradient. State-dict keys are the reference's .pth layouts, as
`utils/torch_convert.export_vanilla_ae` (:1440), `export_resnet_ae` (:1000)
and `export_transformer_ae` (:1022) emit them: a transformer trunk sits under
its family's name (`encoder.deit.`, `encoder.vit.`, `encoder.esvit.`,
`encoder.nest.`, `encoder.efficientformer.`), the timm trunks with the
classifier heads the reference's files carry (`head`, and `head_dist` for
DeiT and EfficientFormer; zeroed here, never read).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.cnn import VanillaCNNEncoder
from vit_ad_tpu_torch.models.decoders import ResNetDecoder, SmallDecoder
from vit_ad_tpu_torch.models.efficientformer import EfficientFormer
from vit_ad_tpu_torch.models.nest import NesT
from vit_ad_tpu_torch.models.outputs import AutoEncoderOutput, Encoder
from vit_ad_tpu_torch.models.resnet import ResNetEncoder
from vit_ad_tpu_torch.models.reverse_resnet import ReverseResNet
from vit_ad_tpu_torch.models.swin import SwinTransformer
from vit_ad_tpu_torch.models.vit import ViTEncoder

IMAGENET_CLASSES = 1000


def _nhwc(recon: torch.Tensor) -> torch.Tensor:
    return recon.permute(0, 2, 3, 1)


class _FrozenEncoderAE(nn.Module):
    """An AE whose `encoder` is frozen: it keeps eval mode and no gradient."""

    def train(self, mode: bool = True) -> "_FrozenEncoderAE":
        super().train(mode)
        self.encoder.eval()
        return self


class VanillaAutoEncoder(nn.Module):
    """VanillaCNNEncoder + SmallDecoder(z_space=0) on its [768, s, s] map
    (reference VanillaAutoEncoder, CnnAutoEncoder.py:27-83)."""

    def __init__(self, img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.img_size = img_size
        self.encoder = VanillaCNNEncoder(img_size, dtypes, generator)
        self.decoder = SmallDecoder(img_size, z_space=0, dtypes=dtypes, generator=generator)

    def forward(self, x: torch.Tensor, block_index: int = 0) -> AutoEncoderOutput:
        z = self.encoder.feature_map(x)  # [B, 768, s, s]
        return AutoEncoderOutput(latent=z.permute(0, 2, 3, 1).reshape(z.shape[0], -1),
                                 reconstruction=_nhwc(self.decoder(z)))


class ResNetAutoEncoder(_FrozenEncoderAE):
    """The frozen ResNet-50 encoder's 2048 latent → ReverseResNet
    (`small_decoder=False`, reference AutoEncoderResNet :134-154) or
    SmallDecoder(z_space=2048) (AutoEncoderResNetSmallDecoder :111-131)."""

    def __init__(self, img_size: int = 224, small_decoder: bool = False,
                 dtypes: DtypePolicy = DtypePolicy(),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.img_size = img_size
        self.encoder = ResNetEncoder(img_size, dtypes, generator)
        self.decoder = (SmallDecoder(img_size, z_space=2048, dtypes=dtypes, generator=generator)
                        if small_decoder else ReverseResNet(img_size, dtypes, generator))
        self.encoder.requires_grad_(False)

    def latent(self, x: torch.Tensor, block_index: int = 0) -> torch.Tensor:
        return self.encoder(x).latent  # the trunk runs without gradient

    def forward(self, x: torch.Tensor, block_index: int = 0) -> AutoEncoderOutput:
        z = self.latent(x)
        return AutoEncoderOutput(latent=z, reconstruction=_nhwc(self.decoder(z)))


class TransformerAutoEncoder(_FrozenEncoderAE):
    """A frozen transformer trunk (`ViTEncoder`, `SwinTransformer`, `NesT` or
    `EfficientFormer`) + a trainable decoder on its latent: `decoder_kind`
    "resnet" (ResNetDecoder, the default for the `ae_<trunk>` keys) or "cnn"
    (SmallDecoder with z_space = D, the `_small` keys). `block_index` reaches
    the trunk."""

    def __init__(self, trunk: Encoder, decoder_kind: str = "resnet", img_size: int = 224,
                 dtypes: DtypePolicy = DtypePolicy(),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.img_size = img_size
        if isinstance(trunk, SwinTransformer):
            self.family, heads = "esvit", ()
        elif isinstance(trunk, ViTEncoder):
            self.family = "deit" if trunk.num_prefix_tokens == 2 else "vit"
            heads = ("head", "head_dist") if self.family == "deit" else ("head",)
        elif isinstance(trunk, NesT):
            self.family, heads = "nest", ("head",)
        elif isinstance(trunk, EfficientFormer):
            self.family, heads = "efficientformer", ("head", "head_dist")
        else:
            raise TypeError(f"no transformer AE for a {type(trunk).__name__} trunk")
        for name in heads:  # the timm classifier heads: in the files, never read
            head = nn.Linear(trunk.embed_dim, IMAGENET_CLASSES)
            nn.init.zeros_(head.weight)
            nn.init.zeros_(head.bias)
            trunk.add_module(name, head)
        self.encoder = nn.Module()
        self.encoder.add_module(self.family, trunk)
        d = trunk.embed_dim
        if decoder_kind == "resnet":
            self.decoder = ResNetDecoder(d, img_size, dtypes, generator)
        elif decoder_kind == "cnn":
            self.decoder = SmallDecoder(img_size, z_space=d, dtypes=dtypes, generator=generator)
        else:
            raise ValueError(f"unknown decoder_kind {decoder_kind!r}")
        self.encoder.requires_grad_(False)

    @property
    def trunk(self) -> Encoder:
        return getattr(self.encoder, self.family)

    def latent(self, x: torch.Tensor, block_index: int = 0) -> torch.Tensor:
        """The trunk's latent [B, D] in the compute dtype, without gradient."""
        with torch.no_grad():
            return self.trunk(x, block_index=block_index).latent

    def forward(self, x: torch.Tensor, block_index: int = 0) -> AutoEncoderOutput:
        with torch.no_grad():
            out = self.trunk(x, block_index=block_index)
        return AutoEncoderOutput(latent=out.latent,
                                 reconstruction=_nhwc(self.decoder(out.latent)),
                                 patch_embedding=out.patch_embedding)
