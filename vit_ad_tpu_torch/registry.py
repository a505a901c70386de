"""Model registry (port of `vit_ad_tpu/registry.py`: all 21 of its keys, the
ViT-family encoders, the EsViT Swin-T, NesT-T, EfficientFormer-L3, the
ResNet-50, EfficientNet-B4 and vanilla CNN encoders and the reconstruction
auto-encoders on them).

`enc_*` keys build a bare (frozen) encoder, `ae_*` keys an auto-encoder whose
decoder is the ResNet-style decoder for the transformer trunks and the small
conv decoder where the key ends in `_small` (reference ModelHelper.py:52-58).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.cnn import VanillaCNNEncoder
from vit_ad_tpu_torch.models.efficientformer import efficientformer_l3
from vit_ad_tpu_torch.models.efficientnet import efficientnet_b4
from vit_ad_tpu_torch.models.nest import nest_tiny
from vit_ad_tpu_torch.models.resnet import resnet50_encoder
from vit_ad_tpu_torch.models.swin import esvit_swin_tiny
from vit_ad_tpu_torch.models.vit import deit_base_distilled_patch16, vit_base_patch16

_BUILDERS: Dict[str, Callable[..., nn.Module]] = {
    "enc_deit": deit_base_distilled_patch16,
    "enc_vit": vit_base_patch16,
    "enc_esvit": esvit_swin_tiny,
    "enc_nest": nest_tiny,
    "enc_eff_former": efficientformer_l3,
    "enc_cnn": VanillaCNNEncoder,
    "enc_res_net": resnet50_encoder,
    "enc_eff_net": efficientnet_b4,
}


def _transformer_ae(trunk_key: str, decoder_kind: str) -> Callable[..., nn.Module]:
    def build(img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
              generator: Optional[torch.Generator] = None, **flags) -> nn.Module:
        from vit_ad_tpu_torch.models.autoencoder import TransformerAutoEncoder

        # the trunk's constructor is looked up when the AE is built, as the JAX
        # registry does: an `enc_*` entry that is replaced serves its AEs too
        trunk = _BUILDERS[trunk_key](img_size=img_size, dtypes=dtypes, generator=generator,
                                     **flags)
        return TransformerAutoEncoder(trunk, decoder_kind, img_size, dtypes, generator)

    return build


def _ae_cnn(img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
            generator: Optional[torch.Generator] = None) -> nn.Module:
    from vit_ad_tpu_torch.models.autoencoder import VanillaAutoEncoder

    return VanillaAutoEncoder(img_size, dtypes, generator)


def _ae_res_net(small_decoder: bool) -> Callable[..., nn.Module]:
    def build(img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
              generator: Optional[torch.Generator] = None) -> nn.Module:
        from vit_ad_tpu_torch.models.autoencoder import ResNetAutoEncoder

        return ResNetAutoEncoder(img_size, small_decoder, dtypes, generator)

    return build


for _k in ("deit", "vit", "esvit", "nest", "eff_former"):
    _BUILDERS[f"ae_{_k}"] = _transformer_ae(f"enc_{_k}", "resnet")
    _BUILDERS[f"ae_{_k}_small"] = _transformer_ae(f"enc_{_k}", "cnn")
_BUILDERS["ae_cnn"] = _ae_cnn
_BUILDERS["ae_res_net"] = _ae_res_net(False)
_BUILDERS["ae_res_net_small"] = _ae_res_net(True)

# Keys whose constructor takes `fused_ln` (LayerNorms through the one-pass kernel)
FUSED_LN_MODELS = ("enc_esvit", "ae_esvit", "ae_esvit_small", "enc_nest", "ae_nest",
                   "ae_nest_small")
# Keys whose constructor takes `fused_mlp` (the blocks' MLP tail through the
# fused kernel)
FUSED_MLP_MODELS = ("enc_deit", "enc_vit", "ae_deit", "ae_deit_small", "ae_vit",
                    "ae_vit_small")


def get_model(name: str, img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
              generator: Optional[torch.Generator] = None,
              fused_ln: Optional[bool] = None, fused_mlp: Optional[bool] = None) -> nn.Module:
    """Build a registry model on the CPU with seeded init (move it with `.to`).
    `fused_ln` and `fused_mlp` (None: the model's default) are for the models
    whose LayerNorms, or whose blocks' MLP tails, can run through the fused
    kernels."""
    if name in _BUILDERS:
        kwargs = {}
        for flag, value, models, what in (
                ("fused_ln", fused_ln, FUSED_LN_MODELS, "fused LayerNorm"),
                ("fused_mlp", fused_mlp, FUSED_MLP_MODELS, "fused MLP")):
            if value is not None:
                if name not in models:
                    raise ValueError(f"{flag}: model {name!r} has no {what} path "
                                     f"(models that have: {sorted(models)})")
                kwargs[flag] = value
        return _BUILDERS[name](img_size=img_size, dtypes=dtypes, generator=generator, **kwargs)
    raise KeyError(f"unknown model {name!r}; known: {get_possible_models()}")


def get_possible_models() -> list:
    """The registry keys, sorted (JAX `get_possible_models`)."""
    return sorted(_BUILDERS)
