"""Model registry (port of `vit_ad_tpu/registry.py`; the ported keys build the
ViT-family encoders, the EsViT Swin-T and the ResNet-50 encoder, the other
keys raise with the ROADMAP item that brings them)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.outputs import Encoder
from vit_ad_tpu_torch.models.resnet import resnet50_encoder
from vit_ad_tpu_torch.models.swin import esvit_swin_tiny
from vit_ad_tpu_torch.models.vit import deit_base_distilled_patch16, vit_base_patch16

_BUILDERS: Dict[str, Callable[..., Encoder]] = {
    "enc_deit": deit_base_distilled_patch16,
    "enc_vit": vit_base_patch16,
    "enc_esvit": esvit_swin_tiny,
    "enc_res_net": resnet50_encoder,
}

# Keys whose constructor takes `fused_ln` (LayerNorms through the one-pass kernel)
FUSED_LN_MODELS = ("enc_esvit",)
# Keys whose constructor takes `fused_mlp` (the blocks' MLP tail through the
# fused kernel)
FUSED_MLP_MODELS = ("enc_deit", "enc_vit")

# JAX registry keys not ported yet → the ROADMAP item that ports them; every
# ae_* key (the reconstruction autoencoders) is A8
_PENDING = {
    "enc_nest": "A9 (other backbones)",
    "enc_eff_former": "A9 (other backbones)",
    "enc_eff_net": "A9 (other backbones)",
    "enc_cnn": "A9 (other backbones)",
}


def get_model(name: str, img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
              generator: Optional[torch.Generator] = None,
              fused_ln: Optional[bool] = None, fused_mlp: Optional[bool] = None) -> Encoder:
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
    if name in _PENDING or name.startswith("ae_"):
        item = _PENDING.get(name, "A8 (reconstruction)")
        raise NotImplementedError(
            f"model {name!r} is not ported to vit_ad_tpu_torch yet (ROADMAP {item}); "
            f"ported: {sorted(_BUILDERS)}"
        )
    raise KeyError(f"unknown model {name!r}; ported: {sorted(_BUILDERS)}")
