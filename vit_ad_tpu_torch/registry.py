"""Model registry (port of `vit_ad_tpu/registry.py`; the ported keys build the
ViT-family encoders and the EsViT Swin-T, the other keys raise with the
ROADMAP item that brings them)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.outputs import Encoder
from vit_ad_tpu_torch.models.swin import esvit_swin_tiny
from vit_ad_tpu_torch.models.vit import deit_base_distilled_patch16, vit_base_patch16

_BUILDERS: Dict[str, Callable[..., Encoder]] = {
    "enc_deit": deit_base_distilled_patch16,
    "enc_vit": vit_base_patch16,
    "enc_esvit": esvit_swin_tiny,
}

# Keys whose constructor takes `fused_ln` (LayerNorms through the one-pass kernel)
FUSED_LN_MODELS = ("enc_esvit",)

# JAX registry keys not ported yet → the ROADMAP item that ports them; every
# ae_* key (the reconstruction autoencoders) is A8
_PENDING = {
    "enc_res_net": "A7 (ResNet-50 multi-stage heads)",
    "enc_nest": "A9 (other backbones)",
    "enc_eff_former": "A9 (other backbones)",
    "enc_eff_net": "A9 (other backbones)",
    "enc_cnn": "A9 (other backbones)",
}


def get_model(name: str, img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
              generator: Optional[torch.Generator] = None,
              fused_ln: Optional[bool] = None) -> Encoder:
    """Build a registry model on the CPU with seeded init (move it with `.to`).
    `fused_ln` (None: the model's default) is for the models whose LayerNorms
    can run through the one-pass kernel."""
    if name in _BUILDERS:
        kwargs = {}
        if fused_ln is not None:
            if name not in FUSED_LN_MODELS:
                raise ValueError(f"fused_ln: model {name!r} has no fused LayerNorm path "
                                 f"(models that have: {sorted(FUSED_LN_MODELS)})")
            kwargs["fused_ln"] = fused_ln
        return _BUILDERS[name](img_size=img_size, dtypes=dtypes, generator=generator, **kwargs)
    if name in _PENDING or name.startswith("ae_"):
        item = _PENDING.get(name, "A8 (reconstruction)")
        raise NotImplementedError(
            f"model {name!r} is not ported to vit_ad_tpu_torch yet (ROADMAP {item}); "
            f"ported: {sorted(_BUILDERS)}"
        )
    raise KeyError(f"unknown model {name!r}; ported: {sorted(_BUILDERS)}")
