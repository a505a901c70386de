"""Model registry (port of `vit_ad_tpu/registry.py`; this slice carries the
two ViT-family encoders, the other keys raise with the ROADMAP item that
brings them)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.vit import (
    ViTEncoder,
    deit_base_distilled_patch16,
    vit_base_patch16,
)

_BUILDERS: Dict[str, Callable[..., ViTEncoder]] = {
    "enc_deit": deit_base_distilled_patch16,
    "enc_vit": vit_base_patch16,
}

# JAX registry keys not ported yet → the ROADMAP item that ports them; every
# ae_* key (the reconstruction autoencoders) is A8
_PENDING = {
    "enc_esvit": "A6 (EsViT Swin-T)",
    "enc_res_net": "A7 (ResNet-50 multi-stage heads)",
    "enc_nest": "A9 (other backbones)",
    "enc_eff_former": "A9 (other backbones)",
    "enc_eff_net": "A9 (other backbones)",
    "enc_cnn": "A9 (other backbones)",
}


def get_model(name: str, img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
              generator: Optional[torch.Generator] = None) -> ViTEncoder:
    """Build a registry model on the CPU with seeded init (move it with `.to`)."""
    if name in _BUILDERS:
        return _BUILDERS[name](img_size=img_size, dtypes=dtypes, generator=generator)
    if name in _PENDING or name.startswith("ae_"):
        item = _PENDING.get(name, "A8 (reconstruction)")
        raise NotImplementedError(
            f"model {name!r} is not ported to vit_ad_tpu_torch yet (ROADMAP {item}); "
            f"ported: {sorted(_BUILDERS)}"
        )
    raise KeyError(f"unknown model {name!r}; ported: {sorted(_BUILDERS)}")
