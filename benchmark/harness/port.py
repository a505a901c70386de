"""The system under test: the port's models, built by its registry, held to
the configuration's widths by the trunk family's check, and filled through
its own loaders (`pipeline/loading`) from state dicts in the upstream
layouts, as a user's checkpoints would be loaded. The modules are
constructed on the device (their own seeded init is overwritten by the
load, so it is not paid on the host)."""

from __future__ import annotations

from typing import Dict

import torch

from harness import spec
from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
from vit_ad_tpu_torch.models.flow import NormalizingFlow
from vit_ad_tpu_torch.models.mdn import GaussianMDN
from vit_ad_tpu_torch.pipeline import loading
from vit_ad_tpu_torch.registry import get_model

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def hyper_params(cfg: dict) -> HyperParams:
    hp = HyperParams(model_name=cfg["model_name"], architecture=cfg["head"],
                     img_size=cfg["img_size"], hidden_ratio=cfg.get("hidden_ratio", 0.16),
                     flow_steps=cfg.get("flow_steps", 20),
                     num_gaussians=cfg.get("num_gaussians", 150),
                     fused_mlp=cfg.get("fused_mlp"))
    hp.dtypes = DtypePolicy(compute_dtype=DTYPES[cfg["trunk_dtype"]])
    if "block_index" in cfg:  # the feature block; HyperParams' default is the last
        hp.block_index = int(cfg["block_index"])
    return hp


def build_encoder(cfg: dict, hp: HyperParams, trunk_sd: Dict[str, torch.Tensor],
                  device: torch.device) -> torch.nn.Module:
    with torch.device(device):
        encoder = get_model(hp.model_name, hp.img_size, hp.dtypes, generator=None,
                            fused_mlp=hp.fused_mlp)
    spec.trunk(cfg).check_widths(encoder, cfg)
    loading.load_encoder_state(encoder, dict(trunk_sd))
    return encoder.eval()


def build_head(cfg: dict, hp: HyperParams, encoder: torch.nn.Module,
               head_sd: Dict[str, torch.Tensor], device: torch.device) -> torch.nn.Module:
    """The NF or MDN head, filled as `loading._load_head` fills it from a
    reference `.pth` (the flow's entries through `_flow_decoder_state`)."""
    with torch.device(device):
        if cfg["head"] == "mdn":
            head = GaussianMDN(encoder.embed_dim, hp.num_gaussians, dtypes=hp.dtypes)
            head.load_state_dict(head_sd, strict=True)
        else:
            head = NormalizingFlow(num_channels=encoder.embed_dim, img_size=hp.img_size,
                                   num_patches=encoder.num_patches,
                                   hidden_ratio=hp.hidden_ratio, flow_steps=hp.flow_steps)
            head.fast_flow_decoder.load_state_dict(loading._flow_decoder_state(head_sd),
                                                   strict=True)
    return head


def leaf_key(name: str) -> str:
    """A head parameter's name → its key in the upstream state dict."""
    return name.removeprefix("fast_flow_decoder.")
