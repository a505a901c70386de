"""The DeiT / ViT trunk family (timm's `VisionTransformer` and
`DistilledVisionTransformer`; the port's `models/vit.ViTEncoder`): its
seeded state dict, the check that the port's model has the configuration's
widths, its plain reference (`reference/deit.py`) and one image's products.

Seeded weights in timm's layout, made on the device in two draws (no
checkpoint ships with the repo, so the values are random; `assumed` in the
configuration files): Linear weights N(0, 0.02²) (timm's init), the patch
convolution and the classifier heads U(±1/sqrt(fan_in)) (torch's default),
LayerNorm scales 1 + N(0, 0.1²) and every bias and LayerNorm shift
N(0, 0.02²), so that no term is an identity; prefix tokens and position
embedding N(0, 0.02²)."""

from __future__ import annotations

import math
from typing import Dict

import torch

from harness.weights import Shapes, draw
from reference.deit import DeiT

# The widths each registry model of the family is published with (the
# configuration's `model_name`): a configuration may cut only what its
# `reduced` lists.
PUBLISHED = {
    "enc_deit": {"embed_dim": 768, "depth": 12, "num_heads": 12, "mlp_ratio": 4.0,
                 "patch_size": 16, "img_size": 224, "num_prefix_tokens": 2},  # DeiT-base/16
}


def state(cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    d, depth, p = cfg["embed_dim"], cfg["depth"], cfg["patch_size"]
    hidden = int(d * cfg["mlp_ratio"])
    tokens = cfg["num_prefix_tokens"] + (cfg["img_size"] // p) ** 2
    normal: Shapes = [("cls_token", (1, 1, d)), ("pos_embed", (1, tokens, d))]
    if cfg["num_prefix_tokens"] == 2:
        normal.append(("dist_token", (1, 1, d)))
    lin = {"attn.qkv": (3 * d, d), "attn.proj": (d, d), "mlp.fc1": (hidden, d),
           "mlp.fc2": (d, hidden)}
    for i in range(depth):
        for name, shape in lin.items():
            normal += [(f"blocks.{i}.{name}.weight", shape), (f"blocks.{i}.{name}.bias",
                                                              (shape[0],))]
        for n in ("norm1", "norm2"):
            normal += [(f"blocks.{i}.{n}.weight", (d,)), (f"blocks.{i}.{n}.bias", (d,))]
    normal += [("norm.weight", (d,)), ("norm.bias", (d,)), ("patch_embed.proj.bias", (d,))]
    uniform: Shapes = [("patch_embed.proj.weight", (d, 3, p, p))]
    heads = ["head"] + (["head_dist"] if cfg["num_prefix_tokens"] == 2 else [])
    for h in heads:
        uniform += [(f"{h}.weight", (cfg["classes"], d)), (f"{h}.bias", (cfg["classes"],))]
    sd = draw(normal, gen, device, "normal")
    for k, v in sd.items():
        if k.endswith(".weight") and ".norm" in k or k == "norm.weight":
            v.mul_(0.1).add_(1.0)
        else:
            v.mul_(0.02)
    for k, v in draw(uniform, gen, device, "uniform").items():
        fan_in = d if k.startswith("head") else 3 * p * p
        sd[k] = v.mul_(1.0 / math.sqrt(fan_in))
    return sd


def check_widths(encoder: torch.nn.Module, cfg: dict) -> None:
    """The registry model must be the configuration's, width for width, and
    its features the last block's, which is what the reference computes."""
    if cfg.get("block_index", 0) != 0:
        raise ValueError(f"{cfg['name']}: the DeiT reference takes the last block's "
                         f"features, not block_index {cfg['block_index']}")
    have = {"embed_dim": encoder.embed_dim, "depth": encoder.depth,
            "num_heads": encoder.num_heads, "patch_size": encoder.patch_size,
            "num_prefix_tokens": encoder.num_prefix_tokens, "img_size": encoder.img_size,
            "mlp_hidden": encoder.blocks[0].mlp.fc1.out_features}
    want = {k: cfg[k] for k in have if k in cfg}
    want["mlp_hidden"] = int(cfg["embed_dim"] * cfg["mlp_ratio"])
    bad = {k: (have[k], want[k]) for k in want if have[k] != want[k]}
    if bad:
        raise ValueError(f"the port's {cfg['model_name']} differs from the configuration "
                         f"(have, want): {bad}")


def reference(sd: Dict[str, torch.Tensor], cfg: dict, control: bool = False) -> DeiT:
    return DeiT(sd, cfg, control)


def forward_work(cfg: dict):
    """One image through the trunk: patch convolution, and per block qkv,
    q·kᵀ, p·v, proj, fc1, fc2."""
    d, p, img = cfg["embed_dim"], cfg["patch_size"], cfg["img_size"]
    patches = (img // p) ** 2
    t = patches + cfg["num_prefix_tokens"]
    hidden = int(d * cfg["mlp_ratio"])
    block = 2 * t * d * (3 * d) + 2 * 2 * t * t * d + 2 * t * d * d + 2 * 2 * t * d * hidden
    prec = cfg["trunk_dtype"]
    return [(2.0 * patches * d * 3 * p * p, prec), (float(cfg["depth"] * block), prec)]
