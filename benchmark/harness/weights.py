"""Seeded weights in the upstream layouts, made on the device in a few large
draws: a timm DeiT/ViT state dict, a FrEIA `SequenceINN` of AllInOneBlocks
(`module_list.{i}.*`), and the MDN's `pi` / `sigma` / `mu` `nn.Linear`
heads. No checkpoint ships with the repo, so the values are random
(`assumed` in the configuration files):
  * timm trunk: Linear weights N(0, 0.02²) (timm's init), the patch
    convolution and the classifier heads U(±1/sqrt(fan_in)) (torch's
    default), LayerNorm scales 1 + N(0, 0.1²) and every bias and LayerNorm
    shift N(0, 0.02²), so that no term is an identity; prefix tokens and
    position embedding N(0, 0.02²);
  * flow: each subnet convolution and bias U(±1/sqrt(fan_in)) (torch's
    default), `global_scale` at FrEIA's init for a unit scale plus
    N(0, 0.1²), `global_offset` N(0, 0.02²), a random permutation per step
    as FrEIA's `w_perm` / `w_perm_inv`;
  * MDN: every weight and bias U(±1/sqrt(D)) (torch's `nn.Linear` default).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

Shapes = List[Tuple[str, Tuple[int, ...]]]

# FrEIA AllInOneBlock: global_scale = 2 log(exp(0.5 * 10 * init) - 1) gives
# 0.1 * softplus_{beta=0.5}(global_scale) = init = 1
FREIA_SCALE_INIT = 2.0 * math.log(math.exp(5.0) - 1.0)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def _split(flat: torch.Tensor, shapes: Shapes) -> Dict[str, torch.Tensor]:
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def _draw(shapes: Shapes, gen: torch.Generator, device, kind: str) -> Dict[str, torch.Tensor]:
    """One draw for all of `shapes`: N(0, 1) ("normal") or U(-1, 1)."""
    total = sum(math.prod(s) for _, s in shapes)
    if kind == "normal":
        flat = torch.randn(total, generator=gen, device=device)
    else:
        flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    return _split(flat, shapes)


def deit_state(cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
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
    sd = _draw(normal, gen, device, "normal")
    for k, v in sd.items():
        if k.endswith(".weight") and ".norm" in k or k == "norm.weight":
            v.mul_(0.1).add_(1.0)
        else:
            v.mul_(0.02)
    for k, v in _draw(uniform, gen, device, "uniform").items():
        fan_in = d if k.startswith("head") else 3 * p * p
        sd[k] = v.mul_(1.0 / math.sqrt(fan_in))
    return sd


def flow_state(cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    c = cfg["embed_dim"]
    c1, c2 = c - c // 2, c // 2
    hidden = int(c1 * cfg["hidden_ratio"])
    uniform: Shapes = []
    fan = {}
    for i in range(cfg["flow_steps"]):
        k = 3 if i % 2 == 0 else 1
        pre = f"module_list.{i}.subnet."
        uniform += [(pre + "0.weight", (hidden, c1, k, k)), (pre + "0.bias", (hidden,)),
                    (pre + "2.weight", (2 * c2, hidden, k, k)), (pre + "2.bias", (2 * c2,))]
        fan[pre + "0."] = c1 * k * k
        fan[pre + "2."] = hidden * k * k
    sd = _draw(uniform, gen, device, "uniform")
    for name, v in sd.items():
        v.mul_(1.0 / math.sqrt(fan[name.rsplit(".", 1)[0] + "."]))
    normal: Shapes = []
    for i in range(cfg["flow_steps"]):
        normal += [(f"module_list.{i}.global_scale", (1, c, 1, 1)),
                   (f"module_list.{i}.global_offset", (1, c, 1, 1))]
    for name, v in _draw(normal, gen, device, "normal").items():
        sd[name] = (v.mul_(0.1).add_(FREIA_SCALE_INIT) if name.endswith("scale")
                    else v.mul_(0.02))
    eye = torch.eye(c, device=device)
    for i in range(cfg["flow_steps"]):
        perm = torch.randperm(c, generator=gen, device=device)
        w = eye[perm]  # w[j, perm[j]] = 1: output channel j is input channel perm[j]
        sd[f"module_list.{i}.w_perm"] = w[:, :, None, None].contiguous()
        sd[f"module_list.{i}.w_perm_inv"] = w.t().contiguous()[:, :, None, None]
    return sd


def mdn_state(cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    d, k = cfg["embed_dim"], cfg["num_gaussians"]
    shapes: Shapes = [("pi.weight", (k, d)), ("pi.bias", (k,)), ("sigma.weight", (d * k, d)),
                      ("sigma.bias", (d * k,)), ("mu.weight", (d * k, d)), ("mu.bias", (d * k,))]
    sd = _draw(shapes, gen, device, "uniform")
    for v in sd.values():
        v.mul_(1.0 / math.sqrt(d))
    return sd


def make_states(cfg: dict, seed: int, device) -> Tuple[Dict[str, torch.Tensor],
                                                      Dict[str, torch.Tensor]]:
    """(trunk state dict, head state dict) of `cfg` from `seed`."""
    trunk = deit_state(cfg, torch.Generator(device=device).manual_seed(sub_seed(seed, "trunk")),
                       device)
    make = {"nf": flow_state, "mdn": mdn_state}[cfg["head"]]
    head = make(cfg, torch.Generator(device=device).manual_seed(sub_seed(seed, "head")), device)
    return trunk, head
