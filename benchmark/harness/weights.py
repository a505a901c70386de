"""Seeded weights in the upstream layouts, made on the device in a few large
draws: the trunk's state dict by its family's file (`trunks/<trunk>.py`,
`state`), a FrEIA `SequenceINN` of AllInOneBlocks (`module_list.{i}.*`),
and the MDN's `pi` / `sigma` / `mu` `nn.Linear` heads. No checkpoint ships
with the repo, so the values are random (`assumed` in the configuration
files):
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

from harness import spec

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


def draw(shapes: Shapes, gen: torch.Generator, device, kind: str) -> Dict[str, torch.Tensor]:
    """One draw for all of `shapes`: N(0, 1) ("normal") or U(-1, 1)."""
    total = sum(math.prod(s) for _, s in shapes)
    if kind == "normal":
        flat = torch.randn(total, generator=gen, device=device)
    else:
        flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    return _split(flat, shapes)


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
    sd = draw(uniform, gen, device, "uniform")
    for name, v in sd.items():
        v.mul_(1.0 / math.sqrt(fan[name.rsplit(".", 1)[0] + "."]))
    normal: Shapes = []
    for i in range(cfg["flow_steps"]):
        normal += [(f"module_list.{i}.global_scale", (1, c, 1, 1)),
                   (f"module_list.{i}.global_offset", (1, c, 1, 1))]
    for name, v in draw(normal, gen, device, "normal").items():
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
    sd = draw(shapes, gen, device, "uniform")
    for v in sd.values():
        v.mul_(1.0 / math.sqrt(d))
    return sd


def make_states(cfg: dict, seed: int, device) -> Tuple[Dict[str, torch.Tensor],
                                                      Dict[str, torch.Tensor]]:
    """(trunk state dict, head state dict) of `cfg` from `seed`."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "trunk"))
    trunk = spec.trunk(cfg).state(cfg, gen, device)
    make = {"nf": flow_state, "mdn": mdn_state}[cfg["head"]]
    head = make(cfg, torch.Generator(device=device).manual_seed(sub_seed(seed, "head")), device)
    return trunk, head
