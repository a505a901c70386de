"""The reference's first optimizer steps of a head on cached features: the
loss of each step, the gradient of the first step as Adam takes it, and each
parameter's change after the last step, per leaf."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from reference.adam import Adam
from reference.flow import Flow, nf_loss_per_image, tokens_to_map
from reference.mdn import MDN

# state-dict entries that are buffers, not parameters: FrEIA's permutations
BUFFER_SUFFIXES = ("w_perm", "w_perm_inv")
# the faults that `head_steps` can plant, by head: the loss over the first
# half of each batch only; the pi head's update lost (its leaves get no
# gradient, so Adam leaves them as they are); the Gumbel noise left out of
# the pi head's logits
FAULTS = {"mdn": ("half_batch", "pi_unmoved", "gumbel_off"), "nf": ("half_batch",)}


def _mdn_loss_and_grads(head: MDN, q: Dict[str, torch.Tensor], feats: torch.Tensor,
                        count: int, u: Optional[torch.Tensor], rows: int):
    """-sum(ll) / (count * P * D) over the first `count` images, and its
    gradients, `rows` tokens at a time."""
    n, p, d = feats.shape
    x = feats[:count].reshape(-1, d)
    uu = None if u is None else u[:count].reshape(-1, u.shape[-1])
    names = list(q)
    grads = {k: torch.zeros_like(v) for k, v in q.items()}
    total = 0.0
    denom = float(count * p * d)
    for s in range(0, x.shape[0], rows):
        ll = head.log_likelihood(x[s:s + rows], None if uu is None else uu[s:s + rows], q)
        loss = -ll.sum() / denom
        for k, g in zip(names, torch.autograd.grad(loss, [q[k] for k in names])):
            grads[k] += g
        total += float(loss.detach())
    return total, grads


def _nf_loss_and_grads(head: Flow, q: Dict[str, torch.Tensor], feats: torch.Tensor,
                       count: int):
    z, logdet = head.transform(tokens_to_map(feats[:count]), q)
    loss = nf_loss_per_image(z, logdet).mean()
    names = [k for k in q if q[k].requires_grad]
    grads = torch.autograd.grad(loss, [q[k] for k in names])
    return float(loss.detach()), dict(zip(names, grads))


def head_steps(kind: str, cfg: dict, head_sd: Dict[str, torch.Tensor],
               batches: List[torch.Tensor], lr: float, weight_decay: float,
               noise_seed: Optional[int], control: bool = False, fault: Optional[str] = None,
               rows: int = 784) -> dict:
    """Run len(batches) Adam steps of the `kind` ("mdn" or "nf") head from
    `head_sd` on the feature batches [B, P, D]. `noise_seed`: the seed of
    the Gumbel draws (one uniform [B, P, K] per step from a generator on the
    features' device), None for none. `fault`: one of `FAULTS[kind]`,
    planted, or None. Returns the per-step losses,
    the norms of the first step's gradients as Adam took them and as the
    loss gave them, and the norms of each parameter's change, by state-dict
    key."""
    device = batches[0].device
    params = {k: v.detach().float().clone() for k, v in head_sd.items()
              if not k.endswith(BUFFER_SUFFIXES)}
    fixed = {k: v for k, v in head_sd.items() if k.endswith(BUFFER_SUFFIXES)}
    start = {k: v.clone() for k, v in params.items()}
    gen = None if noise_seed is None else torch.Generator(device=device).manual_seed(noise_seed)
    opt = Adam(lr, weight_decay)
    model = MDN(head_sd, cfg, control) if kind == "mdn" else Flow(head_sd, cfg, control)
    losses, first, raw = [], None, None
    for feats in batches:
        if fault is not None and fault not in FAULTS[kind]:
            raise ValueError(f"no fault {fault!r} for the {kind} head")
        count = feats.shape[0] // 2 if fault == "half_batch" else feats.shape[0]
        q = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        if kind == "mdn":
            u = None if gen is None else torch.rand(
                (feats.shape[0], feats.shape[1], model.k), generator=gen, device=device,
                dtype=torch.float32)
            loss, grads = _mdn_loss_and_grads(model, q, feats, count,
                                              None if fault == "gumbel_off" else u, rows)
            if fault == "pi_unmoved":
                grads = {k: g for k, g in grads.items() if not k.startswith("pi.")}
        else:
            loss, grads = _nf_loss_and_grads(model, {**q, **fixed}, feats, count)
        losses.append(loss)
        if raw is None:
            raw = {k: float(g.norm()) for k, g in grads.items()}
        taken = opt.step(params, grads)
        if first is None:  # a leaf that took no step has no gradient in Adam's state
            first = {k: float(taken[k].norm()) if k in taken else 0.0 for k in params}
    change = {k: float((params[k] - start[k]).norm()) for k in params}
    return {"losses": losses, "grad_norms": first, "raw_grad_norms": raw,
            "change_norms": change}
