"""Parameter sharding rules (port of `vit_ad_tpu/parallel/sharding.py:30-59`,
restated for the port's parameter names).

The MDN heads (`models/mdn.GaussianMDN`, the reference nn.Linear layout) are
sharded over the "model" axis by mixture component; model rank m holds the
components S = [m·K/M, (m+1)·K/M):

  * `pi.weight` [K, D] and `pi.bias` [K]: the rows S, a contiguous block;
  * `sigma.*` and `mu.*` (`nn.Linear(D, D·K)`, output row e·K + k): the rows
    {e·K + k : k in S}, laid out again as a K/M head's [D·K/M, D] with row
    e·(K/M) + k'. That is the view [D, K, D][:, S, :] of the weight, not a
    contiguous block of it;
  * everything else is replicated.

A shard is a `GaussianMDN` of K/M components whose state dict loads as a K/M
head's. `gather_mdn_state` puts the shards back into the full layout, byte
for byte (checkpoints and exported heads are loaded strictly). As in the JAX
package, a K that the model axis does not divide is refused.

Not applied in the port: the JAX package's trunk rules (attention qkv and
MLP fc1 column-parallel, proj and fc2 row-parallel). On the model axis the
trunk is replicated, which computes the same thing; `param_shardings`
reports those parameters replicated. ROADMAP A11b queues them.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

REPLICATED = "replicated"
MODEL_ROWS = "model: contiguous rows"           # pi
MODEL_STRIDED = "model: rows e*K + k, k in S"   # sigma, mu


def param_shardings(module: torch.nn.Module) -> Dict[str, str]:
    """Parameter name → how the mesh holds it (the rules above)."""
    from vit_ad_tpu_torch.models.mdn import GaussianMDN

    specs = {name: REPLICATED for name, _ in module.named_parameters()}
    for prefix, sub in module.named_modules():
        if isinstance(sub, GaussianMDN):
            lead = f"{prefix}." if prefix else ""
            for head, spec in (("pi", MODEL_ROWS), ("sigma", MODEL_STRIDED),
                               ("mu", MODEL_STRIDED)):
                specs[f"{lead}{head}.weight"] = specs[f"{lead}{head}.bias"] = spec
    return specs


def components(k: int, model_size: int, model_index: int) -> slice:
    """The mixture components model rank `model_index` holds."""
    if k % model_size:
        raise ValueError(f"the MDN head's mixture axis must split evenly over the mesh model "
                         f"axis: its size should be divisible by {model_size}, but it is "
                         f"equal to {k}")
    kl = k // model_size
    return slice(model_index * kl, (model_index + 1) * kl)


def shard_state(state: Dict[str, torch.Tensor], k: int, comps: slice
                ) -> Dict[str, torch.Tensor]:
    """A full head's state dict → the state dict of its shard `comps`."""
    out = {}
    for head in ("pi", "sigma", "mu"):
        w, b = state[f"{head}.weight"], state[f"{head}.bias"]
        if head == "pi":
            out["pi.weight"], out["pi.bias"] = w[comps], b[comps]
            continue
        d = w.shape[1]
        out[f"{head}.weight"] = w.reshape(d, k, d)[:, comps].reshape(-1, d)
        out[f"{head}.bias"] = b.reshape(d, k)[:, comps].reshape(-1)
    return out


def unshard_state(parts: Any, k: int) -> Dict[str, torch.Tensor]:
    """The shards' state dicts, in model order → the full head's."""
    out = {}
    for head in ("pi", "sigma", "mu"):
        ws = [p[f"{head}.weight"] for p in parts]
        bs = [p[f"{head}.bias"] for p in parts]
        if head == "pi":
            out["pi.weight"], out["pi.bias"] = torch.cat(ws), torch.cat(bs)
            continue
        d = ws[0].shape[1]
        out[f"{head}.weight"] = torch.cat([w.reshape(d, -1, d) for w in ws], 1).reshape(d * k, d)
        out[f"{head}.bias"] = torch.cat([b.reshape(d, -1) for b in bs], 1).reshape(d * k)
    return out


def shard_mdn(mdn: torch.nn.Module, ctx: Any) -> torch.nn.Module:
    """The shard of a full `GaussianMDN` that this rank holds on the mesh of
    `ctx` (a `MeshContext`): K/M components, on the head's device. With a
    model axis of one, the head itself, which then draws its noise as a data
    rank (`GaussianMDN.log_pi`)."""
    from vit_ad_tpu_torch.models.mdn import GaussianMDN

    k = mdn.num_gaussians
    comps = components(k, ctx.model_size, ctx.model_index)
    if ctx.model_size == 1:
        mdn.place(ctx, comps, k)
        return mdn
    device = mdn.pi.weight.device
    with torch.device("meta"):
        shard = GaussianMDN(mdn.features, k // ctx.model_size, dtypes=mdn.dtypes)
    shard = shard.to_empty(device=device)
    with torch.no_grad():
        for name, t in shard_state(mdn.state_dict(), k, comps).items():
            shard.get_parameter(name).copy_(t)
    shard.place(ctx, comps, k)
    return shard


def gather_mdn_state(shard: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The full head's state dict on the CPU, from the shards of every model
    rank (a collective over the model axis)."""
    ctx = shard.mesh
    local = {k: v.detach().cpu() for k, v in shard.state_dict().items()}
    if ctx.model_size == 1:
        return local
    gathered = {k: ctx.mesh.all_gather(v, "model") for k, v in local.items()}
    parts = [{k: v[m] for k, v in gathered.items()} for m in range(ctx.model_size)]
    return unshard_state(parts, shard.total_gaussians)
