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

The transformer trunks are sharded Megatron-style (`shard_trunk`): in every
block of the DeiT/ViT (`blocks.i`), Swin (`layers.i.blocks.j`), NesT
(`levels.i.transformer_encoder.j`) and EfficientFormer Meta3D
(`stages.3.blocks.j`) trunks,

  * `mlp.fc1.weight` [H, D]: the contiguous hidden rows [m·H/M, (m+1)·H/M)
    (column-parallel), and `mlp.fc1.bias` with them in DeiT/ViT and Swin;
  * `mlp.fc2.weight` [D, H]: the matching input columns (row-parallel: each
    rank's product is a partial sum, summed over "model" before the bias);
  * in DeiT/ViT and Swin, `attn.qkv.weight` [3C, C] and its bias
    head-parallel: the rows {s·C + h·hd + j : s in q, k, v; h in the rank's
    H/M heads}, laid out again as an H/M-head qkv ([3][H/M][hd]), and
    `attn.proj.weight` [C, C] the matching input columns, a contiguous block;
  * everything else replicated: the norms, `attn.proj.bias`, `mlp.fc2.bias`,
    Swin's bias tables (a rank gathers its heads' columns), NesT's and
    EfficientFormer's attention and `mlp.fc1.bias` (the JAX rules match only
    their Dense kernels; a rank slices its hidden block of the bias).

Three departures from the JAX map, on purpose:

  (a) an attention whose head count the model axis does not divide stays
      whole on every rank, `qkv` and `proj` (EsViT stage 0 at M = 2, stages
      0-1 at M = 4). JAX shards the weight across head boundaries and GSPMD
      reshards; the result is the same;
  (b) EfficientFormer's Meta4D 1x1-conv MLPs stay replicated: their folded
      BatchNorms are per channel, and the JAX rule puts "model" on a size-1
      axis of the 4-D kernel, which `jax.device_put` refuses;
  (c) the `qkv` rows are split per head, not as JAX's contiguous block of
      the 3C columns, so attention runs on the rank's heads with no gather.

A hidden width that the model axis does not divide is refused, in the JAX
package's words. `unshard_trunk_state` puts the shards back byte for byte.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

REPLICATED = "replicated"
MODEL_ROWS = "model: contiguous rows"           # pi; mlp.fc1
MODEL_STRIDED = "model: rows e*K + k, k in S"   # sigma, mu
MODEL_COLUMNS = "model: contiguous columns"     # attn.proj, mlp.fc2 (row-parallel)
MODEL_HEADS = "model: rows s*C + h*hd + j, h in the rank's heads"  # attn.qkv


def param_shardings(module: torch.nn.Module, model_size: int) -> Dict[str, str]:
    """Parameter name → how a mesh with `model_size` model ranks holds it
    (the rules above)."""
    from vit_ad_tpu_torch.models.mdn import GaussianMDN

    specs = {name: REPLICATED for name, _ in module.named_parameters()}
    for prefix, sub in module.named_modules():
        lead = f"{prefix}." if prefix else ""
        if isinstance(sub, GaussianMDN):
            for head, spec in (("pi", MODEL_ROWS), ("sigma", MODEL_STRIDED),
                               ("mu", MODEL_STRIDED)):
                specs[f"{lead}{head}.weight"] = specs[f"{lead}{head}.bias"] = spec
        elif is_trunk(sub):
            shard = getattr(sub, "model_shard", None)
            rules = shard.rules if shard is not None else trunk_rules(sub, model_size)
            specs.update({lead + k: v for k, v in rules.items()})
    return specs


def _trunk_blocks(trunk: torch.nn.Module) -> Iterator[Tuple[str, torch.nn.Module, Optional[int],
                                                            bool]]:
    """(state-dict prefix, block, its head count when the rules split its
    attention else None, whether the rules split `mlp.fc1.bias`) of every
    block of a trunk the rules shard."""
    from vit_ad_tpu_torch.models.efficientformer import EfficientFormer, Meta3D
    from vit_ad_tpu_torch.models.nest import NesT
    from vit_ad_tpu_torch.models.swin import SwinTransformer
    from vit_ad_tpu_torch.models.vit import ViTEncoder

    if isinstance(trunk, ViTEncoder):
        for i, blk in enumerate(trunk.blocks):
            yield f"blocks.{i}", blk, trunk.num_heads, True
    elif isinstance(trunk, SwinTransformer):
        for i, stage in enumerate(trunk.layers):
            for j, blk in enumerate(stage.blocks):
                yield f"layers.{i}.blocks.{j}", blk, blk.num_heads, True
    elif isinstance(trunk, NesT):
        for i, level in enumerate(trunk.levels):
            for j, blk in enumerate(level.transformer_encoder):
                yield f"levels.{i}.transformer_encoder.{j}", blk, None, False
    elif isinstance(trunk, EfficientFormer):
        for i, stage in enumerate(trunk.stages):
            for j, blk in enumerate(stage.blocks):
                if isinstance(blk, Meta3D):
                    yield f"stages.{i}.blocks.{j}", blk, None, False


def is_trunk(module: torch.nn.Module) -> bool:
    """Whether the trunk rules shard `module` (a DeiT/ViT, Swin, NesT or
    EfficientFormer trunk)."""
    return next(_trunk_blocks(module), None) is not None


def trunk_rules(trunk: torch.nn.Module, model_size: int) -> Dict[str, str]:
    """State-dict key (within the trunk) → spec, for the keys the model axis
    splits; raises on a hidden width it does not divide."""
    rules: Dict[str, str] = {}
    for prefix, blk, heads, fc1_bias in _trunk_blocks(trunk):
        hidden = blk.mlp.fc1.out_features
        if hidden % model_size:
            raise ValueError(f"the MLP hidden axis of {prefix} must split evenly over the mesh "
                             f"model axis: its size should be divisible by {model_size}, but it "
                             f"is equal to {hidden}")
        if heads is not None and heads % model_size == 0:  # else (a): whole
            for key, spec in (("qkv.weight", MODEL_HEADS), ("qkv.bias", MODEL_HEADS),
                              ("proj.weight", MODEL_COLUMNS)):
                rules[f"{prefix}.attn.{key}"] = spec
        rules[f"{prefix}.mlp.fc1.weight"] = MODEL_ROWS
        if fc1_bias:
            rules[f"{prefix}.mlp.fc1.bias"] = MODEL_ROWS
        rules[f"{prefix}.mlp.fc2.weight"] = MODEL_COLUMNS
    return rules


def shard_trunk_state(state: Dict[str, torch.Tensor], rules: Dict[str, str], model_size: int,
                      model_index: int) -> Dict[str, torch.Tensor]:
    """A full trunk's tensors of the `rules` keys → model rank
    `model_index`'s shards of them (contiguous copies)."""
    m, out = model_index, {}
    for key, spec in rules.items():
        t = state[key]
        if spec == MODEL_ROWS:
            part = t.reshape(model_size, -1, *t.shape[1:])[m]
        elif spec == MODEL_COLUMNS:
            part = t.reshape(t.shape[0], model_size, -1)[:, m]
        else:  # MODEL_HEADS: [3][H][hd] rows, the rank's heads of each of q, k, v
            part = t.reshape(3, model_size, -1, *t.shape[1:])[:, m].reshape(-1, *t.shape[1:])
        out[key] = part.contiguous().clone()
    return out


def unshard_trunk_state(parts: Sequence[Dict[str, torch.Tensor]], rules: Dict[str, str]
                        ) -> Dict[str, torch.Tensor]:
    """The shards of the `rules` keys, in model order → the full tensors."""
    out = {}
    for key, spec in rules.items():
        ts = [p[key] for p in parts]
        if spec == MODEL_ROWS:
            out[key] = torch.cat(ts)
        elif spec == MODEL_COLUMNS:
            out[key] = torch.cat(ts, 1)
        else:
            rest = ts[0].shape[1:]
            out[key] = torch.stack([t.reshape(3, -1, *rest) for t in ts], 1).reshape(-1, *rest)
    return out


@dataclasses.dataclass(eq=False)
class TrunkShard:
    """What a sharded trunk holds as `model_shard`: its mesh and rules."""

    mc: Any                  # parallel.context.MeshContext
    rules: Dict[str, str]


def shard_trunk(trunk: torch.nn.Module, ctx: Any) -> torch.nn.Module:
    """Make `trunk` this rank's shard on the mesh of `ctx` (a `MeshContext`
    with a model axis above one), in place: each parameter the rules split is
    replaced by this rank's part (`nn.Linear` widths follow), each block
    learns its part (`models/tensor_parallel.BlockShard`), and the trunk is
    frozen: a shard's forward is collective over "model" and has no
    backward."""
    from vit_ad_tpu_torch.models.tensor_parallel import BlockShard

    m, size = ctx.model_index, ctx.model_size
    rules = trunk_rules(trunk, size)
    parts = shard_trunk_state(trunk.state_dict(), rules, size, m)
    with torch.no_grad():
        for key, t in parts.items():
            owner, leaf = key.rsplit(".", 1)
            lin = trunk.get_submodule(owner)
            setattr(lin, leaf, torch.nn.Parameter(t, requires_grad=False))
            lin.out_features, lin.in_features = lin.weight.shape
    for p in trunk.parameters():
        p.requires_grad_(False)
    for prefix, blk, heads, _ in _trunk_blocks(trunk):
        split = f"{prefix}.attn.qkv.weight" in rules
        h = blk.mlp.fc2.in_features
        blk.model_shard = BlockShard(ctx, slice(m * (heads // size), (m + 1) * (heads // size))
                                     if split else None, slice(m * h, (m + 1) * h))
    trunk.model_shard = TrunkShard(ctx, rules)
    return trunk


def gather_trunk_state(trunk: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The full trunk's state dict on the CPU, from the shards of every model
    rank (a collective over the model axis)."""
    shard = trunk.model_shard
    local = {k: v.detach().to("cpu", copy=True) for k, v in trunk.state_dict().items()}
    gathered = {k: shard.mc.model_gather(local[k]) for k in shard.rules}
    parts = [{k: v[m] for k, v in gathered.items()} for m in range(shard.mc.model_size)]
    local.update(unshard_trunk_state(parts, shard.rules))
    return local


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
