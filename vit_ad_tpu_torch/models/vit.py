"""ViT / DeiT encoders (port of `vit_ad_tpu/models/vit.py`).

Module layout and state-dict keys are timm's (`patch_embed.proj`, `cls_token`,
`dist_token`, `pos_embed`, `blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,
mlp.fc1,mlp.fc2}`, `norm`), the layout `utils/torch_convert.export_vit` emits,
so exported JAX weights and upstream timm checkpoints load with strict=True.

Cast points follow `_block_apply` (:70-149): the residual stream is in the
compute dtype, LayerNorm statistics run in f32 (eps 1e-6), the matmul weights
run in the compute dtype and attention is the packed-qkv kernel
(`ops/cuda/window_attention.vit_attention_qkv`). The blocks' first norm and
the final norm are the one-pass LayerNorm kernel (`ops/cuda/layer_norm`: f32
statistics on the compute-dtype rows, rounded once to the compute dtype, the
function of `F.layer_norm` on the f32 cast and back in one pass; on the H100
it is faster, PERF.md). With `fused_mlp` (the default)
the MLP tail of a block is the kernel `ops/cuda/mlp.mlp_block` (JAX :117-128,
there behind `VITAD_PALLAS_MLP=1`), taken only under tanh GELU and where
`use_fused_mlp` admits the widths. The compute-dtype copies of the weights are
made once and reused while the parameters are unchanged (JAX casts them once
per call outside its block scan, :255-258).

On a mesh whose model axis is above one the blocks run as shards
(`parallel/sharding.shard_trunk`, `models/tensor_parallel.py`): B7 norm1,
the rank's `qkv` heads, the attention kernel at H/M heads, `proj` as an f32
partial summed over "model", B7 norm2, `fc1`'s hidden block through the MLP
kernel's GELU step and `fc2` through its f32-partial step, summed likewise
(the whole MLP kernel cannot take a split hidden axis).

`VITAD_VIT_LN_FOLD=1`, read at call time and off by default (JAX :60-85,
:129-136): norm1 folds into the qkv GEMM and norm2 into fc1
(`layers.ln_fold_gemm`, eps 1e-6), so those norms skip B7. The MLP kernel
takes precedence, as in JAX: norm2 folds only where B6 is not taken. A
shard folds both. The folded weights are cached with the compute-dtype
copies.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.layers import (
    ComputeWeights,
    PatchEmbed,
    block_ln_folds,
    lecun_normal_,
    ln_fold_gemm,
    resolve_gelu_approx,
    trunc_normal_,
)
from vit_ad_tpu_torch.models.outputs import EncoderOutput
from vit_ad_tpu_torch.models.tensor_parallel import (
    attention_residual,
    check_no_grad,
    hidden_residual,
    mlp_residual,
)
from vit_ad_tpu_torch.ops.cuda.layer_norm import layer_norm
from vit_ad_tpu_torch.ops.cuda.mlp import mlp_block, use_fused_mlp
from vit_ad_tpu_torch.ops.cuda.window_attention import vit_attention_qkv
from vit_ad_tpu_torch.utils.profiling import span

LN_EPS = 1e-6
# The MLP tail through the MLP kernel (`ops/cuda/mlp.mlp_block`): on. On the
# H100 it is faster than the stock tail and faster end to end (PERF.md has the
# off/on/on/off reading); the JAX package keeps it opt-in. `fused_mlp=False` /
# `--no-fused-mlp` takes the stock tail.
FUSED_MLP_DEFAULT = True


def vit_ln_fold() -> bool:
    return os.environ.get("VITAD_VIT_LN_FOLD") == "1"


class Attention(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    """Parameter holder of one pre-LN block; `_block_apply` runs it."""

    def __init__(self, dim: int, mlp_ratio: float) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))


def _block_apply(x: torch.Tensor, blk: Block, w: Dict[str, torch.Tensor], num_heads: int,
                 cd: torch.dtype, gelu_approx: bool, fused_mlp: bool = False) -> torch.Tensor:
    """One pre-LN transformer block (JAX `_block_apply` :70). `w` holds the
    block's matmul weights in the compute dtype (and, under
    `VITAD_VIT_LN_FOLD=1`, its folded norms). `fused_mlp` sends the MLP tail
    through `mlp_block` when the GELU is the tanh one and the kernel takes
    the widths."""
    with span("block"):
        shard = getattr(blk, "model_shard", None)
        if shard is not None:
            return _shard_block_apply(x, blk, w, shard.num_heads(num_heads), cd, gelu_approx)
        d = x.shape[-1]
        fold = vit_ln_fold()
        if fold:
            qkv = ln_fold_gemm(x, w["fold1"], LN_EPS, cd)
        else:
            y = layer_norm(x, blk.norm1.weight, blk.norm1.bias, LN_EPS)  # x is in cd
            qkv = F.linear(y, w["qkv_w"], w["qkv_b"])  # [B, N, 3D] packed
        out = vit_attention_qkv(qkv, num_heads).to(cd)
        x = x + F.linear(out, w["proj_w"], w["proj_b"])
        if fused_mlp and gelu_approx and use_fused_mlp(d, w["fc1_w"].shape[0]):
            # f32 norm affine and biases, compute-dtype weights, as the JAX call
            return mlp_block(x, blk.norm2.weight, blk.norm2.bias, w["fc1_w"], blk.mlp.fc1.bias,
                             w["fc2_w"], blk.mlp.fc2.bias, LN_EPS)
        approx = "tanh" if gelu_approx else "none"
        if fold:
            h = F.gelu(ln_fold_gemm(x, w["fold2"], LN_EPS, cd), approximate=approx)
        else:
            y = F.layer_norm(x.float(), (d,), blk.norm2.weight, blk.norm2.bias, LN_EPS).to(cd)
            h = F.gelu(F.linear(y, w["fc1_w"], w["fc1_b"]), approximate=approx)
        return x + F.linear(h, w["fc2_w"], w["fc2_b"])


def _shard_block_apply(x: torch.Tensor, blk: Block, w: Dict[str, torch.Tensor], heads: int,
                       cd: torch.dtype, gelu_approx: bool) -> torch.Tensor:
    """One block on a model-axis shard: `w` holds the rank's parts of the
    matmul weights, `heads` its heads."""
    check_no_grad(x, blk)
    fold = vit_ln_fold()
    if fold:
        qkv = ln_fold_gemm(x, w["fold1"], LN_EPS, cd)
    else:
        qkv = F.linear(layer_norm(x, blk.norm1.weight, blk.norm1.bias, LN_EPS), w["qkv_w"],
                       w["qkv_b"])
    out = vit_attention_qkv(qkv, heads).to(cd)
    x = attention_residual(x, out, w, blk.attn.proj.bias, blk.model_shard)
    if fold:
        h = F.gelu(ln_fold_gemm(x, w["fold2"], LN_EPS, cd),
                   approximate="tanh" if gelu_approx else "none")
        return hidden_residual(x, h, w, blk.mlp, blk.model_shard)
    y = layer_norm(x, blk.norm2.weight, blk.norm2.bias, LN_EPS)
    return mlp_residual(x, y, w, blk.mlp, blk.model_shard, gelu_approx)


class ViTEncoder(nn.Module):
    """Pre-LN vision transformer (ViT/DeiT family). Input [B, H, W, 3] float
    (preprocessed), output `EncoderOutput` with patch tokens [B, P, D] and
    the cls token [B, D]. Parameters are made on the CPU from `generator`
    (JAX's initializers, other random numbers); move the module with `.to`."""

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 16,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        num_prefix_tokens: int = 1,
        dtypes: DtypePolicy = DtypePolicy(),
        gelu_tanh: Optional[bool] = None,
        generator: Optional[torch.Generator] = None,
        fused_mlp: Optional[bool] = None,
    ) -> None:
        super().__init__()
        if num_prefix_tokens not in (1, 2):
            raise ValueError(f"num_prefix_tokens must be 1 (cls) or 2 (cls + dist), "
                             f"got {num_prefix_tokens}")
        self.img_size = img_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.num_prefix_tokens = num_prefix_tokens
        self.dtypes = dtypes
        self.gelu_tanh = gelu_tanh
        self.fused_mlp = FUSED_MLP_DEFAULT if fused_mlp is None else bool(fused_mlp)
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        if num_prefix_tokens == 2:
            self.dist_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, num_prefix_tokens + self.num_patches, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, mlp_ratio) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self._compute_weights = ComputeWeights(type(self)._cast_weights, variant=vit_ln_fold)
        self.reset_parameters(generator)

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """JAX's initializers: truncated normal 0.02 for the prefix tokens and
        pos_embed, Glorot uniform for the block Linears, LeCun (truncated)
        normal for the patch conv, zero biases, unit LayerNorms."""
        conv = self.patch_embed.proj
        lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
        nn.init.zeros_(conv.bias)
        for t in self._prefix_params() + [self.pos_embed]:
            trunc_normal_(t, 0.02, generator)
        for blk in self.blocks:
            for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
                nn.init.xavier_uniform_(lin.weight, generator=generator)
                nn.init.zeros_(lin.bias)
        for norm in [self.norm] + [n for b in self.blocks for n in (b.norm1, b.norm2)]:
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)

    def _prefix_params(self) -> List[nn.Parameter]:
        return [self.cls_token] + ([self.dist_token] if self.num_prefix_tokens == 2 else [])

    def _matmul_params(self) -> Dict[str, object]:
        blocks = [
            {"qkv_w": b.attn.qkv.weight, "qkv_b": b.attn.qkv.bias,
             "proj_w": b.attn.proj.weight, "proj_b": b.attn.proj.bias,
             "fc1_w": b.mlp.fc1.weight, "fc1_b": b.mlp.fc1.bias,
             "fc2_w": b.mlp.fc2.weight, "fc2_b": b.mlp.fc2.bias}
            for b in self.blocks
        ]
        return {"patch_w": self.patch_embed.proj.weight, "patch_b": self.patch_embed.proj.bias,
                "prefix": torch.cat(self._prefix_params(), dim=1), "pos": self.pos_embed,
                "blocks": blocks}

    def compute_weights(self) -> Dict[str, object]:
        """The matmul weights, prefix tokens and pos_embed in the compute
        dtype (under `VITAD_VIT_LN_FOLD=1` also the blocks' folded norms).
        Under a bf16 policy the casts are cached and made again only when a
        parameter changed (storage or in-place version) or the lever did;
        while gradients flow to the parameters they are cast per call."""
        return self._compute_weights.get(self, self.dtypes)

    def _cast_weights(self, cd: torch.dtype) -> Dict[str, object]:
        w = self._matmul_params()
        blocks = [{n: t.to(cd) for n, t in b.items()} for b in w.pop("blocks")]
        if vit_ln_fold():
            for blk, bw in zip(self.blocks, blocks):
                bw.update(block_ln_folds(blk, bw, cd))
        return {**{k: v.to(cd) for k, v in w.items()}, "blocks": blocks}

    def _final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x.to(self.dtypes.compute_dtype), self.norm.weight, self.norm.bias,
                          LN_EPS)

    def forward(self, x: torch.Tensor, block_index: int = 0) -> EncoderOutput:
        with span("encoder"):
            cd = self.dtypes.compute_dtype
            w = self.compute_weights()
            tokens = self.patch_embed(x.to(cd), w["patch_w"], w["patch_b"])
            prefix = w["prefix"].expand(x.shape[0], -1, -1)
            tokens = torch.cat([prefix, tokens], dim=1) + w["pos"]
            gelu_approx = resolve_gelu_approx(self.dtypes, self.gelu_tanh)
            if block_index != 0:
                # FastFlow truncation: final norm after every block
                # (reference TransformerEncoder.py:159-163)
                for blk, bw in zip(self.blocks[: block_index + 1], w["blocks"][: block_index + 1]):
                    tokens = _block_apply(tokens, blk, bw, self.num_heads, cd, gelu_approx,
                                          self.fused_mlp)
                    tokens = self._final_norm(tokens)
            else:
                for blk, bw in zip(self.blocks, w["blocks"]):
                    tokens = _block_apply(tokens, blk, bw, self.num_heads, cd, gelu_approx,
                                          self.fused_mlp)
                tokens = self._final_norm(tokens)
            return EncoderOutput(patch_embedding=tokens[:, self.num_prefix_tokens:, :],
                                 latent=tokens[:, 0, :])


def deit_base_distilled_patch16(img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
                                generator: Optional[torch.Generator] = None,
                                fused_mlp: Optional[bool] = None) -> ViTEncoder:
    """DeiT-base distilled /16 — reference EncoderDeit (TransformerEncoder.py:116)."""
    return ViTEncoder(img_size=img_size, patch_size=16, embed_dim=768, depth=12,
                      num_heads=12, num_prefix_tokens=2, dtypes=dtypes, generator=generator,
                      fused_mlp=fused_mlp)


def vit_base_patch16(img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
                     generator: Optional[torch.Generator] = None,
                     fused_mlp: Optional[bool] = None) -> ViTEncoder:
    """ViT-base /16 — reference EncoderVit (TransformerEncoder.py:176)."""
    return ViTEncoder(img_size=img_size, patch_size=16, embed_dim=768, depth=12,
                      num_heads=12, num_prefix_tokens=1, dtypes=dtypes, generator=generator,
                      fused_mlp=fused_mlp)
