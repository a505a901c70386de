"""NesT-T backbone (port of `vit_ad_tpu/models/nest.py`).

Patch conv 4x4/s4, then three levels (dims 96/192/384, heads 3/6/12, depths
2/2/8 for NesT-T). Each level cuts its map into non-overlapping blocks of
14x14 tokens (the side of the last level's map, the same at every level),
adds the level's positional embedding per block, and runs pre-LN transformer
blocks inside each block; between levels a `ConvPool` (conv3x3 → LayerNorm →
max-pool 3x3/s2, padding 1 on each side, as the JAX module pads it :101)
halves the map. The output is the final LayerNorm's channel-last tokens
[B, 196, 384] at 224 px and their mean as the latent: the JAX package's
tokens, not the reference's interleaved reshape of the NCHW map (:13-18).

Module layout and state-dict keys are timm `jx_nest_tiny`'s, the layout
`utils/torch_convert.export_nest` (:662) emits: `patch_embed.proj`,
`levels.{i}.pos_embed`, `levels.{i}.pool.{conv,norm}` for i > 0,
`levels.{i}.transformer_encoder.{j}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,
mlp.fc2}` and `norm`. timm merges the heads as (head_dim, heads) before
`attn.proj`, while the attention kernel writes (heads, head_dim): the
parameter keeps timm's order, and the compute-dtype copy of its weight has
its columns permuted once (`_proj_heads_first`).

Cast points follow the JAX `NestBlock` (:50-85): the block tokens are in the
compute dtype, LayerNorm statistics run in f32 (eps 1e-6), the matmul weights
run in the compute dtype and attention is the packed-qkv kernel
(`ops/cuda/window_attention.vit_attention_qkv`, which the JAX block reaches
too). `fused_ln` sends every LayerNorm (27 at NesT-T) through the one-pass
kernel (`ops/cuda/layer_norm.py`), the port's counterpart of the JAX
package's `VITAD_PALLAS_LN=1`. Convolutions read NHWC maps as NCHW tensors in
channels_last memory.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.layers import (
    ComputeWeights,
    LayerNorm,
    PatchEmbed,
    lecun_normal_,
    resolve_gelu_approx,
    trunc_normal_,
)
from vit_ad_tpu_torch.models.outputs import EncoderOutput
from vit_ad_tpu_torch.models.vit import Attention, Mlp
from vit_ad_tpu_torch.ops import window_attention as wa
from vit_ad_tpu_torch.ops.cuda.window_attention import vit_attention_qkv

LN_EPS = 1e-6
# Whether the LayerNorms go through the one-pass kernel unless the caller says
# otherwise. On: on an NVIDIA H100 80GB HBM3 at 700 W NesT-T + NF-20 scored a
# batch of 128 in 22.0-22.5 ms with it and 28.9-29.2 ms without, the encoder
# alone in 10.0-10.4 and 17.3-17.5 ms (chip_smoke.py; PERF.md, Findings). On
# CPU tensors the kernel's plain version runs either way.
FUSED_LN_DEFAULT = True


class NestBlock(nn.Module):
    """Parameter holder of one pre-LN block; `_block_apply` runs it."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, dtypes: DtypePolicy,
                 fused_ln: bool) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = LayerNorm(dim, eps=LN_EPS, dtypes=dtypes, fused=fused_ln)
        self.attn = Attention(dim)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, dtypes=dtypes, fused=fused_ln)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))


def _block_apply(x: torch.Tensor, blk: NestBlock, w: Dict[str, torch.Tensor], cd: torch.dtype,
                 gelu_approx: bool) -> torch.Tensor:
    """One block on the block tokens [B*nB, N, C] in the compute dtype (JAX
    `NestBlock` :50). `w` holds the block's matmul weights in the compute
    dtype, `proj_w` with its columns in (heads, head_dim) order."""
    qkv = F.linear(blk.norm1(x), w["qkv_w"], w["qkv_b"])  # [B_, N, 3C], [3][H][hd]
    out = vit_attention_qkv(qkv, blk.num_heads).to(cd)
    x = x + F.linear(out, w["proj_w"], w["proj_b"])
    h = F.gelu(F.linear(blk.norm2(x), w["fc1_w"], w["fc1_b"]),
               approximate="tanh" if gelu_approx else "none")
    return x + F.linear(h, w["fc2_w"], w["fc2_b"])


class ConvPool(nn.Module):
    """Between-level aggregation: conv3x3 → LayerNorm → max-pool 3x3/s2 with
    padding (1, 1) (JAX `ConvPool` :89-101)."""

    def __init__(self, in_dim: int, out_dim: int, dtypes: DtypePolicy, fused_ln: bool) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_dim, out_dim, 3, padding=1)
        self.norm = LayerNorm(out_dim, eps=LN_EPS, dtypes=dtypes, fused=fused_ln)

    def forward(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] → [B, H/2, W/2, C']; `weight`/`bias` are the conv's in
        the compute dtype."""
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=1)
        y = self.norm(y.permute(0, 2, 3, 1))
        return F.max_pool2d(y.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)


class NestLevel(nn.Module):
    """timm's `NestLevel`: the level's `pos_embed` [1, blocks, N, C], the
    `ConvPool` that starts it (levels after the first) and its blocks."""

    def __init__(self, prev_dim: Optional[int], dim: int, num_heads: int, depth: int,
                 num_blocks: int, seq_len: int, mlp_ratio: float, dtypes: DtypePolicy,
                 fused_ln: bool) -> None:
        super().__init__()
        self.pos_embed = nn.Parameter(torch.zeros(1, num_blocks, seq_len, dim))
        self.pool = None if prev_dim is None else ConvPool(prev_dim, dim, dtypes, fused_ln)
        self.transformer_encoder = nn.ModuleList(
            NestBlock(dim, num_heads, mlp_ratio, dtypes, fused_ln) for _ in range(depth))


def _proj_heads_first(weight: torch.Tensor, num_heads: int) -> torch.Tensor:
    """timm's `attn.proj.weight` [C, C], whose input columns are in (head_dim,
    heads) order, with its columns in the (heads, head_dim) order the
    attention kernel writes (`torch_convert.convert_nest` :240-245)."""
    c = weight.shape[1]
    return weight.reshape(-1, c // num_heads, num_heads).transpose(1, 2).reshape(-1, c)


class NesT(nn.Module):
    """NesT trunk. Input [B, H, W, 3] float (preprocessed), output
    `EncoderOutput` with the last level's tokens [B, P, D] after the final
    LayerNorm and their mean [B, D]. Parameters are made on the CPU from
    `generator` (JAX's initializers: LeCun normal for the convs and Linears,
    truncated normal 0.02 for the positional embeddings)."""

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 4,
        embed_dims: Sequence[int] = (96, 192, 384),
        num_heads: Sequence[int] = (3, 6, 12),
        depths: Sequence[int] = (2, 2, 8),
        mlp_ratio: float = 4.0,
        dtypes: DtypePolicy = DtypePolicy(),
        fused_ln: Optional[bool] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if not len(embed_dims) == len(num_heads) == len(depths):
            raise ValueError("embed_dims, num_heads and depths must name the same levels")
        n_levels = len(depths)
        self.img_size = img_size
        self.patch_size = patch_size
        self.embed_dim = embed_dims[-1]
        self.dtypes = dtypes
        self.fused_ln = FUSED_LN_DEFAULT if fused_ln is None else bool(fused_ln)
        # the block side in tokens: the last level's map is one block
        self.block = img_size // (patch_size * 2 ** (n_levels - 1))
        self.num_patches = self.block * self.block
        self.patch_embed = PatchEmbed(patch_size, embed_dims[0])
        levels, prev = [], None
        for li, (dim, heads, depth) in enumerate(zip(embed_dims, num_heads, depths)):
            grid = 2 ** (n_levels - 1 - li)
            levels.append(NestLevel(prev, dim, heads, depth, grid * grid, self.num_patches,
                                    mlp_ratio, dtypes, self.fused_ln))
            prev = dim
        self.levels = nn.ModuleList(levels)
        self.norm = LayerNorm(self.embed_dim, eps=LN_EPS, dtypes=dtypes, fused=self.fused_ln)
        self._compute_weights = ComputeWeights(type(self)._cast_weights)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for level in self.levels:
            trunc_normal_(level.pos_embed, 0.02, generator)

    def compute_weights(self) -> Dict[str, Any]:
        """The conv and matmul weights and the positional embeddings in the
        compute dtype, cached until a parameter changes
        (`layers.ComputeWeights`)."""
        return self._compute_weights.get(self, self.dtypes)

    def _cast_weights(self, cd: torch.dtype) -> Dict[str, Any]:
        conv = lambda m: m.weight.to(cd).contiguous(memory_format=torch.channels_last)
        levels: List[Dict[str, Any]] = []
        for level in self.levels:
            blocks = [{
                "qkv_w": b.attn.qkv.weight.to(cd), "qkv_b": b.attn.qkv.bias.to(cd),
                "proj_w": _proj_heads_first(b.attn.proj.weight, b.num_heads).to(cd),
                "proj_b": b.attn.proj.bias.to(cd),
                "fc1_w": b.mlp.fc1.weight.to(cd), "fc1_b": b.mlp.fc1.bias.to(cd),
                "fc2_w": b.mlp.fc2.weight.to(cd), "fc2_b": b.mlp.fc2.bias.to(cd),
            } for b in level.transformer_encoder]
            pool = level.pool
            levels.append({"pos": level.pos_embed.to(cd), "blocks": blocks,
                           "pool_w": None if pool is None else conv(pool.conv),
                           "pool_b": None if pool is None else pool.conv.bias.to(cd)})
        proj = self.patch_embed.proj
        return {"patch_w": proj.weight.to(cd), "patch_b": proj.bias.to(cd), "levels": levels}

    def forward(self, x: torch.Tensor, block_index: int = 0) -> EncoderOutput:
        """`block_index` is accepted and ignored, as in the JAX module."""
        cd = self.dtypes.compute_dtype
        w = self.compute_weights()
        b, p = x.shape[0], self.patch_size
        xm = self.patch_embed(x.to(cd), w["patch_w"], w["patch_b"])
        xm = xm.reshape(b, x.shape[1] // p, x.shape[2] // p, -1)
        gelu_approx = resolve_gelu_approx(self.dtypes)
        n = self.block * self.block
        for level, lw in zip(self.levels, w["levels"]):
            if level.pool is not None:
                xm = level.pool(xm, lw["pool_w"], lw["pool_b"])
            _, h, wd, c = xm.shape
            tokens = wa.window_partition(xm, self.block)  # [B*nB, N, C], JAX's block order
            tokens = (tokens.reshape(b, -1, n, c) + lw["pos"]).reshape(-1, n, c)
            for blk, bw in zip(level.transformer_encoder, lw["blocks"]):
                tokens = _block_apply(tokens, blk, bw, cd, gelu_approx)
            xm = wa.window_reverse(tokens, self.block, h, wd)
        tokens = self.norm(xm).reshape(b, -1, self.embed_dim)
        return EncoderOutput(patch_embedding=tokens, latent=tokens.mean(dim=1))


def nest_tiny(img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
              fused_ln: Optional[bool] = None,
              generator: Optional[torch.Generator] = None) -> NesT:
    """NesT-T (timm `jx_nest_tiny`): reference EncoderNest
    (TransformerEncoder.py:46-78)."""
    return NesT(img_size=img_size, dtypes=dtypes, fused_ln=fused_ln, generator=generator)
