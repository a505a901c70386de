"""EsViT Swin-Transformer backbone (port of `vit_ad_tpu/models/swin.py`).

Patch-embed conv (4x4, stride 4) + LayerNorm, four stages of shifted-window
blocks (Swin-T: depths 2/2/6/2, heads 3/6/12/24, dims 96·2^i, window 14) with
PatchMerging between stages, final LayerNorm; the dense-prediction output is
(mean-pooled latent, per-patch grid). Swin conventions kept: window and shift
clamped when a stage's resolution is at most the window (stage 3 at 224 px
runs 7x7 full-resolution attention, no shift), alternating shift 0 /
window//2, padding to window multiples before the partition, per-window
relative-position bias, additive -100 shift mask.

Module layout and state-dict keys are the vendored EsViT module's
(`patch_embed.{proj,norm}`, `layers.{i}.blocks.{j}.{norm1,attn.qkv,
attn.relative_position_bias_table,attn.relative_position_index,attn.proj,
norm2,mlp.fc1,mlp.fc2}`, `layers.{i}.downsample.{norm,reduction}`, `norm`),
the layout `utils/torch_convert.export_swin` emits, so exported JAX weights
load with strict=True. `relative_position_index` is a persistent buffer; the
shift mask is built once per stage and is not in the state dict.

Blocks are map-native ([B, H, W, C]) like the JAX `_block_apply` (:130): the
residual stream is in the compute dtype, LayerNorm statistics run in f32
(eps 1e-5 everywhere), the matmul weights run in the compute dtype and every
window attention is the packed-windows kernel
(`ops/cuda/window_attention.swin_attention_windows`). The compute-dtype
weight copies and the gathered [H, N, N] relative-position biases are made
once and reused while the parameters are unchanged. `fused_ln` sends every
LayerNorm through the one-pass kernel (`ops/cuda/layer_norm.py`). The JAX
package's scan stacking and its layout and blocking knobs are TPU machinery
and are not carried over.

Three opt-in levers of the JAX block, read from the environment at call
time, all off by default:
  * `VITAD_SWIN_PARTITION=gather` (JAX :203-207): one `index_select` over the
    flattened padded map replaces the roll and the window partition, another
    with the inverse permutation the window reverse and the roll back
    (`ops/window_attention.partition_perm`); the same windows, bit for bit.
  * `VITAD_SWIN_PACKED=0` (JAX :86-100): q, k, v are split from the packed
    qkv and go through the split-input entry of the window kernel (B5a,
    `ops/cuda/window_attention.window_attention`) in place of the packed
    entry (B5), with the same gathered bias and shift mask.
  * `VITAD_SWIN_LN_FOLD=1` (JAX :156-168, :222-227): norm1 folds into the
    qkv GEMM and norm2 into fc1 (`layers.ln_fold_gemm`), so the block norms
    skip B7; off where the stage pads. The folded weights are cached with
    the compute-dtype copies.

On a mesh whose model axis is above one the blocks run as shards
(`parallel/sharding.shard_trunk`, `models/tensor_parallel.py`): a stage
whose heads the axis divides runs the window kernel on the rank's heads with
its columns of the bias table, and `proj` as an f32 partial summed over
"model"; a stage whose heads it does not divide keeps its attention whole;
every MLP runs `fc1`'s hidden block and `fc2` as an f32 partial, summed.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.layers import (
    ComputeWeights,
    LayerNorm,
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
from vit_ad_tpu_torch.models.vit import Mlp
from vit_ad_tpu_torch.ops import window_attention as wa
from vit_ad_tpu_torch.ops.cuda.window_attention import swin_attention_windows, window_attention
from vit_ad_tpu_torch.utils.profiling import span

LN_EPS = 1e-5
# Whether the LayerNorms go through the one-pass kernel unless the caller says
# otherwise. On: on an H100 the Swin-T encoder at batch 128 in bf16 took 14.6 ms
# with it and 20.8 ms without (chip_smoke.py; PERF.md, Findings). On CPU
# tensors the kernel's plain version runs either way.
FUSED_LN_DEFAULT = True


def swin_gather() -> bool:
    return os.environ.get("VITAD_SWIN_PARTITION") == "gather"


def swin_split() -> bool:
    return os.environ.get("VITAD_SWIN_PACKED", "1") == "0"


def swin_ln_fold() -> bool:
    return os.environ.get("VITAD_SWIN_LN_FOLD") == "1"


class WindowAttention(nn.Module):
    """Parameter holder of one block's attention: qkv and proj Linears, the
    relative-position bias table [(2W-1)², H] and its index buffer [N, N]."""

    def __init__(self, dim: int, window: int, num_heads: int) -> None:
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(wa.relative_position_index(window, window)))
        self.proj = nn.Linear(dim, dim)


class SwinBlock(nn.Module):
    """Parameter holder of one Swin block; `_block_apply` runs it."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int, mlp_ratio: float,
                 dtypes: DtypePolicy, fused_ln: bool) -> None:
        super().__init__()
        self.num_heads, self.window, self.shift = num_heads, window, shift
        self.norm1 = LayerNorm(dim, eps=LN_EPS, dtypes=dtypes, fused=fused_ln)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, dtypes=dtypes, fused=fused_ln)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        # the JAX block norms are its functional `_layer_norm`: no bf16 control
        self.norm1.bf16_control = self.norm2.bf16_control = False


def _block_apply(x: torch.Tensor, blk: SwinBlock, w: Dict[str, Any],
                 mask: Optional[torch.Tensor], gelu_approx: bool) -> torch.Tensor:
    """One Swin block on the [B, H, W, C] feature map in the compute dtype
    (JAX `_block_apply` :130). `w` holds the block's matmul weights in the
    compute dtype and its gathered relative-position bias (and, under
    `VITAD_SWIN_LN_FOLD=1`, its folded norms); `mask` is the stage's shift
    mask."""
    shard = getattr(blk, "model_shard", None)
    if shard is not None:
        check_no_grad(x, blk)
    b, h, wd, c = x.shape
    cd = x.dtype
    window, shift = blk.window, blk.shift
    pad_b = (window - h % window) % window
    pad_r = (window - wd % window) % window
    # padding the normed map gives pad tokens qkv = b; the fold would give b'
    fold = swin_ln_fold() and not (pad_b or pad_r)
    gather = swin_gather()
    y = x if fold else blk.norm1(x)
    if pad_b or pad_r:
        y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
    hp, wp = h + pad_b, wd + pad_r
    if gather:
        perm, inv = wa.partition_indices(hp, wp, window, shift, y.device)
        windows = y.reshape(b, hp * wp, c).index_select(1, perm).reshape(-1, window * window, c)
    else:
        if shift > 0:
            y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
        windows = wa.window_partition(y, window)  # [B_, N, C]
    if fold:
        qkv = ln_fold_gemm(windows, w["fold1"], LN_EPS, cd)
    else:
        qkv = F.linear(windows, w["qkv_w"], w["qkv_b"])  # [B_, N, 3C], packed [3][H][hd]
    heads = blk.num_heads if shard is None else shard.num_heads(blk.num_heads)
    table, m = blk.attn.relative_position_bias_table, mask if shift > 0 else None
    if swin_split():
        b_, n, c3 = qkv.shape
        q, k, v = qkv.reshape(b_, n, 3, heads, c3 // 3 // heads).unbind(2)
        out = window_attention(q, k, v, table, heads, (window, window), m, bias=w["bias"])
    else:
        out = swin_attention_windows(qkv, table, heads, window, m, bias=w["bias"])
    if gather:
        y = out.reshape(b, hp * wp, -1).index_select(1, inv).reshape(b, hp, wp, -1)
    else:
        y = wa.window_reverse(out, window, hp, wp)
        if shift > 0:
            y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
    if pad_b or pad_r:
        y = y[:, :h, :wd, :]
    approx = "tanh" if gelu_approx else "none"
    if shard is not None:
        x = attention_residual(x, y, w, blk.attn.proj.bias, shard)
        if fold:
            hdn = F.gelu(ln_fold_gemm(x, w["fold2"], LN_EPS, cd), approximate=approx)
            return hidden_residual(x, hdn, w, blk.mlp, shard)
        return mlp_residual(x, blk.norm2(x), w, blk.mlp, shard, gelu_approx)
    x = x + F.linear(y, w["proj_w"], w["proj_b"])
    if fold:
        hdn = F.gelu(ln_fold_gemm(x, w["fold2"], LN_EPS, cd), approximate=approx)
    else:
        hdn = F.gelu(F.linear(blk.norm2(x), w["fc1_w"], w["fc1_b"]), approximate=approx)
    return x + F.linear(hdn, w["fc2_w"], w["fc2_b"])


def _own_heads(blk: SwinBlock, table: torch.Tensor) -> torch.Tensor:
    """The bias table's columns of the heads this rank runs (all of them
    unless the block's attention is split over the model axis)."""
    shard = getattr(blk, "model_shard", None)
    return table if shard is None or shard.heads is None else table[:, shard.heads]


class PatchMerging(nn.Module):
    """2x2 concat + LayerNorm(4C) + Linear 4C→2C on the map (JAX :347)."""

    def __init__(self, dim: int, dtypes: DtypePolicy, fused_ln: bool) -> None:
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=LN_EPS, dtypes=dtypes, fused=fused_ln)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, reduction_w: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] → [B, H/2, W/2, 2C]; `reduction_w` is the reduction
        weight in the compute dtype."""
        if x.shape[1] % 2 or x.shape[2] % 2:
            raise ValueError(f"PatchMerging needs an even map, got {tuple(x.shape[1:3])}")
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return F.linear(self.norm(x), reduction_w)


class SwinStage(nn.Module):
    """`depth` blocks, alternately unshifted and shifted, then the stage's
    PatchMerging (all but the last stage). Window and shift are clamped when
    the stage's resolution is at most the window (JAX :294-297); the shift
    mask of the padded map is built once here (:314-317)."""

    def __init__(self, dim: int, num_heads: int, depth: int, window: int, resolution: int,
                 mlp_ratio: float, downsample: bool, dtypes: DtypePolicy,
                 fused_ln: bool) -> None:
        super().__init__()
        if depth % 2:
            raise ValueError("Swin stages use (unshifted, shifted) pairs: depth must be even")
        shift = window // 2
        if resolution <= window:
            window, shift = resolution, 0
        self.window, self.shift = window, shift
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window, shift if j % 2 else 0, mlp_ratio, dtypes,
                      fused_ln)
            for j in range(depth))
        padded = resolution + (window - resolution % window) % window
        mask = wa.shift_attention_mask(padded, padded, window, shift)
        self.register_buffer("attn_mask", None if mask is None else torch.from_numpy(mask),
                             persistent=False)
        self.downsample = PatchMerging(dim, dtypes, fused_ln) if downsample else None


class SwinTransformer(nn.Module):
    """Swin trunk with dense-prediction output. Input [B, H, W, 3] float
    (preprocessed), output `EncoderOutput` with the last stage's tokens
    [B, P, D] after the final LayerNorm and their mean over tokens [B, D].
    `embed_dim` is the width of the patch embedding (96 for Swin-T), as in
    the JAX module; the attribute `embed_dim` of the built encoder is the
    OUTPUT width D = embed_dim · 2^(stages-1), which the heads read, as they
    read it from the ViT encoder. Parameters are made on the CPU from
    `generator` (JAX's initializers, other random numbers)."""

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 4,
        embed_dim: int = 96,
        depths: Sequence[int] = (2, 2, 6, 2),
        num_heads: Sequence[int] = (3, 6, 12, 24),
        window: int = 14,
        mlp_ratio: float = 4.0,
        dtypes: DtypePolicy = DtypePolicy(),
        fused_ln: Optional[bool] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if len(depths) != len(num_heads):
            raise ValueError("depths and num_heads must name the same stages")
        self.img_size = img_size
        self.patch_size = patch_size
        self.stem_dim = embed_dim
        self.embed_dim = embed_dim * 2 ** (len(depths) - 1)
        self.dtypes = dtypes
        self.fused_ln = FUSED_LN_DEFAULT if fused_ln is None else fused_ln
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.patch_embed.norm = LayerNorm(embed_dim, eps=LN_EPS, dtypes=dtypes,
                                          fused=self.fused_ln)
        res, dim, stages = img_size // patch_size, embed_dim, []
        for si, (depth, heads) in enumerate(zip(depths, num_heads)):
            last = si == len(depths) - 1
            stages.append(SwinStage(dim, heads, depth, window, res, mlp_ratio, not last, dtypes,
                                    self.fused_ln))
            if not last:
                res, dim = res // 2, dim * 2
        self.layers = nn.ModuleList(stages)
        self.num_patches = res * res
        self.norm = LayerNorm(dim, eps=LN_EPS, dtypes=dtypes, fused=self.fused_ln)
        self._compute_weights = ComputeWeights(type(self)._cast_weights, variant=swin_ln_fold)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """JAX's initializers: LeCun (truncated) normal for the patch conv and
        the merge reductions, Glorot uniform for the block Linears, truncated
        normal 0.02 for the bias tables, zero biases, unit LayerNorms."""
        conv = self.patch_embed.proj
        lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
        nn.init.zeros_(conv.bias)
        for stage in self.layers:
            for blk in stage.blocks:
                for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
                    nn.init.xavier_uniform_(lin.weight, generator=generator)
                    nn.init.zeros_(lin.bias)
                trunc_normal_(blk.attn.relative_position_bias_table, 0.02, generator)
            if stage.downsample is not None:
                red = stage.downsample.reduction
                lecun_normal_(red.weight, red.in_features, generator)
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def compute_weights(self) -> Dict[str, Any]:
        """The matmul weights in the compute dtype and every block's gathered
        relative-position bias [H, N, N] f32 (under `VITAD_SWIN_LN_FOLD=1`
        also its folded norms), cached until a parameter or the lever
        changes (`layers.ComputeWeights`)."""
        return self._compute_weights.get(self, self.dtypes)

    def _cast_weights(self, cd: torch.dtype) -> Dict[str, Any]:
        stages: List[Dict[str, Any]] = []
        for stage in self.layers:
            blocks = [{
                "qkv_w": b.attn.qkv.weight.to(cd), "qkv_b": b.attn.qkv.bias.to(cd),
                "proj_w": b.attn.proj.weight.to(cd), "proj_b": b.attn.proj.bias.to(cd),
                "fc1_w": b.mlp.fc1.weight.to(cd), "fc1_b": b.mlp.fc1.bias.to(cd),
                "fc2_w": b.mlp.fc2.weight.to(cd), "fc2_b": b.mlp.fc2.bias.to(cd),
                "bias": wa.gather_bias(_own_heads(b, b.attn.relative_position_bias_table),
                                       b.attn.relative_position_index),
            } for b in stage.blocks]
            if swin_ln_fold():
                for b, bw in zip(stage.blocks, blocks):
                    bw.update(block_ln_folds(b, bw, cd))
            red = None if stage.downsample is None else stage.downsample.reduction.weight.to(cd)
            stages.append({"blocks": blocks, "reduction_w": red})
        proj = self.patch_embed.proj
        return {"patch_w": proj.weight.to(cd), "patch_b": proj.bias.to(cd), "stages": stages}

    def forward(self, x: torch.Tensor, block_index: int = 0) -> EncoderOutput:
        """`block_index` is accepted and ignored, as in the JAX module."""
        with span("encoder"):
            cd = self.dtypes.compute_dtype
            w = self.compute_weights()
            b, side = x.shape[0], x.shape[1] // self.patch_size
            tokens = self.patch_embed(x.to(cd), w["patch_w"], w["patch_b"])
            xm = self.patch_embed.norm(tokens).reshape(b, side, x.shape[2] // self.patch_size, -1)
            gelu_approx = resolve_gelu_approx(self.dtypes)
            for stage, sw in zip(self.layers, w["stages"]):
                for blk, bw in zip(stage.blocks, sw["blocks"]):
                    xm = _block_apply(xm, blk, bw, stage.attn_mask, gelu_approx)
                if stage.downsample is not None:
                    xm = stage.downsample(xm, sw["reduction_w"])
            region = self.norm(xm.reshape(b, -1, xm.shape[-1]))
            return EncoderOutput(patch_embedding=region, latent=region.mean(dim=1))


class EsViTEncoder(SwinTransformer):
    """The reference's EncoderEsVit: Swin-T at window 14, effective patch 32,
    768 channels at the dense-prediction output (49 tokens at 224 px)."""

    def __init__(self, img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
                 fused_ln: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(img_size=img_size, dtypes=dtypes, fused_ln=fused_ln,
                         generator=generator)


def esvit_swin_tiny(img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
                    fused_ln: Optional[bool] = None,
                    generator: Optional[torch.Generator] = None) -> EsViTEncoder:
    return EsViTEncoder(img_size=img_size, dtypes=dtypes, fused_ln=fused_ln, generator=generator)
