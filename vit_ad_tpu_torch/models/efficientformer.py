"""EfficientFormer-L3 backbone (port of `vit_ad_tpu/models/efficientformer.py`).

Conv stem (two 3x3/s2 `ConvBN` + GELU → /4), four stages (dims
64/128/320/512, depths 4/4/12/6) with a 3x3/s2 `ConvBN` downsample before
each stage after the first. The blocks are "4D" MetaFormer blocks
(`Meta4D`: avg-pool token mixer minus identity, two 1x1 `ConvBN` with GELU
between, layer-scaled residuals) except the last four of the last stage,
which flatten the map to tokens and run "3D" pre-LN attention blocks
(`Meta3D`). Output: the final LayerNorm's tokens [B, 49, 512] at 224 px and
their mean as the latent.

Module layout and state-dict keys are timm `efficientformer_l3`'s, the
layout `utils/torch_convert.export_efficientformer` (:712) emits:
`stem.{conv1,norm1,conv2,norm2}`, `stages.{i}.downsample.{conv,norm}` for
i > 0, `stages.{i}.blocks.{j}.{layer_scale_1,layer_scale_2}`, the 4D blocks'
`mlp.{fc1,norm1,fc2,norm2}`, the 3D blocks' `norm1`,
`token_mixer.{qkv,attention_biases,attention_bias_idxs,proj}`, `norm2`,
`mlp.{fc1,fc2}`, and `norm`. timm's parameter-less `Flat` holds one slot of
the last stage's blocks before the 3D blocks, so their indices are shifted by
one; `attention_bias_idxs` is a persistent buffer (|dy|·res + |dx|).

Cast points follow the JAX module: the maps and tokens are in the compute
dtype, the BatchNorms are `layers.FusedBatchNorm` in eval form (eps 1e-5) on
cached folded statistics, LayerNorm statistics run in f32 (eps 1e-6), GELU
follows the policy (tanh under bf16). The 3D attention has per-head q, k of
32 and v of 128 channels (laid out `[q | k | v]` per head), f32 scores plus
the gathered attention bias (cached), f32 softmax, probabilities rounded to
the compute dtype: plain torch ops, as no TPU kernel computes it either.
Convolutions read NHWC maps as NCHW tensors in channels_last memory.

On a mesh whose model axis is above one the four Meta3D MLPs run as shards
(`parallel/sharding.shard_trunk`, `models/tensor_parallel.py`): `fc1`'s
hidden block, `fc2` as an f32 partial summed over "model", then its bias and
the layer scale. The Meta4D conv MLPs stay whole (their BatchNorms are
folded per channel).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.layers import (
    ComputeWeights,
    FusedBatchNorm,
    LayerNorm,
    conv_bn,
    init_conv_layers,
    resolve_gelu_approx,
)
from vit_ad_tpu_torch.models.outputs import EncoderOutput
from vit_ad_tpu_torch.models.tensor_parallel import check_no_grad, mlp_residual
from vit_ad_tpu_torch.models.vit import Mlp
from vit_ad_tpu_torch.ops.window_attention import attention_scale
from vit_ad_tpu_torch.utils.profiling import span

LN_EPS = 1e-6
BN_EPS = 1e-5
LAYER_SCALE_INIT = 1e-5


def abs_rel_pos_index(resolution: int) -> np.ndarray:
    """[N, N] int64 indices into the (resolution²)-entry attention-bias table:
    |dy|·resolution + |dx| (JAX `_abs_rel_pos_index` :82-92)."""
    pos = np.stack(np.meshgrid(np.arange(resolution), np.arange(resolution),
                               indexing="ij")).reshape(2, -1)
    rel = np.abs(pos[:, :, None] - pos[:, None, :])
    return (rel[0] * resolution + rel[1]).astype(np.int64)


class ConvNorm(nn.Module):
    """A conv with bias and its BatchNorm, under timm's attribute names."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2)
        self.norm = FusedBatchNorm(cout, eps=BN_EPS)


class Stem(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(3, dim // 2, 3, stride=2, padding=1)
        self.norm1 = FusedBatchNorm(dim // 2, eps=BN_EPS)
        self.conv2 = nn.Conv2d(dim // 2, dim, 3, stride=2, padding=1)
        self.norm2 = FusedBatchNorm(dim, eps=BN_EPS)


class ConvMlp(nn.Module):
    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.norm1 = FusedBatchNorm(hidden, eps=BN_EPS)
        self.fc2 = nn.Conv2d(hidden, dim, 1)
        self.norm2 = FusedBatchNorm(dim, eps=BN_EPS)


class Meta4D(nn.Module):
    """timm `MetaBlock2d`: the pool mixer and the conv MLP (JAX :63-79)."""

    def __init__(self, dim: int, mlp_ratio: float) -> None:
        super().__init__()
        self.mlp = ConvMlp(dim, int(dim * mlp_ratio))
        self.layer_scale_1 = nn.Parameter(torch.full((dim,), LAYER_SCALE_INIT))
        self.layer_scale_2 = nn.Parameter(torch.full((dim,), LAYER_SCALE_INIT))


class Flat(nn.Module):
    """timm's parameter-less slot before the 3D blocks (the map → tokens
    reshape runs in `EfficientFormer.forward`)."""


class Attention3D(nn.Module):
    """timm's `Attention` of the 3D block: qkv [heads·(2·key_dim + d)],
    per-head attention biases over absolute offsets, proj from heads·d."""

    def __init__(self, dim: int, num_heads: int, key_dim: int, attn_ratio: int,
                 resolution: int) -> None:
        super().__init__()
        self.num_heads, self.key_dim, self.d = num_heads, key_dim, attn_ratio * key_dim
        self.qkv = nn.Linear(dim, num_heads * (2 * key_dim + self.d))
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, resolution * resolution))
        self.register_buffer("attention_bias_idxs",
                             torch.from_numpy(abs_rel_pos_index(resolution)))
        self.proj = nn.Linear(num_heads * self.d, dim)


class Meta3D(nn.Module):
    """timm `MetaBlock1d`: pre-LN attention and MLP with layer scales
    (JAX :82-147)."""

    def __init__(self, dim: int, num_heads: int, key_dim: int, attn_ratio: int,
                 resolution: int, mlp_ratio: float, dtypes: DtypePolicy) -> None:
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=LN_EPS, dtypes=dtypes)
        self.token_mixer = Attention3D(dim, num_heads, key_dim, attn_ratio, resolution)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, dtypes=dtypes)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.layer_scale_1 = nn.Parameter(torch.full((dim,), LAYER_SCALE_INIT))
        self.layer_scale_2 = nn.Parameter(torch.full((dim,), LAYER_SCALE_INIT))


class Stage(nn.Module):
    def __init__(self, cin: int, dim: int, depth: int, n_3d: int, downsample: bool,
                 attn: Dict[str, int], resolution: int, mlp_ratio: float,
                 dtypes: DtypePolicy) -> None:
        super().__init__()
        self.downsample = ConvNorm(cin, dim, 3, 2) if downsample else None
        blocks = [Meta4D(dim, mlp_ratio) for _ in range(depth - n_3d)]
        if n_3d:
            blocks.append(Flat())
            blocks += [Meta3D(dim, resolution=resolution, mlp_ratio=mlp_ratio, dtypes=dtypes,
                              **attn) for _ in range(n_3d)]
        self.blocks = nn.ModuleList(blocks)


def _meta4d_apply(x: torch.Tensor, blk: Meta4D, w: Dict[str, Any], pre: str,
                  gelu: str) -> torch.Tensor:
    ls1, ls2 = w[f"{pre}.ls"]
    pooled = F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)
    x = x + ls1 * (pooled - x)
    y = F.gelu(conv_bn(x, blk.mlp.fc1, blk.mlp.norm1, *w[f"{pre}.mlp.fc1"]), approximate=gelu)
    return x + ls2 * conv_bn(y, blk.mlp.fc2, blk.mlp.norm2, *w[f"{pre}.mlp.fc2"])


def _meta3d_apply(x: torch.Tensor, blk: Meta3D, w: Dict[str, Any], pre: str,
                  gelu: str) -> torch.Tensor:
    """One 3D block on tokens [B, N, C] in the compute dtype (JAX `Meta3D`)."""
    shard = getattr(blk, "model_shard", None)
    if shard is not None:
        check_no_grad(x, blk)
    b, n, _ = x.shape
    att = blk.token_mixer
    heads, kd = att.num_heads, att.key_dim
    bw = w[pre]
    qkv = F.linear(blk.norm1(x), bw["qkv_w"], bw["qkv_b"]).reshape(b, n, heads, -1)
    q, k, v = (t.transpose(1, 2) for t in (qkv[..., :kd], qkv[..., kd:2 * kd],
                                           qkv[..., 2 * kd:]))  # [B, H, N, *]
    q = q * attention_scale(kd, q.dtype).to(q.device)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bw["bias"]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, -1)
    x = x + bw["ls1"] * F.linear(out, bw["proj_w"], bw["proj_b"])
    if shard is not None:
        return mlp_residual(x, blk.norm2(x), bw, blk.mlp, shard, gelu == "tanh", bw["ls2"])
    h = F.gelu(F.linear(blk.norm2(x), bw["fc1_w"], bw["fc1_b"]), approximate=gelu)
    return x + bw["ls2"] * F.linear(h, bw["fc2_w"], bw["fc2_b"])


class EfficientFormer(nn.Module):
    """EfficientFormer trunk, frozen (its BatchNorms run on their running
    statistics: keep it in eval mode). Input [B, H, W, 3] float
    (preprocessed), output `EncoderOutput` with tokens [B, (H/32)², D] and
    their mean. Parameters are made on the CPU from `generator` (LeCun normal
    for the convs and Linears, unit BatchNorms and LayerNorms, layer scales
    1e-5, zero attention biases, as the JAX init)."""

    def __init__(
        self,
        img_size: int = 224,
        dims: Sequence[int] = (64, 128, 320, 512),
        depths: Sequence[int] = (4, 4, 12, 6),
        vit_num: int = 4,
        num_heads: int = 8,
        key_dim: int = 32,
        attn_ratio: int = 4,
        mlp_ratio: float = 4.0,
        dtypes: DtypePolicy = DtypePolicy(),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if len(dims) != len(depths) or not 0 <= vit_num <= depths[-1]:
            raise ValueError("dims and depths must name the same stages, and vit_num at most "
                             "the last stage's depth")
        self.img_size = img_size
        self.embed_dim = dims[-1]
        self.dtypes = dtypes
        side = img_size
        for _ in range(len(dims) + 1):  # the stem's two and each downsample's 3x3/s2 conv
            side = (side + 1) // 2
        self.num_patches = side * side
        self.stem = Stem(dims[0])
        attn = {"num_heads": num_heads, "key_dim": key_dim, "attn_ratio": attn_ratio}
        self.stages = nn.ModuleList(
            Stage(dims[max(si - 1, 0)], dim, depth, vit_num if si == len(dims) - 1 else 0,
                  si > 0, attn, side, mlp_ratio, dtypes)
            for si, (dim, depth) in enumerate(zip(dims, depths)))
        self.norm = LayerNorm(self.embed_dim, eps=LN_EPS, dtypes=dtypes)
        self._compute_weights = ComputeWeights(type(self)._cast_weights)
        self.reset_parameters(generator)
        self.eval()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_conv_layers(self, generator)
        for m in self.modules():
            if isinstance(m, (Meta4D, Meta3D)):
                nn.init.constant_(m.layer_scale_1, LAYER_SCALE_INIT)
                nn.init.constant_(m.layer_scale_2, LAYER_SCALE_INIT)
            elif isinstance(m, Attention3D):
                nn.init.zeros_(m.attention_biases)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def compute_weights(self) -> Dict[str, Any]:
        """Conv weights (channels_last) and biases, folded BatchNorms, layer
        scales, the 3D blocks' matmul weights and gathered attention biases
        [H, N, N] f32, all in the compute dtype but the biases; cached until a
        parameter changes (`layers.ComputeWeights`)."""
        return self._compute_weights.get(self, self.dtypes)

    def _cast_weights(self, cd: torch.dtype) -> Dict[str, Any]:
        out: Dict[str, Any] = {}

        def cache_conv_bn(name: str, conv: nn.Conv2d, bn: FusedBatchNorm) -> None:
            out[name] = (conv.weight.to(cd).contiguous(memory_format=torch.channels_last),
                         conv.bias.to(cd), bn.folded(cd))

        cache_conv_bn("stem1", self.stem.conv1, self.stem.norm1)
        cache_conv_bn("stem2", self.stem.conv2, self.stem.norm2)
        for si, stage in enumerate(self.stages):
            if stage.downsample is not None:
                cache_conv_bn(f"{si}.down", stage.downsample.conv, stage.downsample.norm)
            for bj, blk in enumerate(stage.blocks):
                pre = f"{si}.{bj}"
                if isinstance(blk, Meta4D):
                    out[f"{pre}.ls"] = tuple(t.to(cd).view(1, -1, 1, 1)
                                             for t in (blk.layer_scale_1, blk.layer_scale_2))
                    cache_conv_bn(f"{pre}.mlp.fc1", blk.mlp.fc1, blk.mlp.norm1)
                    cache_conv_bn(f"{pre}.mlp.fc2", blk.mlp.fc2, blk.mlp.norm2)
                elif isinstance(blk, Meta3D):
                    att = blk.token_mixer
                    out[pre] = {
                        "qkv_w": att.qkv.weight.to(cd), "qkv_b": att.qkv.bias.to(cd),
                        "proj_w": att.proj.weight.to(cd), "proj_b": att.proj.bias.to(cd),
                        "fc1_w": blk.mlp.fc1.weight.to(cd), "fc1_b": blk.mlp.fc1.bias.to(cd),
                        "fc2_w": blk.mlp.fc2.weight.to(cd), "fc2_b": blk.mlp.fc2.bias.to(cd),
                        "ls1": blk.layer_scale_1.to(cd), "ls2": blk.layer_scale_2.to(cd),
                        "bias": att.attention_biases.float()[:, att.attention_bias_idxs],
                    }
        return out

    def forward(self, x: torch.Tensor, block_index: int = 0) -> EncoderOutput:
        """`block_index` is accepted and ignored, as in the JAX module."""
        with span("encoder"):
            cd = self.dtypes.compute_dtype
            w = self.compute_weights()
            gelu = "tanh" if resolve_gelu_approx(self.dtypes) else "none"
            b = x.shape[0]
            xm = x.to(cd).permute(0, 3, 1, 2)  # NCHW view of the NHWC bytes: channels_last
            xm = F.gelu(conv_bn(xm, self.stem.conv1, self.stem.norm1, *w["stem1"]),
                        approximate=gelu)
            xm = F.gelu(conv_bn(xm, self.stem.conv2, self.stem.norm2, *w["stem2"]),
                        approximate=gelu)
            tokens = None
            for si, stage in enumerate(self.stages):
                if stage.downsample is not None:
                    xm = conv_bn(xm, stage.downsample.conv, stage.downsample.norm,
                                 *w[f"{si}.down"])
                for bj, blk in enumerate(stage.blocks):
                    if isinstance(blk, Meta4D):
                        xm = _meta4d_apply(xm, blk, w, f"{si}.{bj}", gelu)
                    elif isinstance(blk, Flat):
                        tokens = xm.permute(0, 2, 3, 1).reshape(b, -1, xm.shape[1])
                    else:
                        tokens = _meta3d_apply(tokens, blk, w, f"{si}.{bj}", gelu)
            if tokens is None:
                tokens = xm.permute(0, 2, 3, 1).reshape(b, -1, xm.shape[1])
            tokens = self.norm(tokens)
            return EncoderOutput(patch_embedding=tokens, latent=tokens.mean(dim=1))


def efficientformer_l3(img_size: int = 224, dtypes: DtypePolicy = DtypePolicy(),
                       generator: Optional[torch.Generator] = None) -> EfficientFormer:
    """EfficientFormer-L3 (timm `efficientformer_l3`): reference
    EncoderEfficientFormer (TransformerEncoder.py:81-113)."""
    return EfficientFormer(img_size=img_size, dtypes=dtypes, generator=generator)
