"""Shared building blocks for the backbones (port of
`vit_ad_tpu/models/layers.py`: `PatchEmbed` :27, `resolve_gelu_approx` :58,
`FusedBatchNorm` :149, `LayerNorm` :227), the frozen trunks' conv and
BatchNorm step (`conv_bn`), the JAX initializers of the conv layers
(`init_conv_layers`), and the cache of compute-dtype weight copies the
encoders share."""

from __future__ import annotations

import functools
import itertools
import math
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.ops.cuda.layer_norm import layer_norm


class PatchEmbed(nn.Module):
    """Image → patch tokens via a stride=patch conv. The conv weight is the
    timm `patch_embed.proj` layout [D, 3, p, p]; input and output follow the
    JAX layouts: [B, H, W, 3] in, [B, P, D] out."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768) -> None:
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """`weight`/`bias`: `proj`'s parameters in the compute dtype (the
        encoder's cached copies)."""
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=self.patch_size)
        return y.flatten(2).transpose(1, 2)  # [B, h*w, D]


def resolve_gelu_approx(dtypes: DtypePolicy, gelu_tanh: Optional[bool] = None) -> bool:
    """The GELU-flavour policy every backbone follows: tanh under bf16 compute,
    exact erf under f32; `VITAD_EXACT_GELU=1` pins exact erf everywhere."""
    if os.environ.get("VITAD_EXACT_GELU"):
        return False
    if gelu_tanh is not None:
        return gelu_tanh
    return dtypes.compute_dtype == torch.bfloat16


def trunc_normal_(t: torch.Tensor, std: float, generator: Optional[torch.Generator]) -> None:
    """N(0, std²) truncated at ±2 std (flax `truncated_normal` semantics)."""
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax `lecun_normal`: N(0, 1/fan_in) truncated at ±2 std, with the
    variance the truncation removes restored."""
    trunc_normal_(t, math.sqrt(1.0 / fan_in) / 0.87962566103423978, generator)


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm`'s parameters (`weight`, `bias`) with the forward of the
    JAX package's module: f32 statistics (bf16 variance is too coarse), cast
    to the compute dtype. By default `F.layer_norm` on the f32 cast; `fused`
    takes the one-pass kernel `ops/cuda/layer_norm.layer_norm`, which stores
    in x's dtype (the JAX package's `VITAD_PALLAS_LN=1`, given when the model
    is built rather than read from the environment)."""

    def __init__(self, dim: int, eps: float = 1e-6, dtypes: DtypePolicy = DtypePolicy(),
                 fused: bool = False) -> None:
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtypes.compute_dtype
        self.fused = fused

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            y = layer_norm(x, self.weight, self.bias, self.eps)
        else:
            y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class FusedBatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW maps with the JAX `FusedBatchNorm` math (:149).

    Inference (eval mode) stays in the compute dtype: per channel
    `mul = rsqrt(var + eps) * weight` in f32 from the f32 running statistics,
    cast once, then `(x - mean) * mul + bias` on the map in x's dtype, in that
    op order. Training (train mode) is flax's: the batch statistics over
    (N, H, W) in f32 as the "fast variance" `mean(x²) - mean(x)²` clamped at
    0 (biased), the running statistics blended in place as
    `MOMENTUM·old + (1 - MOMENTUM)·batch` with no n/(n-1) correction, and the
    map normalised in f32; the caller casts the f32 result to its compute
    dtype. (`F.batch_norm(training=True)` takes the variance in two passes
    and blends the unbiased one into `running_var`: not this function.)
    Parameters and buffers are `nn.BatchNorm2d`'s, so torchvision and the
    reference's state dicts load; `num_batches_tracked` counts the training
    calls and nothing reads it.

    On a mesh with a data axis (`mesh`, set by
    `parallel.context.MeshContext.shard_params`) the training statistics are
    the global batch's: the f32 sums of x and x² all-reduced over the data
    axis with their gradients, over the global count, so the running
    statistics come out the same on every rank."""

    MOMENTUM = 0.9  # flax's convention: the weight of the old statistics

    def __init__(self, channels: int, eps: float = 1e-5) -> None:
        super().__init__(channels, eps=eps)
        self.mesh: Any = None

    def folded(self, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(mean, mul, bias) as [1, C, 1, 1] tensors of `dtype`."""
        mul = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        return tuple(t.to(dtype).view(1, -1, 1, 1)
                     for t in (self.running_mean, mul, self.bias))

    def forward(self, x: torch.Tensor,
                folded: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """`folded`: a cached `self.folded(x.dtype)`, which only the inference
        path reads; a frozen trunk that passes it (`models/resnet.py`) must be
        in eval mode."""
        if self.training:
            if folded is not None:
                raise RuntimeError(
                    "FusedBatchNorm: the folded inference form was passed in training mode; "
                    "a frozen trunk's BatchNorms stay in eval mode (call .eval())")
            return self._train_forward(x)
        mean, mul, bias = self.folded(x.dtype) if folded is None else folded
        return (x - mean) * mul + bias

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.mesh is None or self.mesh.data_size == 1:
            mu = x32.mean(dim=(0, 2, 3))
            var = torch.clamp((x32 * x32).mean(dim=(0, 2, 3)) - mu * mu, min=0.0)
        else:
            sums = self.mesh.reduce_sum(torch.cat([x32.sum(dim=(0, 2, 3)),
                                                   (x32 * x32).sum(dim=(0, 2, 3))]), "data")
            n = x32.numel() // x32.shape[1] * self.mesh.data_size
            mu, sq = (sums / n).chunk(2)
            var = torch.clamp(sq - mu * mu, min=0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mu)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (x32 - mu.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) \
            + self.bias.float().view(1, -1, 1, 1)


def conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn: FusedBatchNorm, weight: torch.Tensor,
            bias: Optional[torch.Tensor],
            folded: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """A frozen trunk's conv and its BatchNorm: `conv`'s geometry on the cached
    compute-dtype `weight` (and `bias`, or None), then `bn` on its cached
    `folded` statistics (eval mode only, which `FusedBatchNorm` checks)."""
    y = F.conv2d(x, weight, bias, conv.stride, conv.padding, conv.dilation, conv.groups)
    return bn(y, folded)


def init_conv_layers(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """JAX's initializers on every conv, transposed conv and Linear of
    `module`: LeCun (truncated) normal kernels over their fan-in (a flax
    ConvTranspose kernel [kh, kw, in, out] counts kh·kw·in), zero biases;
    unit BatchNorms."""
    seen = set()
    for m in module.modules():
        if id(m) in seen:  # a module the reference registers under two names
            continue
        seen.add(id(m))
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            fan_in = (w.shape[0] * w[0, 0].numel() if isinstance(m, nn.ConvTranspose2d)
                      else w[0].numel())
            lecun_normal_(w.data, fan_in, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, FusedBatchNorm):
            m.reset_parameters()


class ComputeWeights:
    """Compute-dtype copies of a module's matmul weights, and whatever else
    `make(module, dtype)` derives from the parameters and buffers (the folded
    BatchNorms read the running statistics). They are cached and made again
    only when a parameter or buffer changed (storage or in-place version:
    `pipeline/loading.compress_params_bf16` rounds them in place); while
    gradients flow to the parameters they are made per call. (JAX casts them
    once per call outside its block scan.) `bake` makes them once as buffers
    of the module, which a `torch.export` trace then reads as constants (its
    tensors have no storage to key the cache on). `card_only`: they are
    kernel operands, read only where the module lies on the card."""

    def __init__(self, make: Callable[[nn.Module, torch.dtype], Dict[str, Any]],
                 card_only: bool = False) -> None:
        self._make = make
        self._card_only = card_only
        self._key: Optional[tuple] = None
        self._cast: Optional[Dict[str, Any]] = None
        self._baked: Optional[tuple] = None  # (leaf sources, tree spec), once baked

    def get(self, module: nn.Module, dtypes: DtypePolicy) -> Dict[str, Any]:
        if self._baked is not None:
            sources, spec = self._baked
            return tree_unflatten([functools.reduce(getattr, src.split("."), module)
                                   if by_name else src for by_name, src in sources], spec)
        cd = dtypes.compute_dtype
        if torch.is_grad_enabled() and any(p.requires_grad for p in module.parameters()):
            return self._make(module, cd)
        key = tuple((t.data_ptr(), t._version, t.device)
                    for t in itertools.chain(module.parameters(), module.buffers()))
        if key != self._key:
            with torch.inference_mode(False), torch.no_grad():
                self._cast = self._make(module, cd)
            self._key = key
        return self._cast

    def bake(self, module: nn.Module, dtypes: DtypePolicy) -> None:
        """Make the tensors once, now, and keep each one that is not a
        parameter or buffer itself as a non-persistent buffer `_baked_<i>`
        of `module`; `get` returns them from then on (by attribute, so
        `torch.func.functional_call` reaches them). For the serving export
        (`serving/aot.py`), on a copy of the models."""
        if self._card_only and not any(p.is_cuda for p in module.parameters()):
            return
        with torch.inference_mode(False), torch.no_grad():
            leaves, spec = tree_flatten(self._make(module, dtypes.compute_dtype))
        own = {id(t): n for n, t in itertools.chain(module.named_parameters(),
                                                    module.named_buffers())}
        storages = {t.untyped_storage().data_ptr()
                    for t in itertools.chain(module.parameters(), module.buffers())}
        sources = []
        for i, leaf in enumerate(leaves):
            if not isinstance(leaf, torch.Tensor):
                sources.append((False, leaf))
                continue
            if id(leaf) not in own:
                if leaf.untyped_storage().data_ptr() in storages:  # a view: a buffer of its own
                    leaf = leaf.clone()
                own[id(leaf)] = f"_baked_{i}"
                storages.add(leaf.untyped_storage().data_ptr())
                module.register_buffer(own[id(leaf)], leaf, persistent=False)
            sources.append((True, own[id(leaf)]))
        self._baked, self._key, self._cast = (sources, spec), None, None


def bake_compute_weights(root: nn.Module) -> None:
    """`ComputeWeights.bake` for every module under `root`."""
    for module in root.modules():
        for attr in list(vars(module).values()):
            if isinstance(attr, ComputeWeights):
                attr.bake(module, module.dtypes)
