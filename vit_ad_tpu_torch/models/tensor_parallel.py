"""The steps of a trunk block on a model-axis shard (`parallel/sharding.py`).

A block whose trunk `shard_trunk` has split runs Megatron-style, with the
collective written out: the column-parallel product (the rank's `qkv` heads,
its `fc1` hidden block) needs nothing from the other ranks; the row-parallel
product (`attn.proj`, `mlp.fc2` on the rank's input columns) leaves an f32
partial sum, which is summed over "model" (`MeshContext.model_sum`), and only
then do the replicated bias and the residual join, with one rounding to
the compute dtype. Every model rank then holds the same bytes: the ranks'
partials are summed in one order for all of them, and what follows runs on
equal inputs.

Under the bf16 policy the products go through the MLP kernel's GEMM step
(`ops/cuda/mlp.gemm_step`: the GELU epilogue for `fc1`, the f32-partial
epilogue for `proj` and `fc2`) where `use_gemm_step` admits the widths;
elsewhere (f32, a width that is no multiple of 128) they are torch products
with an f32 result. A shard has no backward: the trunks are frozen, and a
call that would need a gradient raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from vit_ad_tpu_torch.ops.cuda import mlp as cmlp
from vit_ad_tpu_torch.ops.mlp import product_f32


@dataclasses.dataclass(eq=False)
class BlockShard:
    """What a block of a sharded trunk holds as `model_shard`."""

    mc: Any                   # parallel.context.MeshContext
    heads: Optional[slice]    # the rank's heads when the attention is split, else None
    hidden: slice             # the rank's hidden units of the MLP

    def local(self, bias: torch.Tensor) -> torch.Tensor:
        """The rank's part of an `mlp.fc1.bias`, which the rules split in
        some trunks and keep whole in others."""
        n = self.hidden.stop - self.hidden.start
        return bias if bias.shape[0] == n else bias[self.hidden]

    def num_heads(self, whole: int) -> int:
        """The heads of this rank's attention (all `whole` when it is not split)."""
        return whole if self.heads is None else self.heads.stop - self.heads.start


def check_no_grad(x: torch.Tensor, block: torch.nn.Module) -> None:
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(p.requires_grad for p in block.parameters())):
        raise RuntimeError("a model-axis shard of a trunk runs without gradient (the trunk is "
                           "frozen): call it under torch.no_grad() or torch.inference_mode()")


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def column_gelu(y: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                gelu_approx: bool) -> torch.Tensor:
    """gelu(y . w^T + bias) in y's dtype, the rank's hidden block: `w` in the
    compute dtype, `bias` the f32 parameter."""
    if gelu_approx and cmlp.use_gemm_step(w.shape[0], w.shape[1], y.dtype):
        h = cmlp.gemm_step(_rows(y), w, bias, cmlp.EPILOGUE_GELU)
        return h.reshape(*y.shape[:-1], -1)
    return F.gelu(F.linear(y, w, bias.to(y.dtype)), approximate="tanh" if gelu_approx else "none")


def row_partial(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The rank's f32 partial sum a . w^T (`w` the rank's input columns)."""
    if cmlp.use_gemm_step(w.shape[0], w.shape[1], a.dtype):
        return cmlp.gemm_step(_rows(a), w, None, cmlp.EPILOGUE_PARTIAL).reshape(
            *a.shape[:-1], -1)
    return product_f32(a, w)


def reduce_residual(x: torch.Tensor, partial: torch.Tensor, bias: torch.Tensor, mc: Any,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x + scale · (Σ_model partial + bias) in f32, rounded once to x's dtype
    (`scale`: EfficientFormer's layer scale)."""
    out = mc.model_sum(partial) + bias.float()
    if scale is not None:
        out = scale.float() * out
    return (x.float() + out).to(x.dtype)


def attention_residual(x: torch.Tensor, out: torch.Tensor, w: Dict[str, torch.Tensor],
                       proj_bias: torch.Tensor, shard: BlockShard) -> torch.Tensor:
    """x + proj(out): row-parallel on the rank's heads, or the whole
    projection where the attention is not split."""
    if shard.heads is None:
        return x + F.linear(out, w["proj_w"], w["proj_b"])
    return reduce_residual(x, row_partial(out, w["proj_w"]), proj_bias, shard.mc)


def mlp_residual(x: torch.Tensor, y: torch.Tensor, w: Dict[str, torch.Tensor],
                 mlp: torch.nn.Module, shard: BlockShard, gelu_approx: bool,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x + scale · fc2(gelu(fc1(y))) on the rank's hidden block (`y` the
    normed x; `w` the block's compute-dtype weights, the biases the f32
    parameters)."""
    h = column_gelu(y, w["fc1_w"], shard.local(mlp.fc1.bias), gelu_approx)
    return hidden_residual(x, h, w, mlp, shard, scale)


def hidden_residual(x: torch.Tensor, h: torch.Tensor, w: Dict[str, torch.Tensor],
                    mlp: torch.nn.Module, shard: BlockShard,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x + scale · fc2(h) for the rank's hidden activations `h` (where the
    GELU'd fc1 product was taken otherwise: a LayerNorm folded into fc1)."""
    return reduce_residual(x, row_partial(h, w["fc2_w"]), mlp.fc2.bias, shard.mc, scale)
