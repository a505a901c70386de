"""The mesh as the trainers and evaluators use it (port of
`vit_ad_tpu/parallel/context.py`).

In the JAX package GSPMD inserts the collectives; here `MeshContext` holds
them, and the trainers call them where the math needs them:

  * the batch: data rank d takes rows [d·B/D, (d+1)·B/D) of every padded
    batch (`shard_batch`); every rank builds the same batches;
  * the masked mean is global: each rank backpropagates its valid rows' sum
    over the global valid count (`data_sum`, no gradient), and the gradients
    are then summed over the data axis (`sum_gradients`), not averaged;
  * noise keeps the single-device shape: a rank draws the global shape from
    its copy of the one seeded generator and keeps its rows (`rows`);
  * the MDN heads' mixture components are sharded over the model axis
    (`shard_params`, `sharding.py`); their global softmax and log-likelihood
    merge take the autograd-aware collectives below (`reduce_sum`,
    `replicate_in`, `gather_own_grad`);
  * BatchNorms in training take global-batch statistics (`shard_params`
    gives them the mesh; `models/layers.FusedBatchNorm`);
  * with a model axis above one, the transformer trunks are sharded over it
    (`shard_params`, `sharding.shard_trunk`): each block's row-parallel
    products leave f32 partial sums, which `model_sum` adds up over the
    model axis (no gradient: the trunks are frozen). A model group's ranks
    feed their trunk the same rows, so every trunk call is collective over
    "model" and no rank may make one alone.

Each rank keeps its own optimizer over what it holds: the summed gradient and
the same Adam update keep replicated parameters equal on every rank.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional

import torch
import torch.distributed as dist

from vit_ad_tpu_torch.parallel.mesh import DeviceMesh, Devices, create_mesh


class _ReduceSum(torch.autograd.Function):
    """Sum over an axis; the backward sums the gradients over it too (every
    rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis), None, None


class _ReplicateIn(torch.autograd.Function):
    """Megatron's "f": the identity, whose backward sums the partial
    gradients of the axis' ranks (each saw only its shard's use of x)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis), None, None


class _GatherOwnGrad(torch.autograd.Function):
    """All-gather [axis size, ...] whose backward keeps this rank's slice.
    Every rank holds the same loss of the gathered values, so its upstream
    gradient is the whole one; torch's autograd all-gather would sum the
    ranks' identical copies (reduce-scatter) and scale it by the axis size."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return torch.stack(mesh.all_gather(x, axis))

    @staticmethod
    def backward(ctx, g):
        return g[ctx.mesh.index(ctx.axis)], None, None


class MeshContext:
    """A live (data, model) mesh and the helpers trainers need. Made with
    `MeshContext.from_hp(hp)`, which returns None when the configuration asks
    for no mesh, so the single-process path stays as it is."""

    def __init__(self, mesh: DeviceMesh) -> None:
        self.mesh = mesh

    @classmethod
    def from_hp(cls, hp, devices: Devices = None) -> Optional["MeshContext"]:
        cfg = getattr(hp, "mesh", None)
        if cfg is None or not cfg.requested:
            return None
        return cls(create_mesh(data=cfg.data, model=cfg.model, devices=devices))

    @property
    def data_size(self) -> int:
        return self.mesh.data

    @property
    def model_size(self) -> int:
        return self.mesh.model

    @property
    def data_index(self) -> int:
        return self.mesh.index("data")

    @property
    def model_index(self) -> int:
        return self.mesh.index("model")

    def check_batch(self, batch_size: int) -> None:
        """Static batch shapes must split evenly over the data axis."""
        if batch_size % self.data_size:
            raise ValueError(
                f"batch_size={batch_size} not divisible by the mesh data "
                f"axis ({self.data_size}); pick a multiple (-b) or a "
                f"smaller mesh (--mesh)"
            )

    def rows(self, local_rows: int) -> slice:
        """This data rank's rows of a global batch of local_rows · D."""
        d = self.data_index
        return slice(d * local_rows, (d + 1) * local_rows)

    def shard_batch(self, *arrays: Any):
        """This data rank's rows of each array (numpy or torch, batch first).
        Returns a tuple matching the inputs (one array for one input)."""
        out = []
        for a in arrays:
            self.check_batch(a.shape[0])
            out.append(a[self.rows(a.shape[0] // self.data_size)])
        return tuple(out) if len(out) != 1 else out[0]

    def shard_params(self, module: torch.nn.Module) -> torch.nn.Module:
        """Place a module on the mesh: each MDN head is replaced by this
        rank's shard of its mixture components (`sharding.shard_mdn`), each
        transformer trunk by its shard when the model axis is above one
        (`sharding.shard_trunk`, in place), each FusedBatchNorm takes
        global-batch statistics in training; everything else stays,
        replicated. Returns the module (the shard when `module` is a head)."""
        from vit_ad_tpu_torch.models.layers import FusedBatchNorm
        from vit_ad_tpu_torch.models.mdn import GaussianMDN
        from vit_ad_tpu_torch.parallel.sharding import is_trunk, shard_mdn, shard_trunk

        if isinstance(module, GaussianMDN):
            return shard_mdn(module, self)
        if self.model_size > 1 and is_trunk(module):
            return shard_trunk(module, self)
        for name, child in list(module.named_children()):
            placed = self.shard_params(child)
            if placed is not child:
                setattr(module, name, placed)
        if isinstance(module, FusedBatchNorm):
            module.mesh = self
        return module

    def replicate(self, module: torch.nn.Module) -> torch.nn.Module:
        """Give every rank the primary's parameters and buffers."""
        for t in [*module.parameters(), *module.buffers()]:
            self.mesh.broadcast(t.data)
        return module

    # collectives without gradient
    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the data axis (counts, the logged losses)."""
        return self.mesh.all_reduce(t, "data")

    def model_max(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(t, "model", dist.ReduceOp.MAX)

    def model_sum(self, partial: torch.Tensor) -> torch.Tensor:
        """The sum over the model axis of a row-parallel product's f32
        partial sums, the same bytes on every model rank. No gradient."""
        if partial.dtype != torch.float32:
            raise TypeError(f"model_sum adds f32 partial sums, got {partial.dtype}")
        return self.mesh.all_reduce(partial, "model")

    def model_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every model rank's `t`, in model order."""
        return self.mesh.all_gather(t, "model")

    def sum_gradients(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Sum every gradient over the data axis, in one all-reduce a dtype."""
        if self.data_size == 1:
            return
        by_dtype: dict = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = self.data_sum(torch.cat([g.reshape(-1) for g in grads]))
            for g, s in zip(grads, torch.split(flat, [g.numel() for g in grads])):
                g.copy_(s.view_as(g))

    def gather_rows(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every data rank's `t`, in data order."""
        return self.mesh.all_gather(t, "data")

    def broadcast_object(self, obj: Any) -> Any:
        """The primary's `obj` on every rank (host objects)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.mesh.host)
        return box[0]

    # collectives with gradient
    def reduce_sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        return t if self.mesh.shape[axis] == 1 else _ReduceSum.apply(t, self.mesh, axis)

    def replicate_in(self, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
        return x if self.mesh.shape[axis] == 1 else _ReplicateIn.apply(x, self.mesh, axis)

    def gather_own_grad(self, t: torch.Tensor, axis: str = "model") -> torch.Tensor:
        if self.mesh.shape[axis] == 1:
            return t[None]
        return _GatherOwnGrad.apply(t, self.mesh, axis)

    def draw_rows(self, draw, local_shape, **kw) -> torch.Tensor:
        """`draw(global shape, **kw)` (e.g. `torch.randn` with the run's
        generator), this data rank's rows kept: the numbers a single device
        would give these rows."""
        n = local_shape[0]
        return draw((n * self.data_size, *local_shape[1:]), **kw)[self.rows(n)]

