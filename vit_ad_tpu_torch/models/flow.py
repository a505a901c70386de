"""FastFlow-style 2-D normalizing flow anomaly head (port of
`vit_ad_tpu/models/flow.py`).

The module tree is the reference's FrEIA layout: `fast_flow_decoder.
module_list.{i}` AllInOneBlocks with `subnet.{0,2}` convs, `global_scale`,
`global_offset` and the `w_perm`/`w_perm_inv` permutation matrices, plus the
reference's unused `layer_norm` member — the state dict
`utils/torch_convert.export_nf_head` emits, loaded with strict=True. Each
block's permutation index is derived from its `w_perm` as `convert_nf_head`
does (perm[i] = argmax_j w_perm[i, j]) and refreshed on every load.

Step semantics (JAX `_step_apply` :95), all in f32: x1 = first C - C//2
channels, x2 = the rest; a = 0.1 * conv(relu(conv(x1))) with 3x3 (even
steps) or 1x1 (odd steps) kernels; s = 2.0 * 0.636 * atan(a[:C//2]), t =
a[C//2:]; x2 ← x2 * exp(s) + t; global affine with scale 0.2 * softplus(0.5 p);
then out[:, i] = y[:, perm[i]], an index gather (the JAX one-hot matmul was a
TPU workaround, flow.py:81-92). Internally the flow runs NCHW; its public
functions keep the JAX layouts ([B, H', W', C] in, [B, H, W] maps out).

Between steps the state is carried as its two halves, [B, C - C//2, H, W]
and [B, C//2, H, W]: each step's first convolution reads the first half as
it is, and the step from the subnet's second convolution on is one call of
`ops/cuda/flow.flow_coupling`: on the card the convolution and one kernel
launch (F1), which makes the convolution's bias add and everything after it
to the permuted output and the logdet, and stores the two halves of the next
step's input; on the CPU the expression above.

Two opt-in levers of the JAX flow, read from the environment at call time,
off by default:
  * `VITAD_FOLD_FLOW_PERMS=1` (JAX :398-435, :511-545): `forward` scores
    through `transform_folded`, which keeps z in the original channel order
    and conjugates each step's parameters by the cumulative channel map (the
    permutations applied before it), so no step permutes; the loss and the
    map are the same, z is not invertible against `inverse`.
  * `VITAD_NF_REVERSIBLE=1` (JAX :211-289): while gradients are recorded,
    the steps run under `_ReversibleSteps`, which keeps only the parameters
    and the final z and rebuilds each step's input from its output in the
    backward (`AllInOneBlock.inverse`). JAX applies it to the coupling pairs
    and leaves an odd tail step to autodiff; here it covers every step (the
    same math).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vit_ad_tpu_torch.models.outputs import FlowOutput
from vit_ad_tpu_torch.ops.cuda.flow import Halves, affine_scale, flow_coupling
from vit_ad_tpu_torch.ops.resize import interpolate_bilinear
from vit_ad_tpu_torch.utils.profiling import span

# softplus_{beta=0.5} parameter value p with 0.1 * softplus(p) == 1.0
_GLOBAL_SCALE_INIT = 2.0 * math.log(math.exp(5.0) - 1.0)


def default_perms(n_steps: int, num_channels: int) -> np.ndarray:
    """Deterministic per-step channel permutations (rng seed = step index),
    identical to the JAX package's."""
    return np.stack(
        [np.random.default_rng(i).permutation(num_channels) for i in range(n_steps)]
    ).astype(np.int32)


StepParams = Tuple[torch.Tensor, ...]  # conv1 w, b; conv2 w, b; global scale, offset


def _refresh_perm(module: "AllInOneBlock", incompatible_keys) -> None:
    with torch.no_grad():
        module.perm.copy_(module.w_perm[:, :, 0, 0].argmax(dim=1))


class AllInOneBlock(nn.Module):
    """One FrEIA AllInOneBlock step (affine coupling + global affine + fixed
    channel permutation), forward and exact inverse on NCHW f32 maps."""

    def __init__(self, channels: int, hidden: int, kernel: int, perm: Sequence[int],
                 clamp: float = 2.0, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.split1 = channels - channels // 2
        self.split2 = channels // 2
        self.clamp = clamp
        self.subnet = nn.Sequential(
            nn.Conv2d(self.split1, hidden, kernel, padding=kernel // 2),
            nn.ReLU(),
            nn.Conv2d(hidden, 2 * self.split2, kernel, padding=kernel // 2),
        )
        self.global_scale = nn.Parameter(torch.full((1, channels, 1, 1), _GLOBAL_SCALE_INIT))
        self.global_offset = nn.Parameter(torch.zeros(1, channels, 1, 1))
        perm_t = torch.as_tensor(np.asarray(perm), dtype=torch.long)
        w_perm = torch.zeros(channels, channels)
        w_perm[torch.arange(channels), perm_t] = 1.0
        self.register_buffer("w_perm", w_perm[:, :, None, None].clone())
        self.register_buffer("w_perm_inv", w_perm.t().contiguous()[:, :, None, None])
        self.register_buffer("perm", perm_t.clone(), persistent=False)
        self.register_load_state_dict_post_hook(_refresh_perm)
        for conv in (self.subnet[0], self.subnet[2]):  # He uniform, zero bias
            nn.init.kaiming_uniform_(conv.weight, nonlinearity="relu", generator=generator)
            nn.init.zeros_(conv.bias)

    def step_params(self) -> StepParams:
        """The tensors one step reads: conv1's and conv2's weight and bias, the
        global scale and offset."""
        c1, c2 = self.subnet[0], self.subnet[2]
        return c1.weight, c1.bias, c2.weight, c2.bias, self.global_scale, self.global_offset

    def _coupling(self, x1: torch.Tensor, p: StepParams) -> Tuple[torch.Tensor, torch.Tensor]:
        pad = p[0].shape[-1] // 2
        a = F.conv2d(F.relu(F.conv2d(x1, p[0], p[1], padding=pad)), p[2], p[3],
                     padding=pad) * 0.1
        s = self.clamp * 0.636 * torch.atan(a[:, : self.split2])
        return s, a[:, self.split2:]

    def step_halves(self, x1: torch.Tensor, x2: torch.Tensor, p: StepParams) -> Halves:
        """The forward on the input's halves [B, split1, H, W] and [B, split2,
        H, W] and the parameters `p` (`step_params`): the output's halves and
        the logdet [B]."""
        hidden = F.relu(F.conv2d(x1, p[0], p[1], padding=p[0].shape[-1] // 2))
        return flow_coupling(x1, x2, hidden, p[2], p[3], p[4], p[5], self.perm,
                             self.clamp * 0.636)

    def step(self, x: torch.Tensor, p: StepParams) -> Tuple[torch.Tensor, torch.Tensor]:
        """The forward on the whole map and the parameters `p` (`step_params`)."""
        y1, y2, logdet = self.step_halves(x[:, : self.split1], x[:, self.split1:], p)
        return torch.cat([y1, y2], dim=1), logdet

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.step(x, self.step_params())

    def inverse(self, y: torch.Tensor, p: Optional[StepParams] = None) -> torch.Tensor:
        """The exact inverse of `step` on the parameters `p` (default: the
        step's own)."""
        p = self.step_params() if p is None else p
        y = torch.empty_like(y).index_copy_(1, self.perm, y)
        y = (y - p[5]) / affine_scale(p[4])
        x1, x2 = y[:, : self.split1], y[:, self.split1:]
        s, t = self._coupling(x1, p)
        return torch.cat([x1, (x2 - t) * torch.exp(-s)], dim=1)

    def folded_params(self, idx: torch.Tensor) -> StepParams:
        """The step's parameters conjugated by the channel map `idx`: stock
        input channel j of this step is channel idx[j] of the original-order
        state (JAX `_fold_before_indices` :113). JAX `_fold_step_params`
        :130, by index scatter: conv1 reads all C channels (its x1 columns at
        their positions, zeros elsewhere), conv2 emits C-wide s and t planes
        (zero off the x2 positions: exp(0)·x + 0 leaves x1 as it is), the
        global affine permuted."""
        w1, b1, w2, b2, gs, go = self.step_params()
        c = idx.numel()
        rows = torch.cat([idx[self.split1:], idx[self.split1:] + c])  # s, then t
        w1f = w1.new_zeros(w1.shape[0], c, *w1.shape[2:]).index_copy(1, idx[: self.split1], w1)
        w2f = w2.new_zeros(2 * c, *w2.shape[1:]).index_copy(0, rows, w2)
        b2f = b2.new_zeros(2 * c).index_copy(0, rows, b2)
        spread = lambda v: v.new_zeros(c).index_copy(0, idx, v.reshape(-1)).view(1, c, 1, 1)
        return w1f, b1, w2f, b2f, spread(gs), spread(go)

    def step_folded(self, x: torch.Tensor, p: StepParams) -> Tuple[torch.Tensor, torch.Tensor]:
        """JAX `_step_apply_folded` (:172) on `folded_params`: no permutation;
        s and t arrive as C-wide planes."""
        h, w, c = x.shape[2], x.shape[3], x.shape[1]
        pad = p[0].shape[-1] // 2
        a = F.conv2d(F.relu(F.conv2d(x, p[0], p[1], padding=pad)), p[2], p[3],
                     padding=pad) * 0.1
        s = self.clamp * 0.636 * torch.atan(a[:, :c])
        x = x * torch.exp(s) + a[:, c:]
        logdet = s.sum(dim=(1, 2, 3))
        scale = affine_scale(p[4])
        return x * scale + p[5], logdet + h * w * torch.log(scale).sum()


class _ReversibleSteps(torch.autograd.Function):
    """The flow's steps with a memory-free backward (`VITAD_NF_REVERSIBLE=1`,
    JAX `_reversible_pair_scan` :223). The forward runs the steps without
    recording and keeps the final z and the parameters; the backward walks
    the steps in reverse, rebuilds each input with `AllInOneBlock.inverse`,
    recomputes the step on it and takes that step's VJP. The parameters are
    explicit inputs, so their gradients come back through autograd as
    usual. Gradients differ from autodiff by the f32 roundoff of the
    inverse (the global-affine divide; the permutation is a gather), which
    grows with the flow's activations: small on the images a flow trains
    on, large where its loss is orders above them (PERF.md)."""

    @staticmethod
    def forward(ctx, steps: nn.ModuleList, z: torch.Tensor, *params: torch.Tensor):
        logdet = torch.zeros(z.shape[0], dtype=torch.float32, device=z.device)
        for i, blk in enumerate(steps):
            z, ld = blk.step(z, params[6 * i: 6 * i + 6])
            logdet = logdet + ld
        ctx.steps = steps
        ctx.save_for_backward(z, *params)
        return z, logdet

    @staticmethod
    def backward(ctx, g_z: torch.Tensor, g_ld: torch.Tensor):
        z, *params = ctx.saved_tensors
        grads: List[Optional[torch.Tensor]] = [None] * len(params)
        for i in reversed(range(len(ctx.steps))):
            blk, p = ctx.steps[i], tuple(params[6 * i: 6 * i + 6])
            want = [j for j in range(6) if ctx.needs_input_grad[2 + 6 * i + j]]
            with torch.no_grad():
                z = blk.inverse(z, p)
            with torch.enable_grad():
                z_in = z.detach().requires_grad_(True)
                p_in = tuple(t.detach().requires_grad_(j in want) for j, t in enumerate(p))
                out = blk.step(z_in, p_in)
                got = torch.autograd.grad(out, [z_in] + [p_in[j] for j in want], (g_z, g_ld))
            g_z = got[0]
            for j, g in zip(want, got[1:]):
                grads[6 * i + j] = g
        return (None, g_z if ctx.needs_input_grad[1] else None, *grads)


def reversible() -> bool:
    return os.environ.get("VITAD_NF_REVERSIBLE") == "1"


def fold_flow_perms() -> bool:
    return os.environ.get("VITAD_FOLD_FLOW_PERMS") == "1"


class _SequenceINN(nn.Module):
    """FrEIA SequenceINN's attribute layout (`module_list`)."""

    def __init__(self, blocks: Sequence[nn.Module]) -> None:
        super().__init__()
        self.module_list = nn.ModuleList(blocks)


class NormalizingFlow(nn.Module):
    """Stack of `flow_steps` AllInOneBlocks, kernels alternating 3x3 (even
    steps) / 1x1 (odd steps), hidden width int((C - C//2) * hidden_ratio).
    `perms` defaults to `default_perms`; a loaded state dict's `w_perm`
    replaces them."""

    def __init__(self, num_channels: int, img_size: int, num_patches: int,
                 hidden_ratio: float = 1.0, flow_steps: int = 8, clamp: float = 2.0,
                 perms: Optional[Sequence[Sequence[int]]] = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        c = num_channels
        self.num_channels = c
        self.img_size = img_size
        self.num_patches = num_patches
        hidden = int((c - c // 2) * hidden_ratio)
        perms = default_perms(flow_steps, c) if perms is None else np.asarray(perms)
        if len(perms) != flow_steps:
            raise ValueError(f"perms has {len(perms)} entries, need {flow_steps}")
        self.fast_flow_decoder = _SequenceINN([
            AllInOneBlock(c, hidden, 3 if i % 2 == 0 else 1, perms[i], clamp, generator)
            for i in range(flow_steps)
        ])
        side = math.isqrt(num_patches)
        self.layer_norm = nn.LayerNorm([c, side, side])  # reference member, unused

    @property
    def steps(self) -> nn.ModuleList:
        return self.fast_flow_decoder.module_list

    @property
    def perms(self) -> np.ndarray:
        return np.stack([b.perm.cpu().numpy() for b in self.steps]).astype(np.int32)

    def _transform_nchw(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if torch.is_grad_enabled() and reversible():
            z = x.float().permute(0, 3, 1, 2).contiguous()
            params = [t for blk in self.steps for t in blk.step_params()]
            return _ReversibleSteps.apply(self.steps, z, *params)
        x = x.float()
        split = self.steps[0].split1
        z1 = x[..., :split].permute(0, 3, 1, 2).contiguous()
        z2 = x[..., split:].permute(0, 3, 1, 2).contiguous()
        logdet = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        for blk in self.steps:
            z1, z2, ld = blk.step_halves(z1, z2, blk.step_params())
            logdet = logdet + ld
        return torch.cat([z1, z2], dim=1), logdet

    def _transform_folded_nchw(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        z = x.float().permute(0, 3, 1, 2).contiguous()
        idx = torch.arange(z.shape[1], device=z.device)  # the permutations so far
        logdet = torch.zeros(z.shape[0], dtype=torch.float32, device=z.device)
        for blk in self.steps:
            z, ld = blk.step_folded(z, blk.folded_params(idx))
            logdet = logdet + ld
            idx = idx[blk.perm]
        return z, logdet

    def transform(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, H, W, C] → (z [B, H, W, C], logdet [B])."""
        with span("flow"):
            z, logdet = self._transform_nchw(x)
            return z.permute(0, 2, 3, 1), logdet

    def transform_folded(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The permutation-folded forward (JAX :511): z in the ORIGINAL
        channel order, not invertible against `inverse`; its channel sums of
        z² and its logdet are `transform`'s."""
        with span("flow"):
            z, logdet = self._transform_folded_nchw(x)
            return z.permute(0, 2, 3, 1), logdet

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        x = z.float().permute(0, 3, 1, 2).contiguous()
        for blk in reversed(self.steps):
            x = blk.inverse(x)
        return x.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> FlowOutput:
        """Loss + anomaly map (reference NormalizingFlow.forward, :118-145).
        x: [B, H', W', C] feature map. `VITAD_FOLD_FLOW_PERMS=1` scores
        through the folded forward (the same loss and map)."""
        with span("flow"):
            z, logdet = (self._transform_folded_nchw if fold_flow_perms()
                         else self._transform_nchw)(x)
            zz = z * z
            loss = torch.mean(0.5 * zz.sum(dim=(1, 2, 3)) - logdet)
            anomaly = 1.0 - torch.exp(-0.5 * zz.mean(dim=1))  # [B, H', W']
            anomaly_map = interpolate_bilinear(anomaly, self.img_size, self.img_size,
                                               align_corners=False)
            return FlowOutput(loss=loss, anomaly_score_map=anomaly_map)


def patch_tokens_to_map(patch_embedding: torch.Tensor) -> torch.Tensor:
    """[B, P, D] → [B, √P, √P, D] (reference LearnerNF.py:140-144)."""
    b, p, d = patch_embedding.shape
    side = math.isqrt(p)
    return patch_embedding.reshape(b, side, side, d)
