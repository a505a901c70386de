"""The normalizing flow's coupling tail as one kernel launch a step (F1).

F1 ports no TPU kernel: the JAX flow (`vit_ad_tpu/models/flow.py`
`_step_apply` :95) leaves the step's elementwise tail to XLA, which fuses it,
and has no Pallas kernel. The hand-written Hopper kernel
`vit_ad_tpu_torch/csrc/flow_coupling.cu` (its header says what bounds it and
how it is laid out) takes over what eager PyTorch ran as some two dozen
launches a step: the soft clamp, exp, the affine coupling, the global affine,
the logdet and the channel permutation, stored straight into the two halves
the next step reads.

`flow_coupling` takes a step from the subnet's hidden activation on: it runs
the subnet's second convolution (cuDNN on the card) and then, for CUDA
tensors, the kernel through the registered op `vit_ad_tpu_torch::
flow_coupling` (`flow_coupling_op`, which `torch.export` carries into a native
serving bundle), raising where it cannot. The kernel also makes the
convolution's bias add, the one f32 add PyTorch runs after a cuDNN
convolution, so the convolution runs without its bias. For CPU tensors it runs
the convolution with its bias and the plain version `flow_coupling_reference`:
the expression of `models/flow.AllInOneBlock.step` as it was before the
kernel, bit for bit. The backward recomputes through the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# Kernel launches made by `flow_coupling` (a plain count, read by chip_smoke.py
# to show that the flow went through the kernel: one a step).
launches = 0

MAX_CHANNELS = 1 << 14
MAX_BATCH = 65535
# What flow_coupling_forward reports through its `route` out-parameter.
_ROUTES = {1: "vector", 2: "scalar"}

Halves = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # y1, y2, logdet


def affine_scale(g: torch.Tensor) -> torch.Tensor:
    """The global affine's scale from its parameter: 0.2 * softplus(0.5 g)."""
    return 0.2 * torch.logaddexp(torch.zeros_like(g), 0.5 * g)


def flow_coupling_reference(x1: torch.Tensor, x2: torch.Tensor, a: torch.Tensor,
                            bias: Optional[torch.Tensor], g: torch.Tensor, o: torch.Tensor,
                            perm: torch.Tensor, coeff: float) -> Halves:
    """One step's tail in plain PyTorch. x1 [B, c1, H, W] and x2 [B, c2, H, W]
    are the step's input halves, `a` [B, 2 c2, H, W] the output of the
    subnet's second convolution, `bias` [2 c2] its bias where `a` does not
    hold it yet (None where it does), g and o the global scale and offset
    parameters [1, C, 1, 1], perm [C] the output channel map, coeff the soft
    clamp's factor (clamp * 0.636). Returns the output's first c1 and last c2
    channels and the logdet [B]."""
    h, w, c1, c2 = x1.shape[2], x1.shape[3], x1.shape[1], x2.shape[1]
    if bias is not None:
        a = a + bias.view(1, -1, 1, 1)
    a = a * 0.1
    s = coeff * torch.atan(a[:, :c2])
    x2 = x2 * torch.exp(s) + a[:, c2:]
    logdet = s.sum(dim=(1, 2, 3))
    scale = affine_scale(g)
    y = torch.cat([x1, x2], dim=1) * scale + o
    logdet = logdet + h * w * torch.log(scale).sum()
    y = y.index_select(1, perm)
    return y[:, :c1], y[:, c1:], logdet


def check_kernel_shape(x1: torch.Tensor, x2: torch.Tensor, a: torch.Tensor,
                       bias: torch.Tensor, g: torch.Tensor, o: torch.Tensor,
                       perm: torch.Tensor) -> Tuple[int, int, int, int]:
    """Raise unless the CUDA kernel takes these inputs: f32 x1 [B, c1, H, W],
    x2 [B, c2, H, W], a [B, 2 c2, H, W] and its bias of 2 c2 elements; f32 g
    and o of C = c1 + c2 elements; int64 perm [C]; 1 <= B <= 65535, C <=
    16384. Returns (B, c1, c2, H W)."""
    for name, t in (("x1", x1), ("x2", x2), ("a", a), ("bias", bias), ("global scale", g),
                    ("global offset", o)):
        if t.dtype != torch.float32:
            raise TypeError(f"flow_coupling kernel takes f32, got {name} {t.dtype}")
    if perm.dtype != torch.int64:
        raise TypeError(f"flow_coupling kernel takes an int64 perm, got {perm.dtype}")
    if x1.dim() != 4 or x2.dim() != 4 or a.dim() != 4:
        raise ValueError("flow_coupling kernel takes [B, c, H, W] maps, got "
                         f"{tuple(x1.shape)}, {tuple(x2.shape)}, {tuple(a.shape)}")
    b, c1, h, w = x1.shape
    c2 = x2.shape[1]
    if (x2.shape[0], x2.shape[2], x2.shape[3]) != (b, h, w) or c1 < 1 or c2 < 1 \
            or tuple(a.shape) != (b, 2 * c2, h, w) or bias.numel() != 2 * c2 \
            or not 1 <= b <= MAX_BATCH or h * w < 1:
        raise ValueError(f"flow_coupling kernel takes halves [B, c1, H, W], [B, c2, H, W], "
                         f"a [B, 2 c2, H, W] and a bias of 2 c2 with 1 <= B <= {MAX_BATCH}, got "
                         f"{tuple(x1.shape)}, {tuple(x2.shape)}, {tuple(a.shape)}, "
                         f"{tuple(bias.shape)}")
    c = c1 + c2
    if c > MAX_CHANNELS or g.numel() != c or o.numel() != c or tuple(perm.shape) != (c,):
        raise ValueError(f"flow_coupling kernel takes at most {MAX_CHANNELS} channels with a "
                         f"global scale, offset and perm of {c} entries, got {g.numel()}, "
                         f"{o.numel()}, {tuple(perm.shape)}")
    return b, c1, c2, h * w


def _planes(t: torch.Tensor) -> torch.Tensor:
    """`t` with contiguous [H, W] planes one channel after the other (a batch
    stride of its own allowed, as in a channel slice of a whole map)."""
    c, h, w = t.shape[1], t.shape[2], t.shape[3]
    if t.stride()[1:] == (h * w, w, 1) and t.stride(0) >= c * h * w:
        return t
    return t.contiguous()


def flow_coupling_route(hw: int, *tensors: torch.Tensor) -> str:
    """The form the C entry launches: 16-byte vectors where a plane's length
    is a multiple of 4 and every map starts 16-byte aligned with a batch
    stride of whole vectors, else scalar."""
    if hw % 4 == 0 and all(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0 for t in tensors):
        return "vector"
    return "scalar"


def _launch(x1, x2, a, bias, g, o, perm, coeff: float) -> Halves:
    global launches
    from vit_ad_tpu_torch.ops.cuda.build import device_index, load_library

    b, c1, c2, hw = check_kernel_shape(x1, x2, a, bias, g, o, perm)
    x1, x2, a = _planes(x1), _planes(x2), a.contiguous()
    bias, g, o, perm = (t.contiguous() for t in (bias, g, o, perm))  # read flat
    y1 = torch.empty((b, c1, *x1.shape[2:]), dtype=torch.float32, device=x1.device)
    y2 = torch.empty((b, c2, *x1.shape[2:]), dtype=torch.float32, device=x1.device)
    logdet = torch.empty(b, dtype=torch.float32, device=x1.device)
    route = ctypes.c_int(0)
    err = load_library().flow_coupling_forward(
        x1.data_ptr(), x2.data_ptr(), a.data_ptr(), bias.data_ptr(), g.data_ptr(), o.data_ptr(),
        perm.data_ptr(), y1.data_ptr(), y2.data_ptr(), logdet.data_ptr(), b, c1, c2, hw,
        x1.stride(0),
        x2.stride(0), float(coeff), device_index(x1),
        torch.cuda.current_stream(x1.device).cuda_stream, ctypes.byref(route),
    )
    if err:
        raise RuntimeError(f"flow_coupling kernel launch failed: CUDA error {err}")
    took, want = _ROUTES.get(route.value), flow_coupling_route(hw, x1, x2, a, y1, y2)
    if took != want:
        raise RuntimeError(f"flow_coupling launched route {route.value} ({took}), expected {want}")
    launches += 1
    return y1, y2, logdet


@torch.library.custom_op("vit_ad_tpu_torch::flow_coupling", mutates_args=(),
                         device_types="cuda")
def flow_coupling_op(x1: torch.Tensor, x2: torch.Tensor, a: torch.Tensor, bias: torch.Tensor,
                     g: torch.Tensor, o: torch.Tensor, perm: torch.Tensor,
                     coeff: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the kernel (F1) on CUDA tensors, as a registered op."""
    return _launch(x1, x2, a, bias, g, o, perm, coeff)


@flow_coupling_op.register_fake
def _(x1, x2, a, bias, g, o, perm, coeff):
    b = check_kernel_shape(x1, x2, a, bias, g, o, perm)[0]
    return x1.new_empty(x1.shape), x2.new_empty(x2.shape), x1.new_empty((b,))


def _forward(x1, x2, a, bias, g, o, perm, coeff: float) -> Halves:
    if x1.device.type == "cuda":
        return flow_coupling_op(x1, x2, a, bias, g, o, perm, coeff)
    if x1.device.type == "cpu":
        return flow_coupling_reference(x1, x2, a, bias, g, o, perm, coeff)
    raise RuntimeError(f"flow_coupling has no path for device {x1.device}")


class _FlowCoupling(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x1, x2, a, bias, g, o, perm, coeff):
        ctx.save_for_backward(x1, x2, a, bias, g, o, perm)
        ctx.coeff = coeff
        return _forward(x1, x2, a, bias, g, o, perm, coeff)

    @staticmethod
    def backward(ctx, g_y1, g_y2, g_logdet):
        *saved, perm = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in saved]
            outs = flow_coupling_reference(*ins, perm, ctx.coeff)
            grads = torch.autograd.grad(outs, ins, (g_y1, g_y2, g_logdet))
        return (*grads, None, None)


def flow_coupling(x1: torch.Tensor, x2: torch.Tensor, h: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor, g: torch.Tensor, o: torch.Tensor, perm: torch.Tensor,
                  coeff: float) -> Halves:
    """One coupling step from the subnet's hidden activation h on: its second
    convolution (weight w2, bias b2, "same" padding) and the tail
    (`flow_coupling_reference` says what it computes). On CUDA tensors the
    tail is the kernel, which adds the bias, differentiable by recomputation
    through the plain version (where no gradient is wanted the autograd node
    is skipped); on CPU tensors, the plain version."""
    pad = w2.shape[-1] // 2
    if x1.device.type == "cpu":
        return flow_coupling_reference(x1, x2, F.conv2d(h, w2, b2, padding=pad), None, g, o,
                                       perm, coeff)
    a = F.conv2d(h, w2, None, padding=pad)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x1, x2, a, b2, g, o)):
        return _FlowCoupling.apply(x1, x2, a, b2, g, o, perm, coeff)
    return _forward(x1, x2, a, b2, g, o, perm, coeff)
