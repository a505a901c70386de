"""The attention kernels' wrappers: packed-qkv multi-head self-attention of
the ViT/DeiT blocks, and (shifted-)window attention of the Swin blocks.

Port of `vit_ad_tpu/ops/pallas/window_attention.py::vit_attention_qkv` (:437),
whose TPU kernel `_kernel_qkv` (:375) becomes the hand-written Hopper kernel
`vit_ad_tpu_torch/csrc/vit_attention_qkv.cu` (see its header for what bounds
it on the H100 and what the design does about it; `attention_route` says
which of its kernels a shape takes).

`vit_attention_qkv` launches that kernel for a CUDA tensor, and raises where it
cannot. For a CPU tensor it runs the plain PyTorch version
`vit_attention_qkv_reference`, the same math as the JAX package's
`_xla_packed_attention` (:427) / `_xla_plain_attention` (:485). Its backward
recomputes through the plain version, as the JAX custom VJP does (:445-455):
the TPU kernel had no backward kernel either.

`swin_attention_windows` (packed qkv windows; port of :334, TPU kernel
`_kernel_win` :212) and `window_attention` (split q, k, v; port of :518, TPU
kernel `_kernel` :46) launch the one entry of
`vit_ad_tpu_torch/csrc/swin_window_attention.cu` the same way (with the two
rounding points; `window_attention_route` says which of its kernels a shape
takes); their plain
versions are `ops/window_attention.window_attention_reference` and
`window_attention_core_reference`. Both backwards recompute through
`window_attention_core_reference`, the math the JAX custom VJPs differentiate
(:360-368, :538-549), and reach q, k, v and the bias table.

Each launch is the body of a registered op (`vit_ad_tpu_torch::
vit_attention_qkv`, `::swin_window_attention`, `::split_window_attention`),
with a fake implementation that states the output, so `torch.export` carries
the kernels into a native serving bundle (`serving/aot.py`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from vit_ad_tpu_torch.ops.window_attention import (
    attention_scale as _scale,
    gather_bias,
    relative_position_index,
    split_packed,
    window_attention_core_reference,
    window_attention_reference,
)

# Kernel launches made by `vit_attention_qkv`, `swin_attention_windows` and
# `window_attention` (plain counts, read by chip_smoke.py to show that the
# main path went through each kernel).
launches = 0
window_launches = 0
split_launches = 0
# Of `launches`, `window_launches` and `split_launches`, the calls for which
# the C entry point reported the one-pass bf16 kernel.
one_pass_launches = 0
window_one_pass_launches = 0
split_one_pass_launches = 0
# the route `swin_window_attention_forward` reported for the last window launch
last_window_route = ""
# `attention_route`'s and `window_attention_route`'s names for what
# `vit_attention_qkv_forward` and `swin_window_attention_forward` report as launched
ROUTE_NAMES = {1: "one_pass", 2: "two_pass", 3: "fma"}

SUPPORTED_HEAD_DIMS = (32, 64)
MAX_TOKENS = 256
# Up to here a warp of the bf16 ViT and window kernels holds its 16 x N scores
# in registers (26 key tiles of 8); `kOnePassMaxTokens` of
# csrc/vit_attention_qkv.cu and of csrc/swin_window_attention.cu.
ONE_PASS_MAX_TOKENS = 208
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def attention_route(n: int, dtype: torch.dtype) -> str:
    """Which kernel of csrc/vit_attention_qkv.cu `vit_attention_qkv` launches
    for N tokens of `dtype` on a CUDA tensor: "one_pass" (bf16, scores in
    registers, one QK^T), "two_pass" (bf16 above 208 tokens), "fma" (f32), or
    "" where it raises."""
    if dtype not in _KERNEL_DTYPES or not 1 <= n <= MAX_TOKENS:
        return ""
    if dtype == torch.float32:
        return "fma"
    return "one_pass" if n <= ONE_PASS_MAX_TOKENS else "two_pass"


def window_attention_route(n: int, dtype: torch.dtype) -> str:
    """Which kernel of csrc/swin_window_attention.cu `swin_attention_windows`
    and `window_attention` launch for windows of N tokens of `dtype` on a CUDA
    tensor: "one_pass" (bf16 up to 208 tokens), "two_pass" (bf16 above), "fma"
    (f32), or "" where they raise. The same routes as `attention_route`."""
    return attention_route(n, dtype)


def _dims(qkv: torch.Tensor, num_heads: int) -> Tuple[int, int, int, int]:
    """(B, N, C, hd) of packed qkv [B, N, 3C], channel order [3][H][hd]."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % num_heads:
        raise ValueError(
            f"expected packed qkv [B, N, 3*C] with C divisible by num_heads="
            f"{num_heads}, got shape {tuple(qkv.shape)}"
        )
    b, n, c3 = qkv.shape
    return b, n, c3 // 3, c3 // 3 // num_heads


@functools.lru_cache(maxsize=None)
def _scale_value(head_dim: int, dtype: torch.dtype) -> float:
    return float(_scale(head_dim, dtype))


def vit_attention_qkv_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch MHSA from packed qkv [B, N, 3C] → [B, N, C]: q·scale in the
    input dtype, f32 scores and softmax, probabilities rounded to the input
    dtype, PV in the input dtype (f32 accumulation)."""
    b, n, c, hd = _dims(qkv, num_heads)
    q, k, v = qkv.reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q = q * _scale(hd, qkv.dtype).to(qkv.device)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))  # [B, H, N, N]
    probs = torch.softmax(scores, dim=-1).to(qkv.dtype)
    out = torch.matmul(probs, v)  # [B, H, N, hd]
    return out.transpose(1, 2).reshape(b, n, c)


def check_kernel_shape(qkv: torch.Tensor, num_heads: int) -> Tuple[int, int, int, int]:
    """Raise unless the CUDA kernel takes this input: bf16 or f32, head dim
    32 or 64, 1 ≤ N ≤ 256. Returns (B, N, C, hd)."""
    b, n, c, hd = _dims(qkv, num_heads)
    if qkv.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"vit_attention_qkv kernel takes bf16 or f32, got {qkv.dtype}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"vit_attention_qkv kernel takes head dim {SUPPORTED_HEAD_DIMS}, got {hd}"
        )
    if not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"vit_attention_qkv kernel takes 1..{MAX_TOKENS} tokens, got {n}")
    if b < 1:
        raise ValueError("vit_attention_qkv kernel needs a batch of at least 1")
    return b, n, c, hd


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t  # the kernels read 16 bytes at a time


def _launch(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    global launches, one_pass_launches
    from vit_ad_tpu_torch.ops.cuda.build import device_index, load_library

    b, n, c, hd = check_kernel_shape(qkv, num_heads)
    lib = load_library()
    qkv = _aligned(qkv)
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    took = ctypes.c_int(0)
    err = lib.vit_attention_qkv_forward(
        qkv.data_ptr(), out.data_ptr(), b, n, num_heads, hd,
        int(qkv.dtype == torch.bfloat16), _scale_value(hd, qkv.dtype),
        device_index(qkv), stream, ctypes.byref(took),
    )
    if err:
        raise RuntimeError(f"vit_attention_qkv kernel launch failed: CUDA error {err}")
    launches += 1
    one_pass_launches += int(ROUTE_NAMES[took.value] == "one_pass")
    return out


@torch.library.custom_op("vit_ad_tpu_torch::vit_attention_qkv", mutates_args=(),
                         device_types="cuda")
def vit_attention_qkv_op(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """One launch of the kernel (B1) on a CUDA tensor, as a registered op."""
    return _launch(qkv, num_heads)


@vit_attention_qkv_op.register_fake
def _(qkv, num_heads):
    b, n, c, _ = check_kernel_shape(qkv, num_heads)
    return qkv.new_empty((b, n, c))


def _forward(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    if qkv.device.type == "cuda":
        return vit_attention_qkv_op(qkv, num_heads)
    if qkv.device.type == "cpu":
        return vit_attention_qkv_reference(qkv, num_heads)
    raise RuntimeError(f"vit_attention_qkv has no path for device {qkv.device}")


class _VitAttentionQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return _forward(qkv, num_heads)

    @staticmethod
    def backward(ctx, grad):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().requires_grad_(True)
            out = vit_attention_qkv_reference(x, ctx.num_heads)
            (dx,) = torch.autograd.grad(out, x, grad)
        return dx, None


def vit_attention_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Differentiable MHSA from packed qkv [B, N, 3C] → [B, N, C]: the Hopper
    kernel on CUDA tensors, the plain version on CPU tensors, backward by
    recomputation through the plain version."""
    _dims(qkv, num_heads)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _VitAttentionQKV.apply(qkv, num_heads)
    return _forward(qkv, num_heads)


# ---- Swin window attention ---------------------------------------------------


def _check_window_inputs(n: int, heads: int, hd: int, dtype: torch.dtype, bias: torch.Tensor,
                         mask: Optional[torch.Tensor], b_: int) -> None:
    """Raise unless the CUDA kernel takes this input."""
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"window attention kernel takes bf16 or f32, got {dtype}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"window attention kernel takes head dim {SUPPORTED_HEAD_DIMS}, "
                         f"got {hd}")
    if not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"window attention kernel takes 1..{MAX_TOKENS} tokens per window, "
                         f"got {n}")
    if b_ < 1:
        raise ValueError("window attention kernel needs at least one window")
    if tuple(bias.shape) != (heads, n, n):
        raise ValueError(f"bias must be [H, N, N] = {(heads, n, n)}, got {tuple(bias.shape)}")
    if mask is not None and (mask.dim() != 3 or tuple(mask.shape[1:]) != (n, n)
                             or b_ % mask.shape[0]):
        raise ValueError(f"mask must be [n_w, {n}, {n}] with n_w dividing the {b_} windows, "
                         f"got {tuple(mask.shape)}")


def _launch_windows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, row_stride: int,
                    b_: int, n: int, heads: int, hd: int, bias: torch.Tensor,
                    mask: Optional[torch.Tensor], defer_norm: bool) -> Tuple[torch.Tensor, str]:
    """One launch of `swin_window_attention_forward`; q, k, v are views whose
    rows are `row_stride` elements apart. Returns the output and the route the
    entry point reported as launched."""
    global last_window_route
    from vit_ad_tpu_torch.ops.cuda.build import device_index, load_library

    _check_window_inputs(n, heads, hd, q.dtype, bias, mask, b_)
    bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty((b_, n, heads * hd), dtype=q.dtype, device=q.device)
    took = ctypes.c_int(0)
    err = load_library().swin_window_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), b_, n, heads, hd, row_stride,
        1 if mask is None else mask.shape[0], int(defer_norm),
        int(q.dtype == torch.bfloat16), _scale_value(hd, q.dtype), device_index(q),
        torch.cuda.current_stream(q.device).cuda_stream, ctypes.byref(took),
    )
    if err:
        raise RuntimeError(f"window attention kernel launch failed: CUDA error {err}")
    last_window_route = ROUTE_NAMES[took.value]
    return out, last_window_route


@torch.library.custom_op("vit_ad_tpu_torch::swin_window_attention", mutates_args=(),
                         device_types="cuda")
def swin_window_attention_op(qkv3: torch.Tensor, bias: torch.Tensor,
                             mask: Optional[torch.Tensor], num_heads: int) -> torch.Tensor:
    """One launch of the kernel (B5) on packed CUDA windows, as a registered op."""
    global window_launches, window_one_pass_launches
    b_, n, c, hd = _dims(qkv3, num_heads)
    qkv3 = _aligned(qkv3)
    out, route = _launch_windows(qkv3, qkv3[..., c:], qkv3[..., 2 * c:], 3 * c, b_, n,
                                 num_heads, hd, bias, mask, defer_norm=True)
    window_launches += 1
    window_one_pass_launches += int(route == "one_pass")
    return out


@swin_window_attention_op.register_fake
def _(qkv3, bias, mask, num_heads):
    b_, n, c, hd = _dims(qkv3, num_heads)
    _check_window_inputs(n, num_heads, hd, qkv3.dtype, bias, mask, b_)
    return qkv3.new_empty((b_, n, c))


def _windows_forward(qkv3: torch.Tensor, bias: torch.Tensor, mask: Optional[torch.Tensor],
                     num_heads: int) -> torch.Tensor:
    if qkv3.device.type == "cuda":
        return swin_window_attention_op(qkv3, bias, mask, num_heads)
    if qkv3.device.type == "cpu":
        return window_attention_reference(qkv3, bias, mask, num_heads)
    raise RuntimeError(f"swin_attention_windows has no path for device {qkv3.device}")


@torch.library.custom_op("vit_ad_tpu_torch::split_window_attention", mutates_args=(),
                         device_types="cuda")
def split_window_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of the kernel's split-input entry (B5a), as a registered op."""
    global split_launches, split_one_pass_launches
    b_, n, h, hd = q.shape
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out, route = _launch_windows(q, k, v, h * hd, b_, n, h, hd, bias, mask, defer_norm=False)
    split_launches += 1
    split_one_pass_launches += int(route == "one_pass")
    return out


@split_window_attention_op.register_fake
def _(q, k, v, bias, mask):
    b_, n, h, hd = q.shape
    _check_window_inputs(n, h, hd, q.dtype, bias, mask, b_)
    return q.new_empty((b_, n, h * hd))


def split_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The forward of `window_attention` with the bias already gathered: q, k, v
    [B_, N, H, hd], bias [H, N, N] f32, mask [n_w, N, N] or None → [B_, N, H*hd].
    The kernel on CUDA tensors, the plain version on CPU tensors; no gradient."""
    if q.device.type == "cuda":
        return split_window_attention_op(q, k, v, bias, mask)
    if q.device.type == "cpu":
        return window_attention_core_reference(q, k, v, bias, mask)
    raise RuntimeError(f"window_attention has no path for device {q.device}")


def _recompute_grads(q, k, v, bias, mask, grad):
    """Gradients of `window_attention_core_reference` to q, k, v [B_, N, H, hd]
    and bias [H, N, N] (None where not needed)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (q, k, v, bias)]
        out = window_attention_core_reference(*ins, mask)
        return torch.autograd.grad(out, ins, grad)


class _SwinAttentionWindows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv3, bias, mask, num_heads):
        ctx.save_for_backward(qkv3, bias, mask)
        ctx.num_heads = num_heads
        return _windows_forward(qkv3, bias, mask, num_heads)

    @staticmethod
    def backward(ctx, grad):
        qkv3, bias, mask = ctx.saved_tensors
        q, k, v = (t.transpose(1, 2) for t in split_packed(qkv3, ctx.num_heads))
        dq, dk, dv, dbias = _recompute_grads(q, k, v, bias, mask, grad)
        dqkv = torch.stack([dq, dk, dv], dim=2).reshape(qkv3.shape)  # [B_, N, 3, H, hd]
        return dqkv, dbias, None, None


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, mask):
        ctx.save_for_backward(q, k, v, bias, mask)
        return split_window_attention(q, k, v, bias, mask)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, bias, mask = ctx.saved_tensors
        return (*_recompute_grads(q, k, v, bias, mask, grad), None)


@functools.lru_cache(maxsize=None)
def _index_on(window_h: int, window_w: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(relative_position_index(window_h, window_w)).to(device)


def swin_attention_windows(qkv3: torch.Tensor, bias_table: torch.Tensor, num_heads: int,
                           window: int, mask: Optional[torch.Tensor] = None,
                           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable window attention from packed qkv windows [B_, N, 3C]
    (channel order [3][H][hd], N = window²) → [B_, N, C]: the Hopper kernel on
    CUDA tensors, the plain version on CPU tensors, backward by recomputation.
    `bias_table` [(2·window-1)², H] is gathered to [H, N, N] here; a caller
    whose table is constant passes the gathered `bias` instead and skips the
    gather. `mask` is [n_w, N, N] (0 / -100) or None."""
    _dims(qkv3, num_heads)
    if qkv3.shape[1] != window * window:
        raise ValueError(f"windows of {window}x{window} hold {window * window} tokens, "
                         f"got {qkv3.shape[1]}")
    if bias is None:
        bias = gather_bias(bias_table, _index_on(window, window, bias_table.device))
    if torch.is_grad_enabled() and (qkv3.requires_grad or bias.requires_grad):
        return _SwinAttentionWindows.apply(qkv3, bias, mask, num_heads)
    return _windows_forward(qkv3, bias, mask, num_heads)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias_table: torch.Tensor, num_heads: int, window: Tuple[int, int],
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable window attention from split q, k, v [B_, N, H, hd] →
    [B_, N, H*hd] (the split-input entry of the same kernel)."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape or q.shape[2] != num_heads:
        raise ValueError(f"expected q, k, v [B_, N, {num_heads}, hd] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bias = gather_bias(bias_table, _index_on(window[0], window[1], bias_table.device))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        return _WindowAttention.apply(q, k, v, bias, mask)
    return split_window_attention(q, k, v, bias, mask)
