"""Packed-qkv multi-head self-attention of the ViT/DeiT blocks.

Port of `vit_ad_tpu/ops/pallas/window_attention.py::vit_attention_qkv` (:437),
whose TPU kernel `_kernel_qkv` (:375) becomes the hand-written Hopper kernel
`vit_ad_tpu_torch/csrc/vit_attention_qkv.cu` (see its header for what bounds
it on the H100 and what the design does about it).

`vit_attention_qkv` launches that kernel for a CUDA tensor, and raises where it
cannot. For a CPU tensor it runs the plain PyTorch version
`vit_attention_qkv_reference`, the same math as the JAX package's
`_xla_packed_attention` (:427) / `_xla_plain_attention` (:485). Its backward
recomputes through the plain version, as the JAX custom VJP does (:445-455):
the TPU kernel had no backward kernel either.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

# Kernel launches made by `vit_attention_qkv` (a plain count, read by
# chip_smoke.py to show that the main path went through the kernel).
launches = 0

SUPPORTED_HEAD_DIMS = (32, 64)
MAX_TOKENS = 256
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _dims(qkv: torch.Tensor, num_heads: int) -> Tuple[int, int, int, int]:
    """(B, N, C, hd) of packed qkv [B, N, 3C], channel order [3][H][hd]."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % num_heads:
        raise ValueError(
            f"expected packed qkv [B, N, 3*C] with C divisible by num_heads="
            f"{num_heads}, got shape {tuple(qkv.shape)}"
        )
    b, n, c3 = qkv.shape
    return b, n, c3 // 3, c3 // 3 // num_heads


def _scale(head_dim: int, dtype: torch.dtype) -> torch.Tensor:
    """hd^-1/2 in the input dtype: JAX multiplies a bf16 q by the weakly
    typed Python float, which rounds the scale to bf16 first."""
    return torch.tensor(head_dim**-0.5, dtype=dtype)


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


def _launch(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    global launches
    from vit_ad_tpu_torch.ops.cuda.build import load_library

    b, n, c, hd = check_kernel_shape(qkv, num_heads)
    lib = load_library()
    qkv = qkv.contiguous()
    if qkv.data_ptr() % 16:  # the kernel reads 16 bytes at a time
        qkv = qkv.clone()
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = lib.vit_attention_qkv_forward(
        qkv.data_ptr(), out.data_ptr(), b, n, num_heads, hd,
        int(qkv.dtype == torch.bfloat16), _scale_value(hd, qkv.dtype),
        qkv.device.index if qkv.device.index is not None else torch.cuda.current_device(),
        stream,
    )
    if err:
        raise RuntimeError(f"vit_attention_qkv kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _forward(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    if qkv.device.type == "cuda":
        return _launch(qkv, num_heads)
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
    return _VitAttentionQKV.apply(qkv, num_heads)
