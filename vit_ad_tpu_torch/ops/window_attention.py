"""(Shifted-)window multi-head self-attention: the plain PyTorch side.

Port of `vit_ad_tpu/ops/window_attention.py`: `window_partition` (:33) and
`window_reverse` (:41) as reshapes, `relative_position_index` (:83) and
`shift_attention_mask` (:98) built once in numpy, and the plain versions of
the two window-attention kernels of `csrc/swin_window_attention.cu`:

  * `window_attention_reference` — packed qkv windows, the math of the TPU
    kernel `ops/pallas/window_attention.py::_kernel_win` (:212): the
    UNNORMALISED exp(s - max) is rounded to the input dtype before PV and the
    f32 PV is multiplied by the reciprocal row sum;
  * `window_attention_core_reference` — split q, k, v, the math of `_kernel`
    (:46) and of `window_attention_core` (:117): the normalised probabilities
    are rounded before PV.

Under f32 the two agree to summation order. `partition_perm` (:51), the
gather partition, is an opt-in lever of the JAX package and is not ported.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] → [B*nW, window*window, C]; windows are the minor axis
    of the batch (window b of image i is row i*nW + b)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(windows: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """[B*nW, window*window, C] → [B, H, W, C]."""
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // window // window)
    x = windows.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


@lru_cache(maxsize=None)
def relative_position_index(window_h: int, window_w: int) -> np.ndarray:
    """[N, N] int64 indices into the (2Wh-1)(2Ww-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(window_h), np.arange(window_w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window_h - 1
    rel[:, :, 1] += window_w - 1
    rel[:, :, 0] *= 2 * window_w - 1
    return rel.sum(-1)


@lru_cache(maxsize=None)
def shift_attention_mask(hp: int, wp: int, window: int, shift: int) -> Optional[np.ndarray]:
    """[nW, N, N] f32 additive mask (0 / -100) of the shifted windows of a
    padded hp x wp map, or None when shift == 0."""
    if shift == 0:
        return None
    img_mask = np.zeros((1, hp, wp, 1), dtype=np.float32)
    cnt = 0
    for h_sl in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for w_sl in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img_mask[:, h_sl, w_sl, :] = cnt
            cnt += 1
    m = img_mask.reshape(1, hp // window, window, wp // window, window, 1)
    m = m.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window * window)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def attention_scale(head_dim: int, dtype: torch.dtype) -> torch.Tensor:
    """hd^-1/2 in the input dtype: JAX multiplies a bf16 q by the weakly
    typed Python float, which rounds the scale to bf16 first."""
    return torch.tensor(head_dim**-0.5, dtype=dtype)


def gather_bias(bias_table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Relative-position bias [(2W-1)^2, H] gathered by `index` [N, N] →
    [H, N, N] f32 (`swin_attention_windows` :343-345)."""
    n = index.shape[0]
    bias = bias_table[index.reshape(-1)].reshape(n, n, -1)
    return bias.permute(2, 0, 1).float().contiguous()


def _scores(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 scores [B_, H, N, N] of q, k [B_, H, N, hd]: (q·scale) kᵀ with
    q·scale rounded to the input dtype, plus bias [H, N, N], plus
    mask [n_w, N, N] of window b % n_w."""
    q = q * attention_scale(q.shape[-1], q.dtype).to(q.device)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias.float()
    if mask is not None:
        b_, h, n, _ = s.shape
        n_w = mask.shape[0]
        s = (s.reshape(b_ // n_w, n_w, h, n, n) + mask.float()[None, :, None]).reshape(b_, h, n, n)
    return s


def split_packed(qkv3: torch.Tensor, num_heads: int) -> Tuple[torch.Tensor, ...]:
    """Packed [B_, N, 3C], channel order [3][H][hd] → q, k, v [B_, H, N, hd]."""
    if qkv3.dim() != 3 or qkv3.shape[-1] % 3 or (qkv3.shape[-1] // 3) % num_heads:
        raise ValueError(f"expected packed qkv windows [B_, N, 3*C] with C divisible by "
                         f"num_heads={num_heads}, got shape {tuple(qkv3.shape)}")
    b_, n, c3 = qkv3.shape
    return qkv3.reshape(b_, n, 3, num_heads, c3 // 3 // num_heads).permute(2, 0, 3, 1, 4)


def window_attention_reference(qkv3: torch.Tensor, bias: torch.Tensor,
                               mask: Optional[torch.Tensor], num_heads: int) -> torch.Tensor:
    """Plain window attention from packed qkv windows [B_, N, 3C] → [B_, N, C]
    with bias [H, N, N] f32 and mask [n_w, N, N] f32 or None: f32 scores, e =
    exp(s - max) rounded to the input dtype, f32 PV, times 1 / sum(e) (the
    f32 sum of the unrounded e), stored in the input dtype."""
    q, k, v = split_packed(qkv3, num_heads)
    s = _scores(q, k, bias, mask)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    recip = 1.0 / e.sum(dim=-1, keepdim=True)
    # bf16 x bf16 products are exact in f32: the tensor cores' arithmetic
    pv = torch.matmul(e.to(qkv3.dtype).float(), v.float())
    out = (pv * recip).to(qkv3.dtype)  # [B_, H, N, hd]
    b_, n, c3 = qkv3.shape
    return out.transpose(1, 2).reshape(b_, n, c3 // 3)


def window_attention_core_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    bias: torch.Tensor, mask: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """Plain window attention from split q, k, v [B_, N, H, hd] → [B_, N, H*hd]:
    f32 scores and softmax, the normalised probabilities rounded to the input
    dtype, PV in the input dtype (f32 accumulation)."""
    b_, n, h, hd = q.shape
    s = _scores(q.transpose(1, 2), k.transpose(1, 2), bias, mask)
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v.transpose(1, 2))  # [B_, H, N, hd]
    return out.transpose(1, 2).reshape(b_, n, h * hd)
