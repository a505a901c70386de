"""Operand rounding for the reference and for its lower-precision control.

The reference computes every product in float32 with TF32 off. The control
is the same code with each product's operands rounded one precision below
what the configuration states for that product: float8 (e4m3, one scale per
tensor, as an fp8 inference path scales) where the configuration states
bfloat16, bfloat16 where it states float32. The products then run in float32
on the rounded values, which is what a tensor core does with them.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def set_f32_numerics() -> None:
    """Full float32 products: no TF32 in matmuls or cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_to(t: torch.Tensor, kind: str) -> torch.Tensor:
    """`t` as float32 holding values of `kind`: "f32" (unchanged), "bf16",
    or "fp8" (scaled so that the largest magnitude maps to 448)."""
    t = t.float()
    if kind == "f32":
        return t
    if kind == "bf16":
        return t.to(torch.bfloat16).float()
    if kind == "fp8":
        amax = t.detach().abs().amax().clamp(min=1e-30)
        scale = amax / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {kind!r}")


LOWER = {"float32": "bf16", "bfloat16": "fp8"}


def product_precision(stated: str, control: bool) -> str:
    """The operand precision of a product the configuration states in
    `stated` ("float32" or "bfloat16"): f32 for the reference, one step
    lower for the control."""
    if stated not in LOWER:
        raise ValueError(f"no rule for stated precision {stated!r}")
    return LOWER[stated] if control else "f32"
