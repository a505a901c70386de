"""Port bilinear resize (`vit_ad_tpu_torch/ops/resize.py`) against the JAX
`interpolate_bilinear`, both align_corners modes, up and down, [B,H,W] and
[B,H,W,C]."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ad_tpu.ops.resize import interpolate_bilinear as jax_resize
from vit_ad_tpu_torch.ops.resize import interpolate_bilinear

# f32: the same two-tap blend; the blend weights are computed in f32 by
# torch and in f64-then-f32 by the JAX version, so a few f32 ulps of unit
# values.
ATOL = 2e-6


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", [((4, 4), (16, 16)), ((14, 14), (224, 224)),
                                          ((16, 12), (5, 7)), ((7, 7), (7, 7))],
                         ids=["up4", "flagship", "down", "same"])
@pytest.mark.parametrize("channels", [None, 3])
def test_resize_matches_jax(align_corners, in_hw, out_hw, channels):
    shape = (2, *in_hw) + ((channels,) if channels else ())
    x = np.random.default_rng(0).random(shape, dtype=np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), *out_hw, align_corners=align_corners))
    got = interpolate_bilinear(torch.from_numpy(x), *out_hw, align_corners=align_corners)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_integer_input_resizes_in_f32():
    x = np.random.default_rng(1).integers(0, 255, (1, 5, 5), dtype=np.uint8)
    got = interpolate_bilinear(torch.from_numpy(x), 9, 9)
    assert got.dtype == torch.float32
    want = np.asarray(jax_resize(jnp.asarray(x), 9, 9))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
