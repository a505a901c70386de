"""The port's SSIM (`vit_ad_tpu_torch/ops/ssim.py`) against the JAX
`ssim_per_image`: values, the masked batch mean the SSIM loss takes, and the
gradient the loss backpropagates, on seeded NCHW/NHWC pairs. f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ad_tpu.ops import ssim as jssim
from vit_ad_tpu_torch.ops import ssim as pssim

# f32: the same separable blur and moment algebra, sums in other orders; SSIM
# values are at most 1. Gradients relative to their largest entry.
ATOL, GRAD_RTOL = 1e-6, 1e-5


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    y = np.clip(x + 0.2 * rng.standard_normal(shape), -1, 2).astype(np.float32)
    return x, y


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def test_gaussian_kernel_matches_jax():
    np.testing.assert_array_equal(pssim.gaussian_kernel_1d(11, 1.5),
                                  jssim._gaussian_kernel_1d(11, 1.5))


@pytest.mark.parametrize("shape", [(3, 32, 32, 3), (2, 11, 17, 1), (2, 40, 24, 3)])
def test_ssim_per_image_matches_jax(shape):
    """Square and rectangular maps down to one valid window (11 rows)."""
    x, y = _pair(shape, 0)
    want = np.asarray(jssim.ssim_per_image(jnp.asarray(x), jnp.asarray(y)))
    got = pssim.ssim_per_image(_nchw(x), _nchw(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    same = pssim.ssim_per_image(_nchw(x), _nchw(x)).numpy()
    np.testing.assert_allclose(same, 1.0, rtol=0, atol=ATOL)


def test_masked_mean_and_gradient_match_jax():
    """The loss term of `train_recon` (1 - the masked mean over the valid
    rows; the padded last row excluded) and its gradient w.r.t. the
    reconstruction."""
    x, y = _pair((4, 24, 24, 3), 1)
    valid = np.array([1, 1, 1, 0], np.float32)

    def jloss(p):
        s = jssim.ssim_per_image(p, jnp.asarray(y))
        return 1.0 - jnp.sum(s * valid) / jnp.maximum(jnp.sum(valid), 1.0)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(x))
    p = _nchw(x).requires_grad_(True)
    s = pssim.ssim_per_image(p, _nchw(y))
    v = torch.from_numpy(valid)
    got = 1.0 - torch.sum(s * v) / torch.clamp(torch.sum(v), min=1.0)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=ATOL)
    g = p.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(g, np.asarray(want_g), rtol=0,
                               atol=GRAD_RTOL * np.abs(np.asarray(want_g)).max())
    assert not g[3].any()  # the padded row takes no gradient
