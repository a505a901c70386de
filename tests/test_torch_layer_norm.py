"""The port's one-pass LayerNorm (`vit_ad_tpu_torch/ops/cuda/layer_norm.py`, on
the CPU: its plain version) and the `models/layers.LayerNorm` module against
the JAX package: the Pallas kernel `layer_norm_pallas` in interpret mode, the
XLA expression `_xla_layer_norm`, the custom VJP, and the flax module. Inputs
are seeded numpy arrays handed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.models.layers import LayerNorm as JaxLayerNorm
from vit_ad_tpu.ops.pallas import layer_norm as jln
from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.layers import LayerNorm
from vit_ad_tpu_torch.ops.cuda import layer_norm as ln

# f32: two reductions over D in other orders; outputs of magnitude <= ~6.
ATOL_F32 = 5e-6
# bf16 storage: both compute in f32 and round once; a last-bit f32 difference
# can flip that rounding: one bf16 ulp (2^-8 relative) of the output.
RTOL_BF16, ATOL_BF16 = 2.0**-7, 1e-3


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.standard_normal(shape) + 0.3).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    bias = (0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape,eps", [((16, 96), 1e-5), ((2, 8, 192), 1e-5), ((24, 100), 1e-6),
                                       ((2, 2, 2, 384), 1e-5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_pallas_kernel_and_xla(shape, eps, dtype):
    x, scale, bias = _inputs(0, shape)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    kernel = jln.layer_norm_pallas(jx, jnp.asarray(scale), jnp.asarray(bias), eps=eps,
                                   interpret=True)
    xla = jln._xla_layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias), eps)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ln.layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias), eps)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    for want in (kernel, xla):
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_F32)
        else:
            np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL_BF16,
                                       atol=ATOL_BF16)


def test_layer_norm_gradients_match_the_jax_custom_vjp():
    x, scale, bias = _inputs(1, (6, 96))
    g = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jln.layer_norm(*a, 1e-5) * jnp.asarray(g)),
                    argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    got = torch.autograd.grad(ln.layer_norm(*ins, 1e-5), ins, torch.from_numpy(g))
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_layer_norm_module_matches_the_jax_module(fused, policy):
    """`models/layers.LayerNorm` (f32 statistics, cast to the compute dtype),
    default and fused path, against the JAX module's default path."""
    x, scale, bias = _inputs(3, (2, 5, 64))
    jpol = JaxDtypePolicy.f32() if policy == "f32" else JaxDtypePolicy()
    pol = DtypePolicy.f32() if policy == "f32" else DtypePolicy()
    jx = jnp.asarray(x).astype(jpol.compute_dtype)
    params = {"params": {"LayerNorm_0": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}}
    want = JaxLayerNorm(dtypes=jpol, eps=1e-5).apply(params, jx)
    mod = LayerNorm(64, eps=1e-5, dtypes=pol, fused=fused)
    mod.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)},
                        strict=True)
    got = mod(torch.from_numpy(x).to(pol.compute_dtype))
    assert got.dtype == pol.compute_dtype
    want = np.asarray(want.astype(jnp.float32))
    if policy == "f32":
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL_F32)
    else:
        np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=RTOL_BF16,
                                   atol=ATOL_BF16)


def test_fused_and_default_paths_agree_and_keep_f32_statistics():
    """A bf16 row with a large common offset: both paths take the statistics
    in f32, so the centred values survive."""
    x, scale, bias = _inputs(4, (8, 96))
    tx = torch.from_numpy(x + 200.0).bfloat16()
    outs = []
    for fused in (False, True):
        mod = LayerNorm(96, eps=1e-5, dtypes=DtypePolicy(), fused=fused)
        mod.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
        outs.append(mod(tx).detach())
        assert outs[-1].dtype == torch.bfloat16
    torch.testing.assert_close(outs[1].float(), outs[0].float(), rtol=RTOL_BF16, atol=ATOL_BF16)
    assert outs[0].float().std() > 0.5


@pytest.mark.parametrize("bad", ["dtype", "width", "params", "empty"])
def test_kernel_shape_check_refuses(bad):
    x = torch.zeros(4, 96)
    s = torch.ones(96)
    with pytest.raises((TypeError, ValueError)):
        if bad == "dtype":
            ln.check_kernel_shape(x.half(), s, s)
        elif bad == "width":
            ln.check_kernel_shape(torch.zeros(2, ln.MAX_DIM + 8), torch.ones(ln.MAX_DIM + 8),
                                  torch.ones(ln.MAX_DIM + 8))
        elif bad == "params":
            ln.check_kernel_shape(x, s[:95], s)
        else:
            ln.check_kernel_shape(x[:0], s, s)
    assert ln.check_kernel_shape(x, s, s) == 96
