"""Port ViT/DeiT encoder (`vit_ad_tpu_torch/models/vit.py`) against the JAX
`ViTEncoder`, at the tiny size of tests/test_cross_framework.py (D=32,
IMG=32, patch 8, depth 2, 4 heads), with the same weights carried across by
`utils/convert.vit_state_dict_from_jax` and the same seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.models.vit import ViTEncoder as JaxViTEncoder
from vit_ad_tpu.utils.torch_convert import export_vit
from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.vit import ViTEncoder
from vit_ad_tpu_torch.utils.convert import vit_state_dict_from_jax

# The suite runs under pytest-xdist, several workers to a host, and every
# worker collects this module. Torch's default intra-op pool, one thread per
# core in each worker, oversubscribes the cores: alone, a ResNet-50 CLI test
# takes twice the CPU time at 8 threads that it takes at 2, for about the
# same wall time. Two threads a worker (a module that needs the default count
# sets DEFAULT_TORCH_THREADS back for its own tests).
DEFAULT_TORCH_THREADS = torch.get_num_threads()
torch.set_num_threads(min(2, DEFAULT_TORCH_THREADS))

D, IMG, PATCH, DEPTH, HEADS = 32, 32, 8, 2, 4
# f32: the same math, f32 sums in other orders through two blocks and three
# LayerNorms of unit-scale tokens.
ATOL_F32 = 1e-5
# bf16 policy (tanh GELU both sides): each side rounds the residual stream,
# the LN outputs and every GEMM output to bf16 (8-bit mantissa), at different
# points (XLA may keep f32 inside fusions), so tokens of magnitude ≤ 4 may
# differ by a few bf16 ulps (2^-6 each at 2..4) after two blocks.
ATOL_BF16 = 0.1


def jitter(tree, rng, scale):
    """Every leaf plus seeded noise, so zero biases and unit LN scales are
    exercised too."""
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + scale * rng.standard_normal(np.shape(a)).astype(np.float32), tree)


def jax_encoder(prefix: int, dtypes):
    return JaxViTEncoder(img_size=IMG, patch_size=PATCH, embed_dim=D, depth=DEPTH,
                         num_heads=HEADS, num_prefix_tokens=prefix, dtypes=dtypes)


def port_encoder(prefix: int, dtypes=None) -> ViTEncoder:
    return ViTEncoder(img_size=IMG, patch_size=PATCH, embed_dim=D, depth=DEPTH,
                      num_heads=HEADS, num_prefix_tokens=prefix,
                      dtypes=dtypes or DtypePolicy.f32())


def jax_params(prefix: int, seed: int = 0):
    enc = jax_encoder(prefix, JaxDtypePolicy.f32())
    # jitted: op by op, the init takes several times its compile
    params = jax.jit(enc.init)(jax.random.key(seed), jnp.zeros((1, IMG, IMG, 3)))
    return jitter(params, np.random.default_rng(seed), 0.05)


def _images(seed=1):
    return np.random.default_rng(seed).standard_normal((2, IMG, IMG, 3)).astype(np.float32)


@pytest.mark.parametrize("prefix", [2, 1], ids=["deit", "vit"])
@pytest.mark.parametrize("block_index", [0, 1])
def test_encoder_matches_jax_f32(prefix, block_index):
    params = jax_params(prefix)
    x = _images()
    want = jax_encoder(prefix, JaxDtypePolicy.f32()).apply(params, jnp.asarray(x),
                                                          block_index=block_index)
    enc = port_encoder(prefix)
    enc.load_state_dict(vit_state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = enc(torch.from_numpy(x), block_index=block_index)
    assert got.patch_embedding.shape == (2, (IMG // PATCH) ** 2, D)
    np.testing.assert_allclose(got.patch_embedding.numpy(),
                               np.asarray(want.patch_embedding), rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(got.latent.numpy(), np.asarray(want.latent),
                               rtol=0, atol=ATOL_F32)


def test_encoder_matches_jax_bf16_policy():
    params = jax_params(2, seed=3)
    x = _images(seed=4)
    want = jax_encoder(2, JaxDtypePolicy()).apply(params, jnp.asarray(x))
    enc = port_encoder(2, DtypePolicy())
    enc.load_state_dict(vit_state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = enc(torch.from_numpy(x))
    assert got.patch_embedding.dtype == torch.bfloat16
    np.testing.assert_allclose(got.patch_embedding.float().numpy(),
                               np.asarray(want.patch_embedding.astype(jnp.float32)),
                               rtol=0, atol=ATOL_BF16)


@pytest.mark.parametrize("prefix", [2, 1], ids=["deit", "vit"])
def test_export_vit_loads_strict_and_equals_port_conversion(prefix):
    params = jax_params(prefix, seed=5)
    exported = export_vit(params["params"])
    ours = vit_state_dict_from_jax(params)
    assert sorted(exported) == sorted(ours)
    for k, v in exported.items():
        assert np.array_equal(v, ours[k].numpy()), k
    enc = port_encoder(prefix)
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in exported.items()}, strict=True)
    assert sorted(enc.state_dict()) == sorted(exported)


def test_bf16_weight_casts_are_cached_until_a_parameter_changes():
    enc = port_encoder(2, DtypePolicy())
    x = torch.from_numpy(_images())
    with torch.inference_mode():
        enc(x)
        first = enc.compute_weights()
        assert enc.compute_weights() is first
        assert first["blocks"][0]["qkv_w"].dtype == torch.bfloat16
    with torch.no_grad():
        enc.blocks[0].attn.qkv.weight.mul_(2.0)
    with torch.inference_mode():
        again = enc.compute_weights()
    assert again is not first
    torch.testing.assert_close(again["blocks"][0]["qkv_w"],
                               (enc.blocks[0].attn.qkv.weight * 1).to(torch.bfloat16))


def test_seeded_init_is_deterministic_and_shaped_like_jax():
    a = port_encoder(2)
    b = ViTEncoder(img_size=IMG, patch_size=PATCH, embed_dim=D, depth=DEPTH,
                   num_heads=HEADS, num_prefix_tokens=2,
                   generator=torch.Generator().manual_seed(7))
    c = ViTEncoder(img_size=IMG, patch_size=PATCH, embed_dim=D, depth=DEPTH,
                   num_heads=HEADS, num_prefix_tokens=2,
                   generator=torch.Generator().manual_seed(7))
    for (k, vb), vc in zip(b.state_dict().items(), c.state_dict().values()):
        assert torch.equal(vb, vc), k
    assert sorted(a.state_dict()) == sorted(vit_state_dict_from_jax(jax_params(2)))
    assert b.pos_embed.abs().max() <= 0.04  # truncated at 2 std of 0.02
