"""Port Swin trunk (`vit_ad_tpu_torch/models/swin.py`) against the JAX
`SwinTransformer` at a tiny size (embed 32, depths 2/2, heads 1/2, window 7):
56 px (a 14x14 map: stage 0 shifts, stage 1 clamps its window to 7) and 40 px
(a 10x10 map padded to 14x14, stage 1 clamped to 5), with the same weights
carried across by `utils/convert.swin_state_dict_from_jax` and the same seeded
inputs; the checkpoint surgery against the JAX `convert_swin`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vit import jitter
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.models.swin import SwinTransformer as JaxSwin
from vit_ad_tpu.utils import torch_convert
from vit_ad_tpu_torch import registry
from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.swin import EsViTEncoder, SwinTransformer
from vit_ad_tpu_torch.ops.cuda import layer_norm as cln
from vit_ad_tpu_torch.ops.cuda import window_attention as cwa
from vit_ad_tpu_torch.pipeline.loading import load_encoder_checkpoint
from vit_ad_tpu_torch.utils.convert import interpolate_rel_pos_table, swin_state_dict_from_jax

CFG = dict(patch_size=4, embed_dim=32, depths=(2, 2), num_heads=(1, 2), window=7)
# f32: the same math, f32 sums in other orders through four blocks, a merge
# and eight LayerNorms of unit-scale tokens.
ATOL_F32 = 2e-5
# bf16 policy (tanh GELU both sides): each side rounds the residual stream,
# the LN outputs and every GEMM output to bf16 at different points (XLA may
# keep f32 inside fusions); after the final LayerNorm the tokens have unit
# scale and may differ by a few bf16 ulps (2^-7 at 1..2).
ATOL_BF16 = 0.1


def jax_swin(img, dtypes):
    return JaxSwin(img_size=img, **CFG, dtypes=dtypes)


def port_swin(img, dtypes=None, fused_ln=False, generator=None):
    return SwinTransformer(img_size=img, **CFG, dtypes=dtypes or DtypePolicy.f32(),
                           fused_ln=fused_ln, generator=generator)


def jax_params(img, seed=0):
    # jitted: op by op, the init takes several times its compile
    params = jax.jit(jax_swin(img, JaxDtypePolicy.f32()).init)(jax.random.key(seed),
                                                               jnp.zeros((1, img, img, 3)))
    return jitter(params, np.random.default_rng(seed), 0.05)


def _images(img, seed=1):
    return np.random.default_rng(seed).standard_normal((2, img, img, 3)).astype(np.float32)


@pytest.mark.parametrize("img", [56, 40], ids=["shift_and_clamp", "padded"])
@pytest.mark.parametrize("fused_ln", [False, True], ids=["ln", "fused_ln"])
def test_swin_matches_jax_f32(img, fused_ln):
    params, x = jax_params(img), _images(img)
    want = jax_swin(img, JaxDtypePolicy.f32()).apply(params, jnp.asarray(x))
    enc = port_swin(img, fused_ln=fused_ln)
    enc.load_state_dict(swin_state_dict_from_jax(params), strict=True)
    before = (cwa.window_launches, cln.launches)
    with torch.inference_mode():
        got = enc(torch.from_numpy(x))
    side = img // 8
    assert got.patch_embedding.shape == (2, side * side, 64) == (2, enc.num_patches,
                                                                 enc.embed_dim)
    np.testing.assert_allclose(got.patch_embedding.numpy(), np.asarray(want.patch_embedding),
                               rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(got.latent.numpy(), np.asarray(want.latent), rtol=0,
                               atol=ATOL_F32)
    # on CPU tensors the wrappers take their plain versions: no launch is counted
    assert (cwa.window_launches, cln.launches) == before


def test_swin_stage_geometry():
    enc = port_swin(56)
    assert [(s.window, s.shift) for s in enc.layers] == [(7, 3), (7, 0)]
    assert [b.shift for b in enc.layers[0].blocks] == [0, 3]
    assert enc.layers[0].attn_mask.shape == (4, 49, 49) and enc.layers[1].attn_mask is None
    assert "layers.0.attn_mask" not in enc.state_dict()
    padded = port_swin(40)
    assert [(s.window, s.shift) for s in padded.layers] == [(7, 3), (5, 0)]
    assert padded.layers[0].attn_mask.shape == (4, 49, 49)  # 10x10 padded to 14x14
    assert padded.layers[1].blocks[0].attn.relative_position_bias_table.shape == (81, 2)


def test_swin_matches_jax_bf16_policy():
    params, x = jax_params(56, seed=3), _images(56, seed=4)
    want = jax_swin(56, JaxDtypePolicy()).apply(params, jnp.asarray(x))
    for fused_ln in (False, True):
        enc = port_swin(56, DtypePolicy(), fused_ln=fused_ln)
        enc.load_state_dict(swin_state_dict_from_jax(params), strict=True)
        with torch.inference_mode():
            got = enc(torch.from_numpy(x))
        assert got.patch_embedding.dtype == torch.bfloat16
        np.testing.assert_allclose(got.patch_embedding.float().numpy(),
                                   np.asarray(want.patch_embedding.astype(jnp.float32)),
                                   rtol=0, atol=ATOL_BF16)


@pytest.mark.parametrize("wrapped", ["params", "esvit", "bare"])
def test_export_swin_loads_strict_and_equals_port_conversion(wrapped):
    params = jax_params(56, seed=5)
    exported = torch_convert.export_swin(params["params"])
    tree = {"params": params, "esvit": {"params": {"esvit": params["params"]}},
            "bare": params["params"]}[wrapped]
    ours = swin_state_dict_from_jax(tree)
    assert sorted(exported) == sorted(ours)
    for k, v in exported.items():
        assert np.array_equal(v, ours[k].numpy()), k
    enc = port_swin(56)
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in exported.items()}, strict=True)
    assert sorted(enc.state_dict()) == sorted(exported)
    assert enc.state_dict()["layers.0.blocks.1.attn.relative_position_index"].dtype == torch.int64


@pytest.mark.parametrize("src,dst", [(14, 7), (7, 5), (7, 7), (5, 7)])
def test_interpolate_rel_pos_table_equals_jax(src, dst):
    table = np.random.default_rng(6).standard_normal(((2 * src - 1) ** 2, 3)).astype(np.float32)
    got = interpolate_rel_pos_table(table, src, dst)
    want = torch_convert.interpolate_rel_pos_table(table, src, dst)
    assert got.shape == ((2 * dst - 1) ** 2, 3) and got.dtype == np.float32
    assert np.array_equal(got, want)


def test_checkpoint_surgery_matches_jax_convert_swin(tmp_path):
    """An EsViT-style `.pth` as the reference publishes it: `module.` prefix,
    a classifier head, cached `attn_mask` buffers, and stage-1 bias tables
    saved at the model's nominal window 7 although the 40-px model runs that
    stage at window 5. The port's loader and the JAX `convert_swin` must
    build the same encoder."""
    img = 40
    sd = torch_convert.export_swin(jax_params(56, seed=7)["params"])  # tables at window 7
    raw = {f"module.{k}": torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    raw["module.head.weight"] = torch.zeros(10, 64)
    raw["module.head.bias"] = torch.zeros(10)
    raw["module.layers.0.blocks.1.attn_mask"] = torch.zeros(4, 49, 49)
    raw["module.layers.1.blocks.0.attn.relative_position_index"] = torch.zeros(49, 49,
                                                                               dtype=torch.long)
    path = tmp_path / "esvit_tiny.pth"
    torch.save({"model": raw}, path)

    want_params = torch_convert.convert_swin({k: v.numpy() for k, v in raw.items()},
                                             img_size=img, patch_size=4, depths=(2, 2), window=7)
    x = _images(img, seed=8)
    want = jax_swin(img, JaxDtypePolicy.f32()).apply(
        {"params": want_params["params"]["esvit"]}, jnp.asarray(x))
    enc = load_encoder_checkpoint(port_swin(img), str(path))
    table = enc.layers[1].blocks[0].attn.relative_position_bias_table
    assert table.shape == (81, 2)
    np.testing.assert_array_equal(
        table.detach().numpy(),
        np.asarray(want_params["params"]["esvit"]["layer1"]["a_bias_table"][0]))
    assert torch.equal(enc.layers[1].blocks[0].attn.relative_position_index,
                       port_swin(img).layers[1].blocks[0].attn.relative_position_index)
    with torch.inference_mode():
        got = enc(torch.from_numpy(x))
    np.testing.assert_allclose(got.patch_embedding.numpy(), np.asarray(want.patch_embedding),
                               rtol=0, atol=ATOL_F32)


def test_weight_and_bias_caches_follow_the_parameters():
    enc = port_swin(56, DtypePolicy())
    x = torch.from_numpy(_images(56))
    with torch.inference_mode():
        first_out = enc(x).patch_embedding
        first = enc.compute_weights()
        assert enc.compute_weights() is first
    blk = first["stages"][0]["blocks"][1]
    assert blk["qkv_w"].dtype == torch.bfloat16
    assert blk["bias"].shape == (1, 49, 49) and blk["bias"].dtype == torch.float32
    sd = {k: v.clone() for k, v in enc.state_dict().items()}
    sd["layers.0.blocks.1.attn.relative_position_bias_table"] += 1.0 * torch.arange(169.0)[:, None]
    enc.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        again = enc.compute_weights()
        out = enc(x).patch_embedding
    assert again is not first
    assert not torch.equal(again["stages"][0]["blocks"][1]["bias"], blk["bias"])
    assert not torch.equal(out, first_out)
    # while gradients flow to the parameters nothing is cached
    assert enc.compute_weights() is not enc.compute_weights()


def test_seeded_init_is_deterministic_and_shaped_like_jax():
    b = port_swin(56, generator=torch.Generator().manual_seed(7))
    c = port_swin(56, generator=torch.Generator().manual_seed(7))
    for (k, vb), vc in zip(b.state_dict().items(), c.state_dict().values()):
        assert torch.equal(vb, vc), k
    ref = swin_state_dict_from_jax(jax_params(56))
    assert {k: tuple(v.shape) for k, v in b.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert b.layers[0].blocks[0].attn.relative_position_bias_table.abs().max() <= 0.04


def test_registry_builds_the_esvit_swin_tiny():
    enc = registry.get_model("enc_esvit", generator=torch.Generator().manual_seed(0),
                             fused_ln=True)
    assert isinstance(enc, EsViTEncoder) and enc.fused_ln
    assert (enc.embed_dim, enc.num_patches, enc.stem_dim) == (768, 49, 96)
    assert [(s.window, s.shift, len(s.blocks)) for s in enc.layers] == \
        [(14, 7, 2), (14, 7, 2), (14, 0, 6), (7, 0, 2)]
    assert [s.blocks[0].num_heads for s in enc.layers] == [3, 6, 12, 24]
    sd = enc.state_dict()
    assert sd["layers.3.blocks.1.attn.relative_position_bias_table"].shape == (169, 24)
    assert sd["layers.2.downsample.reduction.weight"].shape == (768, 1536)
    assert "layers.0.attn_mask" not in sd and sd["norm.weight"].shape == (768,)
    assert enc.layers[0].attn_mask.shape == (16, 196, 196)
    assert enc.layers[2].attn_mask is None
    with pytest.raises(ValueError, match="fused"):
        registry.get_model("enc_deit", fused_ln=True)
