"""Port NesT trunk (`vit_ad_tpu_torch/models/nest.py`) against the JAX `NesT`
at a small size with more than one head per level (dims 64/128/256, heads
2/4/8 — head dim 32, as NesT-T's —, depths 1/1/2, 64 px: levels of 16, 4 and
1 blocks of 4x4 tokens), with the same weights carried across by
`utils/convert.nest_state_dict_from_jax` and the same seeded inputs; the
converted dict against `export_nest`, the head merge against timm's order,
`ae_nest_small` through `recon_state_dict_from_jax`, and a train_nf → score
round trip through the CLIs on a tiny NesT."""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vit import jitter
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.models.autoencoder import TransformerAutoEncoder as JaxTransformerAE
from vit_ad_tpu.models.nest import NesT as JaxNesT
from vit_ad_tpu.utils import torch_convert
from vit_ad_tpu_torch import registry
from vit_ad_tpu_torch.cli import score as score_cli
from vit_ad_tpu_torch.cli import train_nf as train_nf_cli
from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.data import synthetic
from vit_ad_tpu_torch.data.dataset import default_norm_stats
from vit_ad_tpu_torch.data.loader import DataPipeline
from vit_ad_tpu_torch.models import nest as pnest
from vit_ad_tpu_torch.models.autoencoder import TransformerAutoEncoder
from vit_ad_tpu_torch.ops.cuda import layer_norm as cln
from vit_ad_tpu_torch.ops.cuda import window_attention as cwa
from vit_ad_tpu_torch.pipeline.eval import score_nf
from vit_ad_tpu_torch.pipeline.loading import (
    _load_recon_model,
    build_pth_models,
    load_encoder_checkpoint,
)
from vit_ad_tpu_torch.utils.convert import nest_state_dict_from_jax, recon_state_dict_from_jax

IMG = 64
CFG = dict(embed_dims=(64, 128, 256), num_heads=(2, 4, 8), depths=(1, 1, 2))
# f32: the same math, f32 sums in other orders through four blocks, two pools
# and nine LayerNorms of unit-scale tokens (measured ~4e-6 on tokens of
# magnitude up to ~4).
ATOL_F32 = 2e-5
# the reconstruction through the small decoder: a few more f32 sums (measured
# ~2e-6 on outputs of magnitude ~1)
ATOL_RECON = 1e-5
CLI_IMG, NF_STEPS, NF_RATIO = 32, 2, 0.5  # the tiny NesT of the CLI run: 2x2 tokens


def port_nest(img=IMG, dtypes=None, fused_ln=False, generator=None, **cfg):
    return pnest.NesT(img_size=img, **(cfg or CFG), dtypes=dtypes or DtypePolicy.f32(),
                      fused_ln=fused_ln, generator=generator)


def _images(img=IMG, seed=1):
    return np.random.default_rng(seed).standard_normal((2, img, img, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_run():
    """One JAX `ae_nest_small` (the small NesT + SmallDecoder) with jittered
    f32 variables, its forward and its trunk's forward on the same images:
    the trunk's params are the AE's encoder params."""
    f32 = JaxDtypePolicy.f32()
    ae = JaxTransformerAE(encoder=JaxNesT(img_size=IMG, **CFG, dtypes=f32), decoder_kind="cnn",
                          img_size=IMG, dtypes=f32)
    # jitted: op by op, the JAX NesT takes several times its compile
    variables = jax.tree.map(np.asarray, jax.jit(ae.init)(jax.random.key(0),
                                                          jnp.zeros((1, IMG, IMG, 3))))
    # every leaf moved a little (the decoder's BatchNorm variances stay positive)
    variables = jitter(variables, np.random.default_rng(0), 0.05)
    x = _images()
    params = {"params": variables["params"]["encoder"]}
    trunk = jax.jit(JaxNesT(img_size=IMG, **CFG, dtypes=f32).apply)(params, jnp.asarray(x))
    recon = jax.jit(ae.apply)(variables, jnp.asarray(x))
    return {"variables": variables, "params": params, "x": x,
            "tokens": np.asarray(trunk.patch_embedding), "latent": np.asarray(trunk.latent),
            "recon": np.asarray(recon.reconstruction), "ae_latent": np.asarray(recon.latent)}


@pytest.mark.parametrize("fused_ln", [False, True], ids=["ln", "fused_ln"])
def test_nest_matches_jax_f32(jax_run, fused_ln):
    enc = port_nest(fused_ln=fused_ln)
    enc.load_state_dict(nest_state_dict_from_jax(jax_run["params"], CFG["num_heads"]),
                        strict=True)
    before = (cwa.launches, cln.launches)
    with torch.inference_mode():
        got = enc(torch.from_numpy(jax_run["x"]))
    assert got.patch_embedding.shape == (2, 16, 256) == (2, enc.num_patches, enc.embed_dim)
    np.testing.assert_allclose(got.patch_embedding.numpy(), jax_run["tokens"], rtol=0,
                               atol=ATOL_F32)
    np.testing.assert_allclose(got.latent.numpy(), jax_run["latent"], rtol=0, atol=ATOL_F32)
    # on CPU tensors the wrappers take their plain versions: no launch is counted
    assert (cwa.launches, cln.launches) == before


def test_nest_state_dict_equals_export_nest(jax_run, tmp_path):
    """Key for key and value for value `export_nest` (whose zeroed `head` the
    trunk does not hold), strict loads both ways, and
    `load_encoder_checkpoint` reads the exported file, head and all."""
    exported = torch_convert.export_nest(jax_run["params"]["params"], num_heads=CFG["num_heads"])
    ours = nest_state_dict_from_jax(jax_run["params"], CFG["num_heads"])
    assert sorted(ours) == sorted(k for k in exported if not k.startswith("head."))
    for k, v in ours.items():
        assert np.array_equal(exported[k], v.numpy()), k
    enc = port_nest()
    assert sorted(enc.state_dict()) == sorted(ours)
    path = tmp_path / "jx_nest_toy.pth"
    torch.save({k: torch.from_numpy(v) for k, v in exported.items()}, path)
    load_encoder_checkpoint(enc, str(path))
    for k, v in enc.state_dict().items():
        assert torch.equal(v, ours[k]), k


def test_head_merge_follows_timm_order():
    """A timm NesT attention merges its heads as (head_dim, heads) before
    `attn.proj`; the port's cached proj weight, on the kernel's (heads,
    head_dim) output, gives the same result. Three heads of 4 channels: a
    single head or hd = 1 would hide a wrong permutation."""
    gen = torch.Generator().manual_seed(3)
    b, n, heads, hd = 2, 5, 3, 4
    c = heads * hd
    blk = pnest.NestBlock(c, heads, 4.0, DtypePolicy.f32(), fused_ln=False)
    for p in blk.parameters():
        torch.nn.init.normal_(p, generator=gen)
    qkv = torch.randn(b, n, 3 * c, generator=gen)
    q, k, v = qkv.reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    attn = torch.softmax(q * hd**-0.5 @ k.transpose(-1, -2), dim=-1)
    timm_merge = (attn @ v).permute(0, 2, 3, 1).reshape(b, n, c)  # (hd, heads) channels
    want = torch.nn.functional.linear(timm_merge, blk.attn.proj.weight)
    heads_first = cwa.vit_attention_qkv(qkv, heads)  # (heads, hd) channels
    got = torch.nn.functional.linear(heads_first,
                                     pnest._proj_heads_first(blk.attn.proj.weight, heads))
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0, atol=1e-5)


def test_nest_tiny_geometry():
    """NesT-T at 224 px: blocks of 14x14 tokens on 56/28/14 maps (16, 4, 1
    blocks), 196 output tokens of 384 channels, 12 blocks, 27 LayerNorms, all
    on the fused path by default. Built on the meta device."""
    with torch.device("meta"):
        enc = registry.get_model("enc_nest")
    assert (enc.block, enc.num_patches, enc.embed_dim) == (14, 196, 384)
    assert [tuple(lv.pos_embed.shape) for lv in enc.levels] == [
        (1, 16, 196, 96), (1, 4, 196, 192), (1, 1, 196, 384)]
    assert [len(lv.transformer_encoder) for lv in enc.levels] == [2, 2, 8]
    assert [lv.transformer_encoder[0].num_heads for lv in enc.levels] == [3, 6, 12]
    norms = [m for m in enc.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == 27 and all(m.fused for m in norms) and pnest.FUSED_LN_DEFAULT
    assert enc.levels[0].pool is None and enc.levels[1].pool.conv.weight.shape == (192, 96, 3, 3)


def test_ae_nest_small_matches_jax(jax_run, tmp_path):
    """`ae_nest_small` through `recon_state_dict_from_jax`: the keys and
    values of `export_transformer_ae` (trunk under `encoder.nest.` with its
    zeroed head), a strict load, the reconstruction of the JAX AE, and the
    exported file read back by the recon loader of `cli.score -a recon`."""
    variables = jax_run["variables"]
    sd = recon_state_dict_from_jax(variables, nest_num_heads=CFG["num_heads"])
    exported = torch_convert.export_transformer_ae(variables, nest_num_heads=CFG["num_heads"])
    assert sorted(sd) == sorted(exported)
    for k, v in exported.items():
        assert np.array_equal(np.asarray(v), sd[k].numpy()), k
    ae = TransformerAutoEncoder(port_nest(), "cnn", IMG, DtypePolicy.f32())
    assert ae.family == "nest"
    ae.load_state_dict(sd, strict=True)
    ae.eval()
    with torch.inference_mode():
        out = ae(torch.from_numpy(jax_run["x"]))
    np.testing.assert_allclose(out.latent.numpy(), jax_run["ae_latent"], rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(out.reconstruction.numpy(), jax_run["recon"], rtol=0,
                               atol=ATOL_RECON)
    path = tmp_path / "ae_nest_small_widget.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in exported.items()}, path)
    loaded = _load_recon_model(TransformerAutoEncoder(port_nest(), "cnn", IMG, DtypePolicy.f32()),
                               str(path), "")
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k


def _tiny_port_nest(img_size=CLI_IMG, dtypes=None, generator=None, fused_ln=None):
    # the registry entry the CLIs call, pinned to a tiny f32 NesT at 32 px
    return pnest.NesT(img_size=CLI_IMG, embed_dims=(32, 64, 64), num_heads=(1, 2, 2),
                      depths=(1, 1, 1), dtypes=DtypePolicy.f32(), fused_ln=fused_ln,
                      generator=generator)


def test_cli_train_nf_then_score_round_trip_nest(tmp_path, monkeypatch):
    """`cli.train_nf -m nest --fused-ln`, then `cli.score -a nf -m enc_nest`
    on its head: one finite score per image, in input order, equal to the
    scorer's on the models `build_pth_models` rebuilds."""
    monkeypatch.setitem(registry._BUILDERS, "enc_nest", _tiny_port_nest)
    category = synthetic.make_mvtec_category(str(tmp_path / "data"), "widget", img_size=CLI_IMG,
                                             n_train=12, n_test_good=3, n_test_defect=3)
    out = tmp_path / "run"
    rc = train_nf_cli.main(["-m", "nest", "-d", category, "-t", "train/good", "-v", "test",
                            "-e", "2", "-p", "2", "-b", "8", "-i", str(CLI_IMG), "-r",
                            str(NF_RATIO), "-f", str(NF_STEPS), "--device", "cpu",
                            "--out", str(out), "--fused-ln"])
    assert rc == 0
    hist = json.loads((out / "history.json").read_text())
    assert len(hist["train_loss"]) == 2 and "image_auroc_score" in hist["metrics"]
    (pth,) = sorted(out.glob("nf_enc_nest_*.pth"))
    test_dir = os.path.join(category, "test")
    scored = tmp_path / "scores"
    rc = score_cli.main(["--pth", str(pth), "-a", "nf", "-m", "enc_nest", "-d", test_dir,
                         "-b", "8", "-i", str(CLI_IMG), "-f", str(NF_STEPS), "--hidden-ratio",
                         str(NF_RATIO), "-o", str(scored), "--device", "cpu", "--fused-ln"])
    assert rc == 0
    with open(scored / "scores.csv") as f:
        rows = list(csv.reader(f))[1:]
    imgs = score_cli.list_images(test_dir)
    assert [row[0] for row in rows] == imgs
    m = build_pth_models(str(pth), "enc_nest", "nf", img_size=CLI_IMG, hidden_ratio=NF_RATIO,
                         flow_steps=NF_STEPS, fused_ln=True)
    assert m.parts[0].fused_ln is True
    want = score_nf(*m.parts, DataPipeline(8, CLI_IMG, files=imgs), m.hp, *default_norm_stats())
    np.testing.assert_allclose([float(row[1]) for row in rows], want.image_scores, rtol=0,
                               atol=1e-6)
