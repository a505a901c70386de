"""Port EfficientFormer trunk (`vit_ad_tpu_torch/models/efficientformer.py`)
against the JAX `EfficientFormer` at the toy size of
`test_efficientformer_convert.py` (32 px, dims 8/16, depths 2/3, two 3D
blocks of two heads, key dim 4, attention ratio 2), with the same variables
carried across by `utils/convert.efficientformer_state_dict_from_jax` and the
same seeded inputs; the converted dict against `export_efficientformer`,
`ae_eff_former_small` through `recon_state_dict_from_jax`, and a
train_mdn → score round trip through the CLIs on a tiny EfficientFormer."""

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
from vit_ad_tpu.models.efficientformer import EfficientFormer as JaxEfficientFormer
from vit_ad_tpu.utils import torch_convert
from vit_ad_tpu_torch import registry
from vit_ad_tpu_torch.cli import score as score_cli
from vit_ad_tpu_torch.cli import train_mdn as train_mdn_cli
from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.data import synthetic
from vit_ad_tpu_torch.data.dataset import default_norm_stats
from vit_ad_tpu_torch.data.loader import DataPipeline
from vit_ad_tpu_torch.models import efficientformer as peff
from vit_ad_tpu_torch.models.autoencoder import TransformerAutoEncoder
from vit_ad_tpu_torch.pipeline.eval import score_mdn
from vit_ad_tpu_torch.pipeline.loading import (
    _load_recon_model,
    build_pth_models,
    load_encoder_checkpoint,
)
from vit_ad_tpu_torch.utils.convert import (
    efficientformer_state_dict_from_jax,
    recon_state_dict_from_jax,
)

IMG = 32
CFG = dict(dims=(8, 16), depths=(2, 3), vit_num=2, num_heads=2, key_dim=4, attn_ratio=2)
# f32: the same math, f32 sums in other orders through the stem, five blocks
# and the BatchNorms (measured ~1e-6 on tokens of magnitude ~3)
ATOL_F32 = 1e-5
K = 4


def port_effformer(img=IMG, generator=None):
    return peff.EfficientFormer(img_size=img, **CFG, dtypes=DtypePolicy.f32(),
                                generator=generator)


@pytest.fixture(scope="module")
def jax_run():
    """One JAX `ae_eff_former_small` (the toy EfficientFormer + SmallDecoder)
    with jittered f32 variables, its forward and its trunk's forward on the
    same images: the trunk's variables are the AE's encoder variables."""
    f32 = JaxDtypePolicy.f32()
    ae = JaxTransformerAE(encoder=JaxEfficientFormer(img_size=IMG, **CFG, dtypes=f32),
                          decoder_kind="cnn", img_size=IMG, dtypes=f32)
    # jitted: op by op, the JAX trunk takes several times its compile
    variables = jax.tree.map(np.asarray, jax.jit(ae.init)(jax.random.key(0),
                                                          jnp.zeros((1, IMG, IMG, 3))))
    # every leaf moved a little (the layer scales off 1e-5, the BatchNorm
    # variances staying positive)
    variables = jitter(variables, np.random.default_rng(0), 0.05)
    x = np.random.default_rng(1).standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    trunk_vars = {"params": variables["params"]["encoder"],
                  "batch_stats": variables["batch_stats"]["encoder"]}
    trunk = jax.jit(JaxEfficientFormer(img_size=IMG, **CFG, dtypes=f32).apply)(
        trunk_vars, jnp.asarray(x))
    recon = jax.jit(ae.apply)(variables, jnp.asarray(x))
    return {"variables": variables, "trunk_vars": trunk_vars, "x": x,
            "tokens": np.asarray(trunk.patch_embedding), "latent": np.asarray(trunk.latent),
            "recon": np.asarray(recon.reconstruction)}


def test_efficientformer_matches_jax_f32(jax_run):
    enc = port_effformer()
    enc.load_state_dict(efficientformer_state_dict_from_jax(jax_run["trunk_vars"]), strict=True)
    with torch.inference_mode():
        got = enc(torch.from_numpy(jax_run["x"]))
    assert got.patch_embedding.shape == (2, 16, 16) == (2, enc.num_patches, enc.embed_dim)
    np.testing.assert_allclose(got.patch_embedding.numpy(), jax_run["tokens"], rtol=0,
                               atol=ATOL_F32)
    np.testing.assert_allclose(got.latent.numpy(), jax_run["latent"], rtol=0, atol=ATOL_F32)


def test_efficientformer_state_dict_equals_export(jax_run, tmp_path):
    """Key for key and value for value `export_efficientformer` (whose zeroed
    `head` and `head_dist` the trunk does not hold), strict loads, and
    `load_encoder_checkpoint` on the exported file with its heads, and on one
    without `attention_bias_idxs` and `num_batches_tracked` (buffers a timm
    file may not carry: the encoder's own are taken, as the JAX converter
    recomputes them)."""
    exported = torch_convert.export_efficientformer(jax_run["trunk_vars"])
    ours = efficientformer_state_dict_from_jax(jax_run["trunk_vars"])
    assert sorted(ours) == sorted(k for k in exported if not k.startswith(("head.", "head_dist.")))
    for k, v in ours.items():
        assert np.array_equal(exported[k], v.numpy()), k
    # one 4D block, the Flat slot, two 3D blocks
    assert not any(k.startswith("stages.1.blocks.1.") for k in ours)
    assert {"stages.1.blocks.0.mlp.fc1.weight", "stages.1.blocks.2.token_mixer.qkv.weight",
            "stages.1.blocks.3.token_mixer.qkv.weight"} <= set(ours)
    assert ours["stages.1.blocks.3.token_mixer.attention_bias_idxs"].dtype == torch.int64
    enc = port_effformer()
    assert sorted(enc.state_dict()) == sorted(ours)
    for name, sd in (("full", exported),
                     ("lean", {k: v for k, v in exported.items()
                               if not k.endswith(("attention_bias_idxs", "num_batches_tracked"))})):
        path = tmp_path / f"efficientformer_{name}.pth"
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
        enc = port_effformer()
        load_encoder_checkpoint(enc, str(path))
        for k, v in enc.state_dict().items():
            assert torch.equal(v, ours[k]), (name, k)


def test_efficientformer_l3_geometry():
    """EfficientFormer-L3 at 224 px: 26 blocks (the last stage's two 4D
    blocks, the Flat slot, four 3D blocks), 49 tokens of 512 channels, eight
    heads of q, k 32 and v 128 channels, a [49, 49] bias index of |dy|·7 +
    |dx|. Built on the meta device."""
    with torch.device("meta"):
        enc = registry.get_model("enc_eff_former")
    assert (enc.num_patches, enc.embed_dim) == (49, 512)
    kinds = [[type(b).__name__ for b in s.blocks] for s in enc.stages]
    assert kinds[:3] == [["Meta4D"] * 4, ["Meta4D"] * 4, ["Meta4D"] * 12]
    assert kinds[3] == ["Meta4D"] * 2 + ["Flat"] + ["Meta3D"] * 4
    att = enc.stages[3].blocks[3].token_mixer
    assert tuple(att.qkv.weight.shape) == (8 * (32 + 32 + 128), 512)
    assert tuple(att.proj.weight.shape) == (512, 8 * 128)
    idx = peff.abs_rel_pos_index(7)
    assert idx.shape == (49, 49) and idx[0, 48] == 6 * 7 + 6 and idx[8, 1] == 7 + 0
    assert enc.stages[0].downsample is None and enc.stem.norm1.eps == 1e-5


def test_ae_eff_former_small_matches_jax(jax_run, tmp_path):
    """`ae_eff_former_small` through `recon_state_dict_from_jax`: the keys and
    values of `export_transformer_ae` (trunk under `encoder.efficientformer.`
    with zeroed `head` and `head_dist`), a strict load, the JAX AE's
    reconstruction, and the exported file read back by the recon loader of
    `cli.score -a recon`."""
    variables = jax_run["variables"]
    sd = recon_state_dict_from_jax(variables)
    exported = torch_convert.export_transformer_ae(variables)
    assert sorted(sd) == sorted(exported)
    for k, v in exported.items():
        assert np.array_equal(np.asarray(v), sd[k].numpy()), k
    ae = TransformerAutoEncoder(port_effformer(), "cnn", IMG, DtypePolicy.f32())
    assert ae.family == "efficientformer"
    ae.load_state_dict(sd, strict=True)
    ae.train()
    assert not ae.encoder.training and ae.decoder.training
    ae.eval()
    with torch.inference_mode():
        out = ae(torch.from_numpy(jax_run["x"]))
    np.testing.assert_allclose(out.reconstruction.numpy(), jax_run["recon"], rtol=0,
                               atol=ATOL_F32)
    path = tmp_path / "ae_efficientformer_small_widget.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in exported.items()}, path)
    loaded = _load_recon_model(TransformerAutoEncoder(port_effformer(), "cnn", IMG, DtypePolicy.f32()),
                               str(path), "")
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k


def _tiny_port_effformer(img_size=IMG, dtypes=None, generator=None):
    # the registry entry the CLIs call, pinned to the toy f32 EfficientFormer
    return port_effformer(generator=generator)


def test_cli_train_mdn_then_score_round_trip_efficientformer(tmp_path, monkeypatch):
    """`cli.train_mdn -m eff_former`, then `cli.score -a mdn -m
    enc_eff_former` on its head: one finite score per image, in input order,
    equal to the scorer's on the models `build_pth_models` rebuilds."""
    monkeypatch.setitem(registry._BUILDERS, "enc_eff_former", _tiny_port_effformer)
    category = synthetic.make_mvtec_category(str(tmp_path / "data"), "widget", img_size=IMG,
                                             n_train=12, n_test_good=3, n_test_defect=3)
    out = tmp_path / "run"
    rc = train_mdn_cli.main(["-m", "eff_former", "-d", category, "-t", "train/good", "-v",
                             "test", "-n", str(K), "-e", "2", "-p", "2", "-b", "8", "-i",
                             str(IMG), "--device", "cpu", "--out", str(out)])
    assert rc == 0
    hist = json.loads((out / "history.json").read_text())
    assert len(hist["train_loss"]) == 2 and "image_auroc_score" in hist["metrics"]
    (pth,) = sorted(out.glob(f"{K}_gaussians_enc_eff_former_*.pth"))
    test_dir = os.path.join(category, "test")
    scored = tmp_path / "scores"
    rc = score_cli.main(["--pth", str(pth), "-a", "mdn", "-m", "enc_eff_former", "-d",
                         test_dir, "-b", "8", "-i", str(IMG), "-o", str(scored),
                         "--device", "cpu"])
    assert rc == 0
    with open(scored / "scores.csv") as f:
        rows = list(csv.reader(f))[1:]
    imgs = score_cli.list_images(test_dir)
    assert [row[0] for row in rows] == imgs
    m = build_pth_models(str(pth), "enc_eff_former", "mdn", img_size=IMG)
    want = score_mdn(*m.parts, DataPipeline(8, IMG, files=imgs), m.hp, *default_norm_stats())
    np.testing.assert_allclose([float(row[1]) for row in rows], want.image_scores, rtol=0,
                               atol=1e-6)
