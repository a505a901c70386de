"""Port EfficientNet trunk (`vit_ad_tpu_torch/models/efficientnet.py`) against
the JAX `EfficientNetEncoder` on the toy block table of
`test_efficientnet_convert.py` (`TOY_BLOCKS`: an expand-1 stage and a
strided expand-6 stage, B4 width and depth scaling on; 32 px), with the same
variables carried across by `utils/convert.efficientnet_state_dict_from_jax`
and the same seeded inputs; the converted dict back through the JAX
`convert_efficientnet`, the B4 geometry, and a train_nf → score round trip
through the CLIs on the toy trunk."""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_ad_tpu.models.efficientnet as jax_effnet
from test_torch_vit import jitter
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.utils import torch_convert
from vit_ad_tpu_torch import registry
from vit_ad_tpu_torch.cli import score as score_cli
from vit_ad_tpu_torch.cli import train_nf as train_nf_cli
from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.data import synthetic
from vit_ad_tpu_torch.data.dataset import default_norm_stats
from vit_ad_tpu_torch.data.loader import DataPipeline
from vit_ad_tpu_torch.models import efficientnet as peffnet
from vit_ad_tpu_torch.pipeline.eval import score_nf
from vit_ad_tpu_torch.pipeline.loading import build_pth_models, load_encoder_checkpoint
from vit_ad_tpu_torch.utils.convert import efficientnet_state_dict_from_jax

IMG = 32
TOY_BLOCKS = ((1, 8, 1, 1, 3), (6, 16, 2, 2, 3))
# f32: the same math, f32 sums in other orders through the stem, five blocks
# and the head conv (measured ~2e-7 on tokens of magnitude ~0.5)
ATOL_F32 = 2e-6
NF_STEPS, NF_RATIO = 2, 0.05  # 1792 channels: a narrow flow keeps the CLI run short


def port_effnet(generator=None):
    return peffnet.EfficientNetEncoder(img_size=IMG, dtypes=DtypePolicy.f32(),
                                       generator=generator, blocks=TOY_BLOCKS)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trunk built on `TOY_BLOCKS` (patched into its module for the
    build, as `test_efficientnet_convert.py` does), its jittered f32
    variables and its forward on seeded images."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_effnet, "_B0_BLOCKS", TOY_BLOCKS)
        model = jax_effnet.EfficientNetEncoder(img_size=IMG, dtypes=JaxDtypePolicy.f32())
        # jitted: op by op, the JAX trunk takes several times its compile
        variables = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(0),
                                                                 jnp.zeros((1, IMG, IMG, 3))))
        # every leaf moved a little (the BatchNorm variances stay positive)
        variables = jitter(variables, np.random.default_rng(0), 0.05)
        x = np.random.default_rng(1).standard_normal((2, IMG, IMG, 3)).astype(np.float32)
        out = jax.jit(model.apply)(variables, jnp.asarray(x))
    return {"variables": variables, "x": x, "tokens": np.asarray(out.patch_embedding),
            "latent": np.asarray(out.latent)}


def test_efficientnet_matches_jax_f32(jax_run):
    enc = port_effnet()
    enc.load_state_dict(efficientnet_state_dict_from_jax(jax_run["variables"], TOY_BLOCKS),
                        strict=True)
    with torch.inference_mode():
        got = enc(torch.from_numpy(jax_run["x"]))
    # stem /2, one strided stage: an 8x8 map of the 1792-channel head
    assert got.patch_embedding.shape == (2, 64, 1792) == (2, enc.num_patches, enc.embed_dim)
    np.testing.assert_allclose(got.patch_embedding.numpy(), jax_run["tokens"], rtol=0,
                               atol=ATOL_F32)
    np.testing.assert_allclose(got.latent.numpy(), jax_run["latent"], rtol=0, atol=ATOL_F32)


def test_efficientnet_state_dict_round_trips_through_convert(jax_run, monkeypatch, tmp_path):
    """The port's dict (NVIDIA keys) gives back the JAX variables, leaf for
    leaf, through the JAX `convert_efficientnet`, which consumes every key;
    it loads strictly, and `load_encoder_checkpoint` reads it with NVIDIA's
    classifier beside it (dropped, as the JAX converter drops it)."""
    monkeypatch.setattr(jax_effnet, "_B0_BLOCKS", TOY_BLOCKS)
    ours = efficientnet_state_dict_from_jax(jax_run["variables"], TOY_BLOCKS)
    back = torch_convert.convert_efficientnet({k: v.numpy() for k, v in ours.items()})
    want = jax.tree_util.tree_leaves_with_path(jax_run["variables"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        assert np.array_equal(np.asarray(got[path]), leaf), path
    enc = port_effnet()
    assert sorted(enc.state_dict()) == sorted(ours)
    path = tmp_path / "nvidia_efficientnet_toy.pth"
    torch.save({**ours, "classifier.fc.weight": torch.zeros(10, 1792),
                "classifier.fc.bias": torch.zeros(10)}, path)
    load_encoder_checkpoint(enc, str(path))
    for k, v in enc.state_dict().items():
        assert torch.equal(v, ours[k]), k


def test_efficientnet_b4_geometry():
    """EfficientNet-B4 widese at 224 px: a 48-channel stem, 32 MBConv blocks
    over seven layers (2, 4, 4, 6, 6, 8, 2), squeeze-excite sized from the
    expanded width, BatchNorm eps 1e-3, no conv bias, 49 tokens of 1792
    channels. Built on the meta device."""
    with torch.device("meta"):
        enc = registry.get_model("enc_eff_net")
    assert (enc.num_patches, enc.embed_dim) == (49, 1792)
    assert enc.stem.conv.weight.shape == (48, 3, 3, 3) and enc.stem.bn.eps == 1e-3
    assert [len(list(getattr(enc, f"layer{i}").children())) for i in range(1, 8)] == \
        [2, 4, 4, 6, 6, 8, 2]
    blocks = [b for _, b in enc.layers()]
    assert len(blocks) == 32 and blocks[0].expand is None
    second = enc.layer2.block0  # 24 → 32 channels, expanded 6x from 24
    assert second.depsep.conv.groups == 144 and second.se.squeeze.weight.shape == (36, 144)
    assert not any(m.bias is not None for m in enc.modules() if isinstance(m, torch.nn.Conv2d))
    assert [b.residual for b in enc.layer2.children()] == [False, True, True, True]


def _tiny_port_effnet(img_size=IMG, dtypes=None, generator=None):
    # the registry entry the CLIs call, pinned to the toy f32 trunk
    return port_effnet(generator=generator)


def test_cli_train_nf_then_score_round_trip_efficientnet(tmp_path, monkeypatch):
    """`cli.train_nf -m eff_net`, then `cli.score -a nf -m enc_eff_net` on its
    head: one finite score per image, in input order, equal to the scorer's
    on the models `build_pth_models` rebuilds."""
    monkeypatch.setitem(registry._BUILDERS, "enc_eff_net", _tiny_port_effnet)
    category = synthetic.make_mvtec_category(str(tmp_path / "data"), "widget", img_size=IMG,
                                             n_train=12, n_test_good=3, n_test_defect=3)
    out = tmp_path / "run"
    rc = train_nf_cli.main(["-m", "eff_net", "-d", category, "-t", "train/good", "-v", "test",
                            "-e", "2", "-p", "2", "-b", "8", "-i", str(IMG), "-r",
                            str(NF_RATIO), "-f", str(NF_STEPS), "--device", "cpu",
                            "--out", str(out)])
    assert rc == 0
    hist = json.loads((out / "history.json").read_text())
    assert len(hist["train_loss"]) == 2 and "image_auroc_score" in hist["metrics"]
    (pth,) = sorted(out.glob("nf_enc_eff_net_*.pth"))
    test_dir = os.path.join(category, "test")
    scored = tmp_path / "scores"
    rc = score_cli.main(["--pth", str(pth), "-a", "nf", "-m", "enc_eff_net", "-d", test_dir,
                         "-b", "8", "-i", str(IMG), "-f", str(NF_STEPS), "--hidden-ratio",
                         str(NF_RATIO), "-o", str(scored), "--device", "cpu"])
    assert rc == 0
    with open(scored / "scores.csv") as f:
        rows = list(csv.reader(f))[1:]
    imgs = score_cli.list_images(test_dir)
    assert [row[0] for row in rows] == imgs
    m = build_pth_models(str(pth), "enc_eff_net", "nf", img_size=IMG, hidden_ratio=NF_RATIO,
                         flow_steps=NF_STEPS)
    want = score_nf(*m.parts, DataPipeline(8, IMG, files=imgs), m.hp, *default_norm_stats())
    np.testing.assert_allclose([float(row[1]) for row in rows], want.image_scores, rtol=0,
                               atol=1e-6)
