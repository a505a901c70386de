"""The port's reconstruction trainer and scorer against the JAX package:
`train_recon` from the JAX trainer's own init (exported) on the same batches
(the vanilla AE with MSE and with SSIM end to end, a narrow DeiT AE with the
latent cache and the small decoder, one step of a ResNetDecoder AE), the JAX
scorer on the port-trained AE (weights taken back by the JAX importer), and
the `cli.train_recon` → `.pth` + `config.json` → `cli.score -a recon` round
trip. f32."""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import pil_decode
from test_torch_vit import (
    D,
    DEFAULT_TORCH_THREADS,
    DEPTH,
    HEADS,
    IMG,
    PATCH,
    jax_encoder,
    port_encoder,
)
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.config import HyperParams as JaxHyperParams
from vit_ad_tpu.data.loader import DataPipeline as JaxPipeline
from vit_ad_tpu.models import autoencoder as jae
from vit_ad_tpu.pipeline.eval import score_recon as jax_score_recon
from vit_ad_tpu.pipeline.train import train_recon as jax_train_recon
from vit_ad_tpu.utils import torch_convert as tc
from vit_ad_tpu_torch import registry
from vit_ad_tpu_torch.cli import score as score_cli
from vit_ad_tpu_torch.cli import train_recon as train_cli
from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
from vit_ad_tpu_torch.data import synthetic
from vit_ad_tpu_torch.data.dataset import default_norm_stats
from vit_ad_tpu_torch.data.loader import DataPipeline
from vit_ad_tpu_torch.models import autoencoder as pae
from vit_ad_tpu_torch.models.vit import ViTEncoder
from vit_ad_tpu_torch.pipeline.eval import evaluate_recon, score_recon
from vit_ad_tpu_torch.pipeline.loading import build_pth_models
from vit_ad_tpu_torch.pipeline.train import train_recon
from vit_ad_tpu_torch.utils.convert import recon_state_dict_from_jax

F32, JF32 = DtypePolicy.f32(), JaxDtypePolicy.f32()
# train-loss histories: f32 sums in other orders (gradients agree to ~1e-5 of
# each tensor's largest entry), amplified by the Adam steps, which scale every
# element's step to the learning rate whatever its size.
LOSS_RTOL = 1e-4
# validation losses (eval mode): every conv bias in front of a BatchNorm has a
# gradient that is zero but for f32 noise (~1e-9 against 1e-3 for the other
# entries, measured at the first step, with other signs on the two sides);
# Adam turns it into steps of ~0.1·lr in directions that differ between the
# two. Train mode cancels a bias in front of a BatchNorm exactly; eval mode,
# on the running statistics, does not: the validation losses differ by up to
# 2.7e-3 (measured) though the train losses agree. The JAX scorer on the
# port-trained weights (test_jax_scores_the_port_trained_ae_alike) holds the
# eval path itself to SCORE_RTOL.
VALID_RTOL = 5e-3
# maps and image scores of the same weights: f32 through ten conv stages,
# relative to the largest entry
SCORE_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _default_torch_threads():
    """LOSS_RTOL holds the port's train-loss histories to the JAX trainer's
    over four epochs of Adam at torch's default thread count, as it was set;
    at two threads (tests/test_torch_vit.py) the vanilla AE's f32 sums take
    another order and its fourth epoch is 1.5e-4 apart. This module keeps the
    default count."""
    capped = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_TORCH_THREADS)
    yield
    torch.set_num_threads(capped)


@pytest.fixture(scope="module")
def category(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_recon")
    return synthetic.make_mvtec_category(str(root), "widget", img_size=IMG, n_train=20,
                                         n_test_good=4, n_test_defect=4)


@pytest.fixture(autouse=True)
def _pil_decode(monkeypatch):
    pil_decode(monkeypatch)


def _pipes(cls, cat, batch):
    return (cls(batch_size=batch, img_size=IMG, base_path=cat, data_path="train/good"),
            cls(batch_size=batch, img_size=IMG, base_path=cat, data_path="test",
                validation_mode=True))


def _jax_trainer_init(model, seed):
    """The variables the JAX `train_recon` starts from (train.py:485-491)."""
    k = jax.random.split(jax.random.key(seed))[1]
    v = model.init(k, jnp.zeros((1, IMG, IMG, 3), jnp.float32), train=True)
    return jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})


def _run_both(cat, make_jax, make_port, batch, epochs, lr, use_ssim=False):
    kw = dict(architecture="reconstruction", epochs=epochs, patience=epochs, learning_rate=lr,
              weight_decay=1e-4, batch_size=batch, img_size=IMG)
    jm = make_jax()
    want = jax_train_recon(JaxHyperParams(**kw, dtypes=JF32), *_pipes(JaxPipeline, cat, batch),
                           model=jm, use_ssim=use_ssim)
    ae = make_port()
    ae.load_state_dict(recon_state_dict_from_jax(_jax_trainer_init(jm, 24)), strict=True)
    hp = HyperParams(**kw, dtypes=F32)
    got = train_recon(hp, *_pipes(DataPipeline, cat, batch), model=ae, use_ssim=use_ssim,
                      device="cpu")
    assert got.epochs_ran == want.epochs_ran == epochs and got.best_epoch == want.best_epoch
    for key, rtol in (("train_loss", LOSS_RTOL), ("valid_loss", VALID_RTOL)):
        np.testing.assert_allclose(got.history[key], want.history[key], rtol=rtol, err_msg=key)
    np.testing.assert_allclose(got.best_valid_loss, want.best_valid_loss, rtol=VALID_RTOL)
    for key in ("image_auroc_score", "pixel_auroc_score", "image_prauc_score"):
        np.testing.assert_allclose(got.metrics[key], want.metrics[key], rtol=0, atol=1e-3,
                                   err_msg=key)
    return jm, hp, got, want


def _ae_cnn_run(cat, use_ssim):
    """ae_cnn end to end (its encoder's BatchNorms train too), four epochs of
    Adam from the JAX trainer's init; with SSIM the loss is 5·MSE +
    0.5·(1 - SSIM), the validation loss MSE alone, as in JAX. The drift of
    the train losses, measured: 4e-5 by the fourth epoch at lr 3e-4 (MSE) and
    1e-3 (SSIM); 2e-4 with MSE at lr 1e-3, 5e-4 with SSIM at 3e-4."""
    lr = 1e-3 if use_ssim else 3e-4
    return _run_both(cat, lambda: jae.VanillaAutoEncoder(img_size=IMG, dtypes=JF32),
                     lambda: pae.VanillaAutoEncoder(IMG, F32), 8, 4, lr, use_ssim)


@pytest.fixture(scope="module")
def ae_cnn_mse(category):
    return _ae_cnn_run(category, False)


def test_train_recon_ae_cnn_mse_matches_jax(ae_cnn_mse):
    got = ae_cnn_mse[2]
    assert got.history["train_loss"][-1] < got.history["train_loss"][0]
    assert not got.head.training


def test_train_recon_ae_cnn_ssim_matches_jax(category):
    got = _ae_cnn_run(category, True)[2]
    assert got.history["train_loss"][-1] < got.history["train_loss"][0]


def test_jax_scores_the_port_trained_ae_alike(category, ae_cnn_mse):
    """The reverse direction: the port-trained ae_cnn's state dict taken into
    JAX by its importer (`convert_recon_ae`), scored by `score_recon` there
    and here: maps and image scores within SCORE_RTOL of the largest."""
    _, hp, got, _ = ae_cnn_mse
    sd = {k: v.numpy() for k, v in got.head.state_dict().items()}
    variables = tc.convert_recon_ae(sd, img_size=IMG)
    mean, std = default_norm_stats()
    test = _pipes(DataPipeline, category, 8)[1]
    mine = score_recon(got.head, test, hp, mean, std)
    theirs = jax_score_recon(jae.VanillaAutoEncoder(img_size=IMG, dtypes=JF32), variables,
                             _pipes(JaxPipeline, category, 8)[1],
                             JaxHyperParams(img_size=IMG, batch_size=8, dtypes=JF32), mean, std)
    for a, b, what in ((mine.pixel_scores, theirs.pixel_scores, "maps"),
                       (mine.image_scores, theirs.image_scores, "image scores")):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=SCORE_RTOL * np.abs(b).max(), err_msg=what)
    np.testing.assert_array_equal(mine.labels, np.asarray(theirs.labels))
    assert evaluate_recon(got.head, test, hp, mean, std) == got.metrics
    with pytest.raises(ValueError, match="eval mode"):  # it would move the running stats
        score_recon(got.head.train(), test, hp, mean, std)
    got.head.eval()


def _tiny_trunk(img_size=IMG, dtypes=None, generator=None, fused_mlp=None):
    # the registry trunk the CLIs build, pinned to the narrow f32 DeiT
    return ViTEncoder(img_size=IMG, patch_size=PATCH, embed_dim=D, depth=DEPTH,
                      num_heads=HEADS, num_prefix_tokens=2, dtypes=DtypePolicy.f32(),
                      generator=generator, fused_mlp=fused_mlp)


@pytest.mark.parametrize("model", ["ae_cnn", "ae_deit_small"])
def test_cli_train_recon_then_score_round_trip(category, tmp_path, monkeypatch, model):
    """`cli.train_recon` writes history.json, config.json and the whole AE
    as `<model>_<class>.pth`; `cli.score -a recon -m <model>` on it gives the
    scores of the loaded AE, whose metrics are the trainer's own."""
    monkeypatch.setitem(registry._BUILDERS, "enc_deit", _tiny_trunk)
    out = tmp_path / "run"
    flags = ["--no-fused-mlp"] if model == "ae_deit_small" else []
    rc = train_cli.main(["-m", model, "-d", category, "-t", "train/good", "-v", "test", "-e", "2",
                         "-p", "2", "-b", "8", "-i", str(IMG), "--device", "cpu", "--out",
                         str(out), *flags])
    assert rc == 0
    hist = json.loads((out / "history.json").read_text())
    cfg = json.loads((out / "config.json").read_text())
    assert len(hist["train_loss"]) == 2 and cfg["model_name"] == model
    assert cfg["architecture"] == "reconstruction"
    (pth,) = out.glob(f"{model}_*.pth")
    test_dir = os.path.join(category, "test")
    scored = tmp_path / "scores"
    rc = score_cli.main(["--pth", str(pth), "-a", "recon", "-m", model, "-d", test_dir, "-b", "8",
                         "-i", str(IMG), "-o", str(scored), "--device", "cpu", *flags])
    assert rc == 0
    with open(scored / "scores.csv") as f:
        rows = list(csv.reader(f))[1:]
    imgs = score_cli.list_images(test_dir)
    assert [row[0] for row in rows] == imgs
    m = build_pth_models(str(pth), model, "recon", img_size=IMG,
                         fused_mlp=False if flags else None)
    mean, std = default_norm_stats()
    want = score_recon(*m.parts, DataPipeline(8, IMG, files=imgs), m.hp, mean, std)
    np.testing.assert_allclose([float(row[1]) for row in rows], want.image_scores, rtol=0,
                               atol=1e-6)
    test = DataPipeline(8, IMG, base_path=category, data_path="test", validation_mode=True)
    assert evaluate_recon(*m.parts, test, m.hp, mean, std) == hist["metrics"]


def test_recon_clis_exit_without_a_card_unless_told_cpu(category, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train_cli.main(["-d", category, "-t", "train/good", "-v", "test", "-i", str(IMG)])
    with pytest.raises(SystemExit, match="--device cpu"):
        score_cli.main(["--pth", str(tmp_path / "ae_cnn_widget.pth"), "-a", "recon", "-m",
                        "ae_cnn", "-d", category])
    with pytest.raises(SystemExit, match="ae_"):
        train_cli.main(["-m", "deit", "-d", category, "--device", "cpu"])


def test_recon_pth_loading_drops_metric_state_and_resizes_swin_tables(tmp_path, monkeypatch):
    """A reference recon `.pth` of an EsViT AE: the torchmetrics `ssim.*`
    state of the reference's base AE is dropped, bias tables saved for window
    7 are resized to a block's clamped window (5: the tiny Swin's stage 1 at
    40 px) as `load_encoder_checkpoint` does for the trunk alone, the
    relative-position indexes are the model's own; anything else unknown
    fails the strict load."""
    from test_torch_swin import port_swin
    from vit_ad_tpu_torch.ops.window_attention import relative_position_index
    from vit_ad_tpu_torch.utils.convert import interpolate_rel_pos_table

    img = 40
    monkeypatch.setitem(registry._BUILDERS, "enc_esvit",
                        lambda img_size, dtypes, generator=None, fused_ln=None:
                        port_swin(img, generator=generator))
    sd = registry.get_model("ae_esvit_small", img, F32,
                            generator=torch.Generator().manual_seed(3)).state_dict()
    rng = np.random.default_rng(0)
    saved = {}
    for k in list(sd):
        if k.startswith("encoder.esvit.layers.1.") and k.endswith("bias_table"):
            saved[k] = rng.standard_normal((13 * 13, sd[k].shape[1])).astype(np.float32)
            sd[k] = torch.from_numpy(saved[k])
            sd[k.replace("bias_table", "index")] = torch.from_numpy(
                relative_position_index(7, 7).copy())
    assert saved
    sd["ssim.similarity"] = torch.zeros(())
    pth = tmp_path / "ae_esvit_small_widget.pth"
    torch.save(sd, pth)
    m = build_pth_models(str(pth), "ae_esvit_small", "recon", img_size=img, dtypes=F32)
    (ae,) = m.parts
    assert m.kind == "recon" and not ae.training
    own = ae.state_dict()
    for k, table in saved.items():
        np.testing.assert_array_equal(own[k].numpy(), interpolate_rel_pos_table(table, 7, 5))
        assert own[k.replace("bias_table", "index")].shape == (25, 25)
    sd["decoder.unknown"] = torch.zeros(1)
    torch.save(sd, pth)
    with pytest.raises(RuntimeError, match="decoder.unknown"):
        build_pth_models(str(pth), "ae_esvit_small", "recon", img_size=img, dtypes=F32)
