"""The port's training slices against the JAX package: the dataset splits
and padded `DataPipeline` batches, one `train_mdn` step (noise off: the JAX
and torch random streams differ) with Adam and coupled weight decay, the
early-stopping epoch loop, a tiny `train_mdn` run that separates good from
defective images, the JAX evaluator on the port-trained head, the
`cli.train_mdn` → `.pth` → `cli.score -a mdn` round trip; and the NF slice on
a tiny Swin trunk: `train_nf` against the JAX `train_nf` from the same flow
init, and the `cli.train_nf` → `.pth` → `cli.score -a nf -m enc_esvit` round
trip."""

import csv
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import pil_decode
from test_torch_score import _tiny_port_encoder
from test_torch_mdn import jax_mdn_params, port_mdn
from test_torch_swin import jax_params as jax_swin_params
from test_torch_swin import jax_swin, port_swin
from test_torch_vit import D, IMG, jax_encoder
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.config import HyperParams as JaxHyperParams
from vit_ad_tpu.data import files as jfiles
from vit_ad_tpu.data import synthetic as jsynthetic
from vit_ad_tpu.data.loader import DataPipeline as JaxPipeline
from vit_ad_tpu.models.flow import NormalizingFlow as JaxFlow
from vit_ad_tpu.models.mdn import GaussianMDN as JaxMDN
from vit_ad_tpu.pipeline.early_stopping import run_epochs as jax_run_epochs
from vit_ad_tpu.pipeline.eval import evaluate_mdn as jax_evaluate_mdn
from vit_ad_tpu.pipeline.optimizers import torch_adam as jax_torch_adam
from vit_ad_tpu.pipeline.train import train_nf as jax_train_nf
from vit_ad_tpu.utils.torch_convert import convert_mdn_head
from vit_ad_tpu_torch import registry
from vit_ad_tpu_torch.cli import score as score_cli
from vit_ad_tpu_torch.cli import train_mdn as train_cli
from vit_ad_tpu_torch.cli import train_nf as train_nf_cli
from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
from vit_ad_tpu_torch.data import files, synthetic
from vit_ad_tpu_torch.data.dataset import default_norm_stats
from vit_ad_tpu_torch.data.loader import DataPipeline
from vit_ad_tpu_torch.pipeline.early_stopping import run_epochs
from vit_ad_tpu_torch.models.flow import NormalizingFlow
from vit_ad_tpu_torch.pipeline import train as train_module
from vit_ad_tpu_torch.pipeline.eval import score_mdn, score_nf
from vit_ad_tpu_torch.pipeline.loading import build_pth_models
from vit_ad_tpu_torch.pipeline.optimizers import torch_adam
from vit_ad_tpu_torch.pipeline.train import mdn_train_step, train_mdn, train_nf
from vit_ad_tpu_torch.utils.convert import (
    nf_state_dict_from_jax,
    swin_state_dict_from_jax,
    vit_state_dict_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 4
SWIN_IMG, NF_STEPS, NF_RATIO = 56, 4, 0.5  # the tiny Swin: 49 tokens of 64 channels


@pytest.fixture(scope="module")
def category(tmp_path_factory):
    """A synthetic MVTec category made by the port; the JAX generator makes
    the same files."""
    root = tmp_path_factory.mktemp("torch_train")
    return synthetic.make_mvtec_category(str(root), "widget", img_size=IMG, n_train=24,
                                         n_test_good=5, n_test_defect=5)


@pytest.fixture(autouse=True)
def _pil_decode(monkeypatch):
    pil_decode(monkeypatch)


def test_synthetic_category_matches_jax(category, tmp_path):
    other = jsynthetic.make_mvtec_category(str(tmp_path), "widget", img_size=IMG, n_train=24,
                                           n_test_good=5, n_test_defect=5)
    walk = lambda top: sorted(os.path.relpath(os.path.join(d, f), top)
                              for d, _, fs in os.walk(top) for f in fs)
    ours, theirs = walk(category), walk(other)
    assert ours == theirs and len(ours) == 39  # 24 + 5 + 5 images, 5 masks
    for rel in ours:
        with open(os.path.join(category, rel), "rb") as a, open(os.path.join(other, rel),
                                                               "rb") as b:
            assert a.read() == b.read(), rel


@pytest.mark.parametrize("data_path,valid_path,amount", [
    ("train/good", None, 0), ("train/good", None, 9), ("train/good", "test/good", 0),
    ("test", None, 0)])
def test_file_lists_and_splits_match_jax(category, data_path, valid_path, amount):
    assert files.join_to_file_list(category, data_path) == \
        jfiles.join_to_file_list(category, data_path)
    assert files.train_valid_split(category, data_path, valid_path, amount) == \
        jfiles.train_valid_split(category, data_path, valid_path, amount)


@pytest.mark.parametrize("batch_size", [4, 7])
def test_pipeline_batches_match_jax(category, batch_size):
    """train/valid/test batches of the dataset layout, padding included."""
    ours = DataPipeline(batch_size, IMG, base_path=category, data_path="train/good")
    theirs = JaxPipeline(batch_size=batch_size, base_path=category, data_path="train/good",
                         img_size=IMG)
    test = DataPipeline(batch_size, IMG, base_path=category, data_path="test",
                        validation_mode=True)
    jtest = JaxPipeline(batch_size=batch_size, base_path=category, data_path="test",
                        img_size=IMG, validation_mode=True)
    pairs = [(ours.train_batches(), theirs.train_batches()),
             (ours.valid_batches(), theirs.valid_batches()),
             (test.test_batches(), jtest.test_batches(host=True))]
    for got_it, want_it in pairs:
        got, want = list(got_it), list(want_it)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for field in ("images", "valid", "masks", "labels"):
                a, b = getattr(g, field), getattr(w, field)
                assert (a is None) == (b is None), field
                if a is not None:
                    assert np.array_equal(a, np.asarray(b)), field


def test_compute_mean_std_matches_jax(category):
    """--centering statistics of the train split: f64 host sums in the
    port, f32 sums in the JAX package. The mean agrees to f32 summation
    error; the std is sqrt(E[x^2] - mean^2), where the JAX package's f32
    cancellation (mean^2 ~ 40x the variance here) costs ~1e-4 relative."""
    got = DataPipeline(8, IMG, base_path=category, data_path="train/good").compute_mean_std()
    want = JaxPipeline(batch_size=8, base_path=category, data_path="train/good",
                       img_size=IMG).compute_mean_std()
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=5e-4)


def test_train_step_matches_jax():
    """One step on a padded batch, noise off: loss, gradients and the head
    after torch Adam with coupled weight decay (the JAX package's optax
    chain). f32; the first Adam step moves each weight by about lr, so the
    params compare at a few ulps of lr."""
    lr, wd = 1e-3, 1e-2
    params = jax_mdn_params(seed=31)
    feats = np.random.default_rng(32).standard_normal((3, 6, D)).astype(np.float32)
    valid = np.array([1.0, 1.0, 0.0], np.float32)
    jmdn = JaxMDN(features=D, num_gaussians=K, dtypes=JaxDtypePolicy.f32())

    def masked_loss(p, f, v):
        ll = jmdn.apply(p, f, rng=None, method=JaxMDN.log_likelihood)
        per_example = -jnp.mean(ll, axis=(1, 2))
        return jnp.sum(per_example * v) / jnp.maximum(jnp.sum(v), 1.0)

    loss, grads = jax.value_and_grad(masked_loss)(params, jnp.asarray(feats),
                                                  jnp.asarray(valid))
    tx = jax_torch_adam(lr, wd)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = jax.tree.map(lambda p, u: p + u, params, updates)

    mdn = port_mdn(params)
    got_loss = mdn_train_step(mdn, torch_adam(mdn.parameters(), lr, wd),
                              torch.from_numpy(feats), torch.from_numpy(valid), None)
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-6)
    to_jax = lambda sd: convert_mdn_head({k: v.detach().numpy() for k, v in sd.items()})
    got_grads = to_jax({n: p.grad for n, p in mdn.named_parameters()})["params"]
    got_params = to_jax(mdn.state_dict())["params"]
    for name in got_params:
        w = np.asarray(grads["params"][name])
        np.testing.assert_allclose(got_grads[name], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
        np.testing.assert_allclose(got_params[name], np.asarray(new_params["params"][name]),
                                   rtol=0, atol=1e-3 * lr, err_msg=name)


@pytest.mark.parametrize("losses,patience", [
    ([5.0, 4.0, 4.5, 4.2, 3.0, 3.1, 3.2, 3.3], 3),
    ([2.0, float("nan"), 1.0, 1.5, 1.6], 2),
    ([1.0, 1.0, 1.0], 5),
])
def test_run_epochs_stops_like_jax(losses, patience):
    hp = HyperParams(epochs=len(losses), patience=patience)
    jhp = JaxHyperParams(epochs=len(losses), patience=patience)

    def drive(fn, hp_, snap):
        it = iter(losses)
        return fn(hp_, lambda epoch: (0.5, 8.0), lambda: next(it), snap)

    hist, ran, stop = drive(run_epochs, hp, lambda: {"w": torch.zeros(1)})
    jhist, jran, jstop = drive(jax_run_epochs, jhp, lambda: {"w": jnp.zeros(1)})
    assert ran == jran and stop.best_epoch == jstop.best_epoch
    assert stop.best_loss == jstop.best_loss
    np.testing.assert_array_equal(hist["valid_loss"], jhist["valid_loss"])


@pytest.fixture(scope="module")
def trained(category):
    """A tiny MDN trained by the port on the JAX-initialized tiny encoder."""
    mp = pytest.MonkeyPatch()
    pil_decode(mp)
    # jitted: op by op, the init takes several times its compile
    enc_params = jax.jit(jax_encoder(2, JaxDtypePolicy.f32()).init)(
        jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)))
    enc = _tiny_port_encoder()
    enc.load_state_dict(vit_state_dict_from_jax(enc_params), strict=True)
    hp = HyperParams(epochs=12, patience=5, learning_rate=3e-3, batch_size=8, img_size=IMG,
                     num_gaussians=K, dtypes=DtypePolicy.f32())
    data = DataPipeline(8, IMG, base_path=category, data_path="train/good")
    test = DataPipeline(8, IMG, base_path=category, data_path="test", validation_mode=True)
    result = train_mdn(hp, data, test, encoder=enc, device="cpu")
    yield {"result": result, "enc_params": enc_params, "hp": hp}
    mp.undo()


def test_train_mdn_separates_defects(trained):
    r = trained["result"]
    assert r.epochs_ran >= 2 and r.history["train_loss"][-1] < r.history["train_loss"][0]
    assert np.isfinite(r.best_valid_loss)
    assert r.metrics["image_auroc_score"] >= 0.8, r.metrics
    for key in ("pixel_auroc_score", "image_prauc_score", "pro_score_0.3fp"):
        assert 0.0 <= r.metrics[key] <= 1.0


def test_jax_evaluator_agrees_on_the_port_trained_head(trained, category):
    """The port-trained head, exported, scored by the JAX evaluator with the
    same trunk: the same metrics (rank-based; f32 scores that agree to
    ~1e-5 keep every ranking but near-ties)."""
    r = trained["result"]
    head = convert_mdn_head({k: v.numpy() for k, v in r.head.state_dict().items()})
    jhp = JaxHyperParams(img_size=IMG, batch_size=8, dtypes=JaxDtypePolicy.f32())
    mean, std = default_norm_stats()
    want = jax_evaluate_mdn(jax_encoder(2, JaxDtypePolicy.f32()), trained["enc_params"],
                            JaxMDN(features=D, num_gaussians=K), head,
                            JaxPipeline(batch_size=8, base_path=category, data_path="test",
                                        img_size=IMG, validation_mode=True), jhp, mean, std)
    for key in ("image_auroc_score", "pixel_auroc_score", "image_prauc_score",
                "pro_score_0.3fp"):
        np.testing.assert_allclose(r.metrics[key], want[key], rtol=0, atol=1e-3, err_msg=key)


def test_cli_train_then_score_round_trip(category, tmp_path, monkeypatch):
    monkeypatch.setitem(registry._BUILDERS, "enc_deit", _tiny_port_encoder)
    out = tmp_path / "run"
    rc = train_cli.main(["-d", category, "-t", "train/good", "-v", "test", "-n", str(K),
                         "-e", "2", "-p", "2", "-b", "8", "-i", str(IMG), "--device", "cpu",
                         "--out", str(out)])
    assert rc == 0
    hist = json.loads((out / "history.json").read_text())
    assert len(hist["train_loss"]) == 2 and "image_auroc_score" in hist["metrics"]
    pths = sorted(out.glob(f"{K}_gaussians_enc_deit_*.pth"))
    assert len(pths) == 1
    test_dir = os.path.join(category, "test")
    scored = tmp_path / "scores"
    rc = score_cli.main(["--pth", str(pths[0]), "-a", "mdn", "-d", test_dir, "-b", "8",
                         "-i", str(IMG), "-o", str(scored), "--device", "cpu"])
    assert rc == 0
    with open(scored / "scores.csv") as f:
        rows = list(csv.reader(f))[1:]
    imgs = score_cli.list_images(test_dir)
    assert [row[0] for row in rows] == imgs
    m = build_pth_models(str(pths[0]), "enc_deit", "mdn", img_size=IMG)
    want = score_mdn(*m.parts, DataPipeline(8, IMG, files=imgs), m.hp, *default_norm_stats())
    np.testing.assert_allclose([float(row[1]) for row in rows], want.image_scores, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("args,match", [
    (["--mesh", "2x1"], r"--mesh 2x1 needs 2 cards, one a rank; torch.cuda.device_count\(\) is 1"),
    (["-m", "no_such_model", "--device", "cpu"], "unknown model"),
])
def test_train_cli_refuses_unported_options(args, match, monkeypatch):
    """A bare --mesh spawns one rank a card, so a host of one card refuses
    2x1 with the count, before anything is spawned."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=match):
        train_cli.main(args)


@pytest.fixture(scope="module")
def swin_category(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_nf")
    return synthetic.make_mvtec_category(str(root), "widget", img_size=SWIN_IMG, n_train=24,
                                         n_test_good=5, n_test_defect=5)


def test_train_nf_matches_jax_train_nf(swin_category, monkeypatch):
    """`train_nf` on cached tiny-Swin features against the JAX `train_nf`:
    the same trunk weights, the same flow init (the JAX trainer's, exported),
    the same batches. f32, four epochs of Adam at lr 1e-3: the losses (of
    magnitude ~1e3: a sum over 49 x 64 values) agree to f32 summation order,
    which the optimizer steps amplify slowly; the rank-based metrics agree
    but for near-ties."""
    cat = swin_category
    enc_params = jax_swin_params(SWIN_IMG, seed=21)
    jhp = JaxHyperParams(model_name="enc_esvit", architecture="nf", epochs=4, patience=4,
                         learning_rate=1e-3, weight_decay=1e-5, batch_size=8, img_size=SWIN_IMG,
                         hidden_ratio=NF_RATIO, flow_steps=NF_STEPS, dtypes=JaxDtypePolicy.f32())
    pipes = lambda cls, **kw: (
        cls(batch_size=8, img_size=SWIN_IMG, base_path=cat, data_path="train/good", **kw),
        cls(batch_size=8, img_size=SWIN_IMG, base_path=cat, data_path="test",
            validation_mode=True, **kw))
    want = jax_train_nf(jhp, *pipes(JaxPipeline), encoder=jax_swin(SWIN_IMG, JaxDtypePolicy.f32()),
                        enc_params=enc_params)
    # the flow init the JAX trainer drew (train.py:304, :333-335)
    key = jax.random.split(jax.random.key(jhp.seed))[1]
    jflow = JaxFlow(num_channels=64, img_size=SWIN_IMG, num_patches=49, hidden_ratio=NF_RATIO,
                    flow_steps=NF_STEPS, dtypes=JaxDtypePolicy.f32())
    init = nf_state_dict_from_jax(jflow.init(key, jnp.zeros((1, 7, 7, 64))), 49)

    def flow_with_jax_init(**kw):
        flow = NormalizingFlow(**kw)
        flow.load_state_dict(init, strict=True)
        return flow

    monkeypatch.setattr(train_module, "NormalizingFlow", flow_with_jax_init)
    enc = port_swin(SWIN_IMG)
    enc.load_state_dict(swin_state_dict_from_jax(enc_params), strict=True)
    hp = HyperParams(model_name="enc_esvit", architecture="nf", epochs=4, patience=4,
                     learning_rate=1e-3, weight_decay=1e-5, batch_size=8, img_size=SWIN_IMG,
                     hidden_ratio=NF_RATIO, flow_steps=NF_STEPS, dtypes=DtypePolicy.f32())
    got = train_nf(hp, *pipes(DataPipeline), encoder=enc, device="cpu")
    assert got.epochs_ran == want.epochs_ran == 4 and got.best_epoch == want.best_epoch
    for key_ in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(got.history[key_], want.history[key_], rtol=1e-4,
                                   err_msg=key_)
    assert got.history["train_loss"][-1] < got.history["train_loss"][0]
    np.testing.assert_allclose(got.best_valid_loss, want.best_valid_loss, rtol=1e-4)
    for key_ in ("image_auroc_score", "pixel_auroc_score", "image_prauc_score",
                 "pro_score_0.3fp"):
        np.testing.assert_allclose(got.metrics[key_], want.metrics[key_], rtol=0, atol=1e-3,
                                   err_msg=key_)


def _tiny_port_swin(img_size=SWIN_IMG, dtypes=None, generator=None, fused_ln=None):
    # the registry entry the CLIs call, pinned to the tiny f32 Swin
    return port_swin(SWIN_IMG, fused_ln=bool(fused_ln), generator=generator)


@pytest.mark.parametrize("fused", [None, "--fused-ln"], ids=["default_ln", "fused_ln"])
def test_cli_train_nf_then_score_round_trip(swin_category, tmp_path, monkeypatch, fused):
    monkeypatch.setitem(registry._BUILDERS, "enc_esvit", _tiny_port_swin)
    flags = [fused] if fused else []
    out = tmp_path / "run"
    rc = train_nf_cli.main(["-m", "esvit", "-d", swin_category, "-t", "train/good", "-v", "test",
                            "-e", "2", "-p", "2", "-b", "8", "-i", str(SWIN_IMG), "-r",
                            str(NF_RATIO), "-f", str(NF_STEPS), "--device", "cpu",
                            "--out", str(out), *flags])
    assert rc == 0
    hist = json.loads((out / "history.json").read_text())
    assert len(hist["train_loss"]) == 2 and "image_auroc_score" in hist["metrics"]
    pths = sorted(out.glob("nf_enc_esvit_*.pth"))
    assert len(pths) == 1
    test_dir = os.path.join(swin_category, "test")
    scored = tmp_path / "scores"
    rc = score_cli.main(["--pth", str(pths[0]), "-a", "nf", "-m", "enc_esvit", "-d", test_dir,
                         "-b", "8", "-i", str(SWIN_IMG), "-f", str(NF_STEPS), "--hidden-ratio",
                         str(NF_RATIO), "-o", str(scored), "--device", "cpu", *flags])
    assert rc == 0
    with open(scored / "scores.csv") as f:
        rows = list(csv.reader(f))[1:]
    imgs = score_cli.list_images(test_dir)
    assert [row[0] for row in rows] == imgs
    m = build_pth_models(str(pths[0]), "enc_esvit", "nf", img_size=SWIN_IMG,
                         hidden_ratio=NF_RATIO, flow_steps=NF_STEPS, fused_ln=bool(fused))
    assert m.parts[0].fused_ln == bool(fused)
    want = score_nf(*m.parts, DataPipeline(8, SWIN_IMG, files=imgs), m.hp, *default_norm_stats())
    np.testing.assert_allclose([float(row[1]) for row in rows], want.image_scores, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("cli,args,match", [
    (train_nf_cli, ["-m", "res_net", "--fused-mlp", "--device", "cpu"], "fused MLP"),
    (train_nf_cli, ["--mesh", "auto", "--device", "cpu"], "on the CPU give its sizes"),
    (train_nf_cli, ["-m", "deit", "--fused-ln", "--device", "cpu"], "fused"),
])
def test_train_nf_cli_refuses_unported_options(cli, args, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(args)


@pytest.mark.parametrize("module", ["vit_ad_tpu_torch.cli.score", "vit_ad_tpu_torch.cli.train_mdn",
                                    "vit_ad_tpu_torch.cli.train_nf"])
def test_clis_without_a_card_name_device_cpu(module, tmp_path):
    """With no card and no --device, each CLI exits non-zero and says to
    give --device cpu: there is no silent fall back to the CPU."""
    argv = (["--pth", "4_gaussians_enc_deit_widget.pth", "-a", "mdn", "-d", str(tmp_path)]
            if module.endswith("score") else ["-d", str(tmp_path)])
    p = subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO, capture_output=True,
                       text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert "--device cpu" in p.stderr
