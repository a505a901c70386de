"""The port's scoring slice as a whole against the JAX package: on a
synthetic MVTec category, JAX `pipeline.eval.score_nf` with tiny models and
the port's `score_nf` with the converted weights agree on image scores and
maps; the port's `cli.score.main` writes the same scores.csv from
`export_vit` / `export_nf_head` .pth files; heads trained with `--centering`
or `-s` by the port's trainer CLI are scored as they were trained (the
`config.json` of the run). Plus the port's import hygiene and chip_smoke.py's
refusal to run without a GPU."""

import csv
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import pil_decode
from test_torch_vit import D, DEPTH, HEADS, IMG, PATCH, jax_encoder, jax_params, jitter
from vit_ad_tpu.cli.common import parse_args as jax_parse_args
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.config import HyperParams as JaxHyperParams
from vit_ad_tpu.data.loader import DataPipeline as JaxPipeline
from vit_ad_tpu.data.synthetic import make_mvtec_category
from vit_ad_tpu.models.flow import NormalizingFlow as JaxFlow
from vit_ad_tpu.pipeline.eval import score_nf as jax_score_nf
from vit_ad_tpu.scoring import payload_to_scores as jax_payload_to_scores
from vit_ad_tpu.utils.torch_convert import export_nf_head, export_vit
from vit_ad_tpu_torch import registry
from vit_ad_tpu_torch.cli import score as score_cli
from vit_ad_tpu_torch.cli import train_nf as train_nf_cli
from vit_ad_tpu_torch.cli.common import parse_args
from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
from vit_ad_tpu_torch.data.dataset import default_norm_stats
from vit_ad_tpu_torch.data.loader import DataPipeline
from vit_ad_tpu_torch.models.flow import NormalizingFlow
from vit_ad_tpu_torch.models.vit import ViTEncoder
from vit_ad_tpu_torch.pipeline.eval import score_nf
from vit_ad_tpu_torch.pipeline.loading import build_pth_models, hp_from_config
from vit_ad_tpu_torch.scoring import payload_to_scores
from vit_ad_tpu_torch.utils.convert import nf_state_dict_from_jax, vit_state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, RATIO, BATCH = 4, 0.16, 4
# f32 end to end (encoder, flow, resize): sums in other orders; scores and
# maps lie in [0, 1).
ATOL = 2e-5


def _tiny_port_encoder(img_size=IMG, dtypes=None, generator=None):
    # the registry entry the CLI calls, pinned to the tiny f32 encoder
    return ViTEncoder(img_size=IMG, patch_size=PATCH, embed_dim=D, depth=DEPTH,
                      num_heads=HEADS, num_prefix_tokens=2, dtypes=DtypePolicy.f32(),
                      generator=generator)


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    """Synthetic category, tiny JAX DeiT + NF-4 with jittered weights, and the
    JAX package's own scores for the test folder (PIL decode)."""
    mp = pytest.MonkeyPatch()
    pil_decode(mp)
    root = tmp_path_factory.mktemp("torch_score")
    cat = make_mvtec_category(str(root), "widget", img_size=48, n_train=1,
                              n_test_good=3, n_test_defect=4)
    test_dir = os.path.join(cat, "test")
    files = score_cli.list_images(test_dir)
    enc_params = jax_params(2, seed=11)
    flow = JaxFlow(num_channels=D, img_size=IMG, num_patches=(IMG // PATCH) ** 2,
                   hidden_ratio=RATIO, flow_steps=STEPS, dtypes=JaxDtypePolicy.f32())
    flow_params = jitter(jax.jit(flow.init)(jax.random.key(0), jnp.zeros((1, 4, 4, D))),
                         np.random.default_rng(12), 0.1)
    hp = JaxHyperParams(img_size=IMG, batch_size=BATCH, dtypes=JaxDtypePolicy.f32())
    mean, std = default_norm_stats()
    want = jax_score_nf(jax_encoder(2, JaxDtypePolicy.f32()), enc_params, flow, flow_params,
                        JaxPipeline(batch_size=BATCH, img_size=IMG, files=files), hp,
                        mean, std)
    yield {"root": root, "test_dir": test_dir, "files": files, "enc_params": enc_params,
           "flow_params": flow_params, "want": want, "mean": mean, "std": std}
    mp.undo()


def test_score_nf_matches_jax(slice_run):
    r = slice_run
    enc = _tiny_port_encoder()
    enc.load_state_dict(vit_state_dict_from_jax(r["enc_params"]), strict=True)
    flow = NormalizingFlow(D, IMG, (IMG // PATCH) ** 2, hidden_ratio=RATIO, flow_steps=STEPS)
    flow.load_state_dict(nf_state_dict_from_jax(r["flow_params"], (IMG // PATCH) ** 2),
                         strict=True)
    hp = HyperParams(img_size=IMG, batch_size=BATCH, dtypes=DtypePolicy.f32())
    got = score_nf(enc.eval(), flow.eval(), DataPipeline(BATCH, IMG, files=r["files"]), hp,
                   r["mean"], r["std"])
    want = r["want"]
    assert got.pixel_scores.shape == (len(r["files"]), IMG, IMG)
    np.testing.assert_allclose(got.image_scores, want.image_scores, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.pixel_scores, want.pixel_scores, rtol=0, atol=ATOL)
    assert np.array_equal(got.labels, want.labels) and np.array_equal(got.masks, want.masks)


def test_cli_scores_csv_matches_jax_row_by_row(slice_run, tmp_path, monkeypatch):
    r = slice_run
    monkeypatch.setitem(registry._BUILDERS, "enc_deit", _tiny_port_encoder)
    deit = tmp_path / "deit.pth"
    head = tmp_path / "nf_widget.pth"
    torch.save({"model": {**{k: torch.from_numpy(v)
                             for k, v in export_vit(r["enc_params"]["params"]).items()},
                          "head.weight": torch.zeros(10, D)}}, deit)
    torch.save({k: torch.from_numpy(v) for k, v in
                export_nf_head(r["flow_params"], (IMG // PATCH) ** 2).items()}, head)
    out = tmp_path / "out"
    rc = score_cli.main(["--pth", str(head), "-a", "nf", "-m", "enc_deit", "-E", str(deit),
                         "-d", r["test_dir"], "-b", str(BATCH), "-i", str(IMG),
                         "-f", str(STEPS), "--hidden-ratio", str(RATIO), "-o", str(out),
                         "--device", "cpu"])
    assert rc == 0
    with open(out / "scores.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["path", "image_score"]
    assert [row[0] for row in rows[1:]] == r["files"]
    np.testing.assert_allclose([float(row[1]) for row in rows[1:]],
                               r["want"].image_scores, rtol=0, atol=ATOL)
    assert (out / "summary.json").exists()


@pytest.fixture(scope="module")
def trained_runs(tmp_path_factory):
    """Two NF-2 heads trained by `cli.train_nf` on the tiny DeiT of a
    synthetic category: one with `--centering`, one with `-s 1` (features
    after the first of the two blocks, through the final norm)."""
    mp = pytest.MonkeyPatch()
    mp.setitem(registry._BUILDERS, "enc_deit", _tiny_port_encoder)
    root = tmp_path_factory.mktemp("torch_score_runs")
    cat = make_mvtec_category(str(root), "widget", img_size=IMG, n_train=10, n_test_good=2,
                              n_test_defect=2)
    runs = {"train_dir": os.path.join(cat, "train", "good"),
            "test_dir": os.path.join(cat, "test")}
    for name, flags in (("centering", ["--centering"]), ("block", ["-s", "1"])):
        out = root / name
        rc = train_nf_cli.main(["-m", "deit", "-d", cat, "-t", "train/good", "-v", "test",
                                "-e", "1", "-p", "1", "-b", str(BATCH), "-i", str(IMG),
                                "-r", str(RATIO), "-f", str(STEPS), "--device", "cpu",
                                "--out", str(out), *flags])
        assert rc == 0
        (runs[name],) = (str(p) for p in out.glob("nf_enc_deit_*.pth"))
    yield runs
    mp.undo()


def _score_cli(pth, test_dir, out, *extra):
    """scores.csv of `cli.score` on the tiny DeiT NF head `pth`, in input order."""
    rc = score_cli.main(["--pth", pth, "-a", "nf", "-m", "enc_deit", "-d", test_dir,
                         "-b", str(BATCH), "-i", str(IMG), "-f", str(STEPS), "--hidden-ratio",
                         str(RATIO), "-o", str(out), "--device", "cpu", *extra])
    assert rc == 0
    with open(out / "scores.csv") as f:
        rows = list(csv.reader(f))[1:]
    assert [row[0] for row in rows] == score_cli.list_images(test_dir)
    return np.array([float(row[1]) for row in rows])


def _score_nf(pth, test_dir, mean, std, block_index=0):
    m = build_pth_models(pth, "enc_deit", "nf", img_size=IMG, hidden_ratio=RATIO,
                         flow_steps=STEPS, block_index=block_index)
    files = score_cli.list_images(test_dir)
    return score_nf(*m.parts, DataPipeline(BATCH, IMG, files=files), m.hp, mean,
                    std).image_scores


@pytest.mark.parametrize("run,centering,block_index", [("centering", True, 0),
                                                       ("block", False, 1)])
def test_trainer_records_the_run_config(trained_runs, run, centering, block_index):
    """`config.json` beside the head holds what scoring needs: the run's
    `HyperParams.to_log_dict()` and its checkpoint files."""
    with open(os.path.join(os.path.dirname(trained_runs[run]), "config.json")) as f:
        cfg = json.load(f)
    assert cfg.pop("checkpoints") == [os.path.basename(trained_runs[run])]
    assert cfg == hp_from_config(cfg).to_log_dict()
    assert cfg["centering"] is centering and cfg["block_index"] == block_index
    assert (cfg["model_name"], cfg["architecture"], cfg["img_size"], cfg["flow_steps"]) == \
        ("enc_deit", "nf", IMG, STEPS)


def test_centering_run_needs_the_train_data(trained_runs, tmp_path, capsys):
    with pytest.raises(SystemExit, match="--train-data <the training image dir>"):
        _score_cli(trained_runs["centering"], trained_runs["test_dir"], tmp_path / "out")


def test_centering_run_is_scored_with_the_train_data_statistics(trained_runs, tmp_path):
    """With `--train-data` the scores are those of the mean and std that
    `DataPipeline.compute_mean_std` gives for that folder, not ImageNet's."""
    r = trained_runs
    got = _score_cli(r["centering"], r["test_dir"], tmp_path / "out", "--train-data",
                     r["train_dir"])
    pipe = DataPipeline(BATCH, IMG, files=score_cli.list_images(r["train_dir"]))
    pipe.train_files = pipe.test_files
    mean, std = pipe.compute_mean_std()
    np.testing.assert_allclose(got, _score_nf(r["centering"], r["test_dir"], mean, std),
                               rtol=0, atol=1e-6)
    imagenet = _score_nf(r["centering"], r["test_dir"], *default_norm_stats())
    assert np.abs(got - imagenet).max() > 1e-4


def test_block_index_run_is_scored_at_its_depth(trained_runs, tmp_path):
    """A head trained with `-s 1` is scored on the features of that depth,
    which differ from the full depth's."""
    r = trained_runs
    got = _score_cli(r["block"], r["test_dir"], tmp_path / "out")
    stats = default_norm_stats()
    np.testing.assert_allclose(got, _score_nf(r["block"], r["test_dir"], *stats, block_index=1),
                               rtol=0, atol=1e-6)
    assert np.abs(got - _score_nf(r["block"], r["test_dir"], *stats)).max() > 1e-4


@pytest.mark.parametrize("model,warns", [("enc_esvit", True), ("esvit", True),
                                         ("res_net", True), ("deit", False), ("enc_vit", False)])
def test_block_index_outside_the_vit_family_warns_as_jax_does(model, warns):
    """`-s` has an effect on enc_deit / enc_vit only; elsewhere the trainer
    CLIs warn with the JAX CLI's text (JAX `cli/common.parse_args`)."""
    def messages(parse, hp, argv):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            parse(argv, hp, "data/x", "train/good", "test")
        return [str(w.message) for w in caught if "-s 3 has no effect" in str(w.message)]

    got = messages(parse_args, HyperParams(), ["-m", model, "-s", "3", "--device", "cpu"])
    assert bool(got) == warns
    if warns:  # the JAX CLI takes registry keys only
        key = model if model.startswith("enc_") else f"enc_{model}"
        assert got == messages(jax_parse_args, JaxHyperParams(), ["-m", key, "-s", "3"])


@pytest.mark.parametrize("kind,ref_max", [("nf", None), ("recon", None), ("mdn", None),
                                          ("mdn", [1.5]), ("mdn_resnet", None),
                                          ("mdn_resnet", [0.5, 2.0])])
def test_payload_to_scores_matches_jax(kind, ref_max):
    """The host score tail of every head kind (the MDN ones through
    `ll_to_anomaly_maps`: global-max normalization, align_corners=True
    upsample, inversion); f32, same tolerance reasoning as the slice."""
    rng = np.random.default_rng(7)
    if kind == "mdn":
        payload = 2.0 * rng.standard_normal((3, 16)).astype(np.float32)
    elif kind == "mdn_resnet":
        payload = tuple(2.0 * rng.standard_normal((3, p)).astype(np.float32) for p in (16, 4))
    else:
        payload = rng.random((3, 8, 8), dtype=np.float32)
    want = jax_payload_to_scores(kind, payload, 8, ref_max)
    got = payload_to_scores(kind, payload, 8, ref_max)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="unknown score kind"):
        payload_to_scores("gan", payload, 8)


@pytest.mark.parametrize("args,match", [
    (["-r", "{jax_run}", "--device", "cpu"], "vit_ad_tpu.cli.export_weights --run"),
    (["-r", "{jax_run}", "--watch", "5", "--heatmaps", "2"], "not supported with --watch"),
    (["--pth", "x.pth", "-a", "nf", "--watch", "5", "--mesh", "auto", "--device", "cpu"],
     "on the CPU give its sizes"),
    (["--pth", "x.pth", "-a", "nf", "--mesh", "2"], "needs 2 cards, one a rank"),
    (["--pth", "x.pth"], "-a nf"),
    (["-r", "{tmp}"], "no config.json"),
])
def test_cli_refuses_unported_options_clearly(args, match, tmp_path, capsys, monkeypatch):
    """Each refusal names its reason: a JAX run directory (orbax params) names
    the way across, `vit_ad_tpu.cli.export_weights` and then `--pth`;
    `--heatmaps` needs the whole scored set and so not `--watch`; a bare
    `--mesh` takes one card a rank (here a host of one card) and on the CPU
    explicit sizes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    jax_run = tmp_path / "jax_run"
    (jax_run / "best_params").mkdir(parents=True)
    (jax_run / "config.json").write_text(json.dumps(JaxHyperParams().to_log_dict()))
    with pytest.raises(SystemExit) as e:
        score_cli.main([a.format(jax_run=jax_run, tmp=tmp_path) for a in args]
                       + ["-d", str(tmp_path)])
    assert e.value.code != 0
    assert match in capsys.readouterr().err + str(e.value.code)


def test_registry_names_the_roadmap_item():
    """Every key of the JAX registry builds (nothing is pending a ROADMAP item
    any more); a flag a model has no path for and an unknown key raise."""
    from vit_ad_tpu import registry as jax_registry

    assert registry.get_possible_models() == jax_registry.get_possible_models()
    with torch.device("meta"):
        for key, cls in (("enc_nest", "NesT"), ("enc_eff_former", "EfficientFormer"),
                         ("enc_eff_net", "EfficientNetEncoder"),
                         ("ae_nest", "TransformerAutoEncoder")):
            assert type(registry.get_model(key)).__name__ == cls, key
    assert type(registry.get_model("enc_res_net", 32)).__name__ == "ResNetEncoder"
    with pytest.raises(ValueError, match="fused MLP"):
        registry.get_model("enc_esvit", fused_mlp=True)
    with pytest.raises(ValueError, match="fused LayerNorm"):
        registry.get_model("enc_eff_net", fused_ln=True)
    assert type(registry.get_model("ae_deit", 32)).__name__ == "TransformerAutoEncoder"
    with pytest.raises(KeyError):
        registry.get_model("no_such_model")


def test_port_imports_no_jax():
    """Every module of the port (a walk of the package: a new module cannot
    be missed) and chip_smoke.py import without a card and without jax,
    flax, orbax, matplotlib or the JAX package. No module of the port needs
    a card to be imported."""
    code = (
        "import importlib, pkgutil, sys, vit_ad_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(vit_ad_tpu_torch.__path__, "
        "'vit_ad_tpu_torch.')]\n"
        "assert len(mods) > 60, mods\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'matplotlib', 'vit_ad_tpu'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def test_chip_smoke_refuses_without_a_gpu():
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
