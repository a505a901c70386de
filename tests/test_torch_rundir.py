"""The port's run directory against the JAX package's, on the CPU with the
tiny f32 DeiT of `test_torch_vit.py`: the checkpoint round trip and its
atomic write, `MetricLogger` fed the same rows as the JAX `MetricLogger`,
`hp_from_config` as JAX's, the files `cli.train_{nf,mdn,recon}` write,
`cli.score -r` bit-equal to `--pth` on the same files, `cli.validate`
reproducing each trainer's recorded metrics (and exiting non-zero on a broken
run), and the arrays behind the evaluators' six figures against JAX's."""

import csv
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_data import pil_decode
from test_torch_score import _tiny_port_encoder
from test_torch_vit import IMG
from vit_ad_tpu.config import HyperParams as JaxHyperParams
from vit_ad_tpu.pipeline import metrics as jax_metrics
from vit_ad_tpu.pipeline.loading import hp_from_config as jax_hp_from_config
from vit_ad_tpu.utils.logging import MetricLogger as JaxMetricLogger
from vit_ad_tpu_torch import registry
from vit_ad_tpu_torch.cli import score as score_cli
from vit_ad_tpu_torch.cli import train_mdn as train_mdn_cli
from vit_ad_tpu_torch.cli import train_nf as train_nf_cli
from vit_ad_tpu_torch.cli import train_recon as train_recon_cli
from vit_ad_tpu_torch.cli import validate as validate_cli
from vit_ad_tpu_torch.config import HyperParams
from vit_ad_tpu_torch.data import synthetic
from vit_ad_tpu_torch.models.mdn import GaussianMDN
from vit_ad_tpu_torch.pipeline import metrics as M
from vit_ad_tpu_torch.pipeline.eval import eval_figure_arrays, save_eval_figures
from vit_ad_tpu_torch.pipeline.loading import find_checkpoint, hp_from_config, load_run
from vit_ad_tpu_torch.utils import checkpoint
from vit_ad_tpu_torch.utils.images import JET, colorize
from vit_ad_tpu_torch.utils.logging import MetricLogger

BATCH = 4
# the CLI flags of each run: (trainer, argv, `cli.score --pth` flags)
RUNS = {
    "nf": (train_nf_cli, ["-m", "deit", "-r", "0.5", "-f", "2"],
           ["-a", "nf", "-m", "enc_deit", "-f", "2", "--hidden-ratio", "0.5"]),
    "mdn": (train_mdn_cli, ["-m", "deit", "-n", "2"], ["-a", "mdn", "-m", "enc_deit"]),
    "recon": (train_recon_cli, ["-m", "ae_cnn"], ["-a", "recon", "-m", "ae_cnn"]),
}
RUN_FILES = ("config.json", "metrics.jsonl", "metrics.csv", "history.json", "loss_curves.png",
             "figures/heatmaps.png", "figures/ground_truth.png", "figures/overlay.png",
             "figures/roc_curve.png", "figures/pr_curve.png")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An NF-2 and an MDN K=2 head on the tiny DeiT and the ae_cnn
    auto-encoder, each trained for two epochs by its CLI into `<root>/runs`."""
    mp = pytest.MonkeyPatch()
    pil_decode(mp)
    mp.setitem(registry._BUILDERS, "enc_deit", _tiny_port_encoder)
    root = tmp_path_factory.mktemp("torch_rundir")
    cat = synthetic.make_mvtec_category(str(root), "widget", img_size=IMG, n_train=12,
                                        n_test_good=3, n_test_defect=3)
    for name, (cli, flags, _) in RUNS.items():
        rc = cli.main([*flags, "-d", cat, "-t", "train/good", "-v", "test", "-e", "2", "-p",
                       "2", "-b", str(BATCH), "-i", str(IMG), "--device", "cpu", "--out",
                       str(root / "runs" / name)])
        assert rc == 0
    yield {"cat": cat, "runs": root / "runs"}
    mp.undo()


@pytest.fixture(autouse=True)
def _pil_decode(monkeypatch):
    pil_decode(monkeypatch)
    monkeypatch.setitem(registry._BUILDERS, "enc_deit", _tiny_port_encoder)


def test_checkpoint_round_trip_and_atomic_write(tmp_path, monkeypatch):
    head = GaussianMDN(8, 2, generator=torch.Generator().manual_seed(0))
    path = checkpoint.save_params(str(tmp_path), "2_gaussians_x_w.pth", head.state_dict())
    assert path == str(tmp_path / "2_gaussians_x_w.pth")
    sd = checkpoint.load_tree(path)
    assert sd.keys() == head.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in head.state_dict().items())
    other = checkpoint.load_params(path, GaussianMDN(8, 2))
    assert all(torch.equal(a, b) for a, b in zip(other.state_dict().values(),
                                                 head.state_dict().values()))
    with pytest.raises(RuntimeError):  # strict: another head's shape does not load
        checkpoint.load_params(path, GaussianMDN(8, 3))

    # a save that dies mid-write leaves the previous file whole and no
    # temporary file behind
    def torn(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", torn)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_params(str(tmp_path), "2_gaussians_x_w.pth", {"w": torch.zeros(3)})
    assert os.listdir(tmp_path) == ["2_gaussians_x_w.pth"]
    assert checkpoint.load_tree(path).keys() == head.state_dict().keys()


def test_metric_logger_matches_jax(tmp_path):
    """The same rows (epochs, then the eval row whose keys grow the CSV
    header, a non-scalar field) give the same files, `_time` left out."""
    rows = [{"epoch": 0, "train_loss": 3.5, "valid_loss": 3.25, "images_per_sec": 10.0},
            {"epoch": 1, "train_loss": 2.5, "valid_loss": 2.75, "images_per_sec": 12.5},
            {"image_auroc_score": 0.75, "pixel_auroc_score": 0.5, "stage": "eval",
             "shape": [2, 3]}]
    cfg = HyperParams(model_name="enc_deit", architecture="nf").to_log_dict()
    loggers = [cls(str(tmp_path / side), run_name="r", config=cfg)
               for cls, side in ((MetricLogger, "port"), (JaxMetricLogger, "jax"))]
    for logger in loggers:
        for row in rows:
            logger.log(row)
        logger.finish()

    def read(side):
        d = tmp_path / side / "r"
        jsonl = [{k: v for k, v in json.loads(line).items() if k != "_time"}
                 for line in (d / "metrics.jsonl").read_text().splitlines()]
        with open(d / "metrics.csv") as f:
            table = [{k: v for k, v in r.items() if k != "_time"} for r in csv.DictReader(f)]
        with open(d / "metrics.csv") as f:
            header = next(csv.reader(f))
        return jsonl, table, header, json.loads((d / "config.json").read_text())

    port, jax_side = read("port"), read("jax")
    assert port == jax_side
    assert port[2][0] == "_time" and "stage" in port[2] and "shape" not in port[2]


def test_metric_logger_without_wandb_says_so_and_logs_locally(tmp_path, capsys):
    logger = MetricLogger(str(tmp_path), run_name="r", enable_wandb=True)
    logger.log({"epoch": 0})
    logger.finish()
    assert "wandb unavailable" in capsys.readouterr().out
    assert (tmp_path / "r" / "metrics.csv").exists()


def test_hp_from_config_matches_jax():
    """A JAX run's config.json (plus keys neither side knows) restores the
    same hyper-parameters on both sides; the port's own record adds its two
    kernel switches."""
    cfg = JaxHyperParams(model_name="enc_esvit", architecture="mdn", epochs=7, batch_size=16,
                         img_size=112, centering=True, num_gaussians=4, block_index=2,
                         data_class="screw", base_path="data/x").to_log_dict()
    cfg = {**cfg, "checkpoints": ["a.pth"], "unknown_key": 1}
    got, want = hp_from_config(cfg).to_log_dict(), jax_hp_from_config(cfg).to_log_dict()
    assert set(got) == set(want) | {"fused_ln", "fused_mlp"}
    assert {k: got[k] for k in want} == want
    assert hp_from_config({**cfg, "fused_ln": True}).fused_ln is True


@pytest.mark.parametrize("name", sorted(RUNS))
def test_trainer_cli_writes_the_run_directory(runs, name):
    d = runs["runs"] / name
    cfg = json.loads((d / "config.json").read_text())
    assert {k: v for k, v in cfg.items() if k != "checkpoints"} == \
        hp_from_config(cfg).to_log_dict()
    assert [os.path.basename(p) for p in find_checkpoint(str(d))] == cfg["checkpoints"]
    for f in RUN_FILES + tuple(cfg["checkpoints"]) + (("figures/recons.png",)
                                                      if name == "recon" else ()):
        assert (d / f).exists(), f
    records = [json.loads(line) for line in (d / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records[:-1]] == [0, 1]
    hist = json.loads((d / "history.json").read_text())
    assert records[-1]["stage"] == "eval"
    assert {k: records[-1][k] for k in hist["metrics"]} == hist["metrics"]
    assert hist["train_loss"] == [r["train_loss"] for r in records[:-1]]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_score_run_is_bit_equal_to_pth(runs, name, tmp_path):
    d = runs["runs"] / name
    cfg = json.loads((d / "config.json").read_text())
    test_dir = os.path.join(runs["cat"], "test")
    common = ["-d", test_dir, "-b", str(BATCH), "--device", "cpu"]
    assert score_cli.main(["-r", str(d), "-o", str(tmp_path / "r"), *common]) == 0
    assert score_cli.main(["--pth", str(d / cfg["checkpoints"][0]), *RUNS[name][2], "-i",
                           str(IMG), "-o", str(tmp_path / "p"), *common]) == 0
    by_run = (tmp_path / "r" / "scores.csv").read_text()
    assert by_run == (tmp_path / "p" / "scores.csv").read_text()
    assert len(by_run.splitlines()) == 1 + 6
    summary = json.loads((tmp_path / "r" / "summary.json").read_text())
    assert summary["arch"] == cfg["architecture"] and summary["run"] == str(d)


def test_validate_reproduces_the_recorded_metrics(runs, tmp_path):
    """`cli.validate` over the runs: every run's metrics equal the eval row
    its trainer logged, and so do those of the MDN head's file alone (the
    `.pth` mode, batch 64 against the run's 4: the same per-image scores to
    f32 summation order); a broken run is reported, the others still
    written, and the exit code is non-zero."""
    assert validate_cli.main(["-r", str(runs["runs"]), "--device", "cpu"]) == 0
    with open(runs["runs"] / "validation_results.csv") as f:
        rows = {r["Name"]: r for r in csv.DictReader(f)}
    assert sorted(rows) == sorted(RUNS)
    for name in RUNS:
        recorded = [json.loads(line) for line in
                    (runs["runs"] / name / "metrics.jsonl").read_text().splitlines()][-1]
        for key in ("image_auroc_score", "pixel_auroc_score", "image_prauc_score",
                    "pro_score_0.3fp", "aupro_score_0.3fp"):
            assert float(rows[name][key]) == recorded[key], (name, key)

    # the reference-format mode of `validation_loop.py`: the head files under
    # -r, the class from the file name under -d
    legacy = tmp_path / "pth"
    legacy.mkdir()
    mdn_cfg = json.loads((runs["runs"] / "mdn" / "config.json").read_text())
    shutil.copy(runs["runs"] / "mdn" / mdn_cfg["checkpoints"][0],
                legacy / "2_gaussians_enc_deit_widget.pth")
    assert validate_cli.main(["-r", str(legacy), "-a", "mdn", "-m", "enc_deit", "-i", str(IMG),
                              "-d", os.path.dirname(runs["cat"]), "--device", "cpu"]) == 0
    with open(legacy / "validation_results.csv") as f:
        (row,) = list(csv.DictReader(f))
    recorded = [json.loads(line) for line in
                (runs["runs"] / "mdn" / "metrics.jsonl").read_text().splitlines()][-1]
    for key in ("image_auroc_score", "pixel_auroc_score", "pro_score_0.3fp"):
        np.testing.assert_allclose(float(row[key]), recorded[key], rtol=0, atol=1e-6,
                                   err_msg=key)

    broken = tmp_path / "runs"
    broken.mkdir()
    for name in RUNS:
        os.symlink(runs["runs"] / name, broken / name)
    os.makedirs(broken / "torn")
    cfg = json.loads((runs["runs"] / "nf" / "config.json").read_text())
    (broken / "torn" / "config.json").write_text(json.dumps(cfg))  # its checkpoint is missing
    assert validate_cli.main(["-r", str(broken), "--device", "cpu"]) == 1
    with open(broken / "validation_results.csv") as f:
        assert sorted(r["Name"] for r in csv.DictReader(f)) == sorted(RUNS)


def test_load_run_rebuilds_the_trained_head(runs):
    m, cfg = load_run(str(runs["runs"] / "mdn"))
    assert m.kind == "mdn" and m.hp.num_gaussians == 2 and cfg["architecture"] == "mdn"
    saved = torch.load(runs["runs"] / "mdn" / cfg["checkpoints"][0], weights_only=True)
    assert all(torch.equal(saved[k], v) for k, v in m.parts[1].state_dict().items())


def test_eval_figures_match_jax(tmp_path):
    """The arrays behind the six figures: the FPR-thresholded maps, the masks
    and the ROC and PR points are JAX's; the maps go through matplotlib's jet
    byte for byte; the PNGs are written."""
    from matplotlib import colormaps

    rng = np.random.default_rng(3)
    maps = rng.random((10, 16, 16)).astype(np.float32)
    masks = (rng.random((10, 16, 16)) > 0.8).astype(np.float64)
    labels = np.array([0, 1] * 5, np.float64)
    scores = maps.reshape(10, -1).max(axis=1) + 0.1 * labels
    origs = rng.integers(0, 256, (9, 16, 16, 3), dtype=np.uint8)
    recons = rng.standard_normal((9, 16, 16, 3)).astype(np.float32)
    result = M.EvalResult(image_scores=scores, image_labels=labels, pixel_scores=maps,
                          pixel_labels=masks, origs=origs, recons=recons)
    metrics = M.calc_all_metrics(result, 0.3)
    np.testing.assert_array_equal(
        M.create_heatmap_from_scores(maps, masks, 0.3),
        jax_metrics.create_heatmap_from_scores(maps, masks, 0.3))
    for ours, theirs in ((M.roc_curve, jax_metrics.roc_curve),
                         (M.precision_recall_curve, jax_metrics.precision_recall_curve)):
        for a, b in zip(ours(labels, scores), theirs(labels, scores)):
            np.testing.assert_array_equal(a, b)
    x = np.linspace(-0.2, 1.2, 2001)
    np.testing.assert_array_equal(colorize(x), colormaps["jet"](x, bytes=True)[..., :3])
    assert JET.shape == (256, 3)
    figures = eval_figure_arrays(result, metrics, 0.3)
    assert sorted(figures) == sorted(["heatmaps", "ground_truth", "overlay", "recons",
                                      "roc_curve", "pr_curve"])
    thresholded = M.create_heatmap_from_scores(maps, masks, 0.3)
    np.testing.assert_array_equal(figures["heatmaps"][:16, :16], colorize(thresholded[0]))
    paths = save_eval_figures(result, metrics, str(tmp_path / "figures"))
    assert sorted(paths) == sorted(figures)
    for name, path in paths.items():
        with Image.open(path) as im:
            np.testing.assert_array_equal(np.asarray(im), figures[name], err_msg=name)
