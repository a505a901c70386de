"""Score a folder of images with a trained run or reference-format `.pth`
weights on the GPU (port of `python -m vit_ad_tpu.cli.score`).

    python -m vit_ad_tpu_torch.cli.score -r <run dir> -d /path/to/images \\
        [-o out_dir] [--heatmaps N] [--train-data DIR] [-b BATCH] \\
        [--weights-dtype auto|f32|bf16] [--watch SECS [--watch-waves N]] [--mesh DxM]
    python -m vit_ad_tpu_torch.cli.score --pth <head .pth> -a nf|mdn \\
        -m enc_deit|enc_vit|enc_esvit|enc_nest|enc_eff_former|enc_eff_net \\
        -E <trunk .pth> -d /path/to/images \\
        [-o out_dir] [-b BATCH] [--fused-ln|--no-fused-ln] [--fused-mlp|--no-fused-mlp]
    python -m vit_ad_tpu_torch.cli.score --pth <stage-2 head .pth> <stage-3 head .pth> \\
        -a mdn -E <ResNet encoder .pth> -d /path/to/images
    python -m vit_ad_tpu_torch.cli.score --pth <auto-encoder .pth> -a recon -m ae_* \\
        -d /path/to/images [--fused-ln|--no-fused-ln] [--fused-mlp|--no-fused-mlp]

`-r` takes a run directory the port's trainers wrote (`cli/common.py`): any
of the five head families, the NF and MDN heads on the ResNet stage maps
included; the models are rebuilt from its `config.json` and checkpoints
(`pipeline/loading.load_run`). A JAX run directory (orbax params) exits
naming `vit_ad_tpu.cli.export_weights`, the way across to `--pth`.

MDN files are named `<K>_..._<class>.pth` (K = number of gaussians), as
`cli.train_mdn` saves them; `cli.train_nf` saves `nf_<model>_<class>.pth`.
Two `.pth` files are the reference's ResNet-MDN convention: one head per
ResNet-50 stage map (2, then 3), as `cli.train_mdn -m res_net` saves them.
A recon `.pth` is the whole auto-encoder of the `-m ae_*` key, as
`cli.train_recon` saves it (`<model>_<class>.pth`); `-E` is ignored there.
`-E` is the pretrained trunk the head was trained against: a timm ViT/DeiT
`.pth`, the EsViT Swin-T checkpoint for `-m enc_esvit`, timm's `jx_nest_tiny`
or `efficientformer_l3` file, NVIDIA's widese-B4 file for `-m enc_eff_net`,
or for the ResNet heads the encoder file their training run wrote (or
ImageNet ResNet-50 weights). `--fused-ln` / `--no-fused-ln` send the EsViT
and NesT trunks' LayerNorms through the one-pass kernel or not, `--fused-mlp` /
`--no-fused-mlp` the ViT/DeiT blocks' MLP tail through the fused kernel or not
(default of both: the model's, or with `-r` the run's).

A `--pth` head that the port's trainers wrote has the run's `config.json`
beside it; scoring reads it back: the head is scored on features of the
recorded depth (`block_index`, `-s` of the trainer), and a run trained with
`--centering` is standardized with the mean and std of `--train-data` (the
training image dir), as the JAX CLI does for its run directories. Without
`config.json` the features are full depth and the statistics ImageNet's.

Outputs (under -o; default `<run>/scores`, or `<pth stem>_scores`), as the
JAX CLI writes them:
  scores.csv      path,image_score — one row per input image, input order
  summary.json    n_images, score stats, run config echo
  heatmaps/       with --heatmaps N: overlay PNGs of the N highest scores

`--watch SECS` is the serving form: a long-lived scorer per line or camera
that polls the folder every SECS seconds and appends the scores of images
not scored yet to scores.csv (models loaded once; resumes from an existing
scores.csv, dropping a torn final row; files deduplicated on their real
paths). A file that does not decode (half-written, corrupt) is retried on
later waves, and after 3 failed waves gets a NaN row; any other failure, of
the models or the card, ends the CLI with it. summary.json is rewritten every
wave; `--watch-waves N` bounds the loop. `--heatmaps` needs the whole scored
set for one colour scale and cannot be combined with `--watch`.

`--weights-dtype bf16` rounds every f32 weight and buffer of the models to
its bf16 value before the first forward pass (`loading.compress_params_bf16`;
opt-in, as in the JAX package, which measured it slower and drifting).

Image score: max over the NF anomaly map (reference ValidatorNF.py:137-142)
or over the recon squared-error map (ValidatorRecon.py:115-117); for MDN the
inverted min patch probability (reference ValidatorMDN.py:133), normalized
over the scored set (per wave under `--watch`: MDN scores are comparable
within one invocation or wave). `--device` defaults to cuda; without a card
the CLI exits unless `--device cpu` is given.

`--mesh DxM` (with `--pth`, `-r` and `--watch`; JAX :185-195) scores as the
ranks of a mesh: each data rank scores its rows of every batch (`-b` must be
a multiple of D) and the scores are gathered; the primary rank alone writes
scores.csv, summary.json and the heatmaps, and under `--watch` it picks each
wave's files for every rank. The ranks come from an explicit cluster (the
`VITAD_*` variables) or, without one, are spawned by the CLI, one card each
(`parallel/launch.launch_cli`).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

from vit_ad_tpu_torch.cli.common import check_device
from vit_ad_tpu_torch.config import MeshConfig, set_numerics_policy
from vit_ad_tpu_torch.parallel.context import MeshContext
from vit_ad_tpu_torch.parallel.launch import launch_cli
from vit_ad_tpu_torch.parallel.multihost import is_primary, maybe_initialize_distributed
from vit_ad_tpu_torch.data.files import IMAGE_EXTENSIONS
from vit_ad_tpu_torch.pipeline.loading import RUN_CONFIG
from vit_ad_tpu_torch.registry import FUSED_LN_MODELS, FUSED_MLP_MODELS, get_possible_models


def list_images(images_dir: str) -> List[str]:
    """Every image under images_dir (recursive), sorted — deterministic
    input order, mirrored row-for-row by scores.csv."""
    out: List[str] = []
    for root, _, fs in os.walk(images_dir):
        for f in fs:
            if f.lower().endswith(IMAGE_EXTENSIONS):
                out.append(os.path.join(root, f))
    return sorted(out)


def run_config(pth: str) -> dict:
    """The `config.json` a trainer wrote beside `pth`, or {} where there is
    none (a reference `.pth`)."""
    path = os.path.join(os.path.dirname(os.path.abspath(pth)), RUN_CONFIG)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def norm_stats_for(centering: bool, train_data: str, img_size: int, batch_size: int):
    """Match training-time standardization (JAX `cli/score._norm_stats_for`):
    a `--centering` run is standardized with the mean and std of the images
    under `train_data` (`DataPipeline.compute_mean_std`); everything else with
    the ImageNet statistics the trainers use."""
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import DataPipeline

    if centering:
        if not train_data:
            raise SystemExit(
                "this run trained with --centering (per-dataset mean/std); "
                "pass --train-data <the training image dir> so scoring "
                "standardizes the same way"
            )
        pipe = DataPipeline(batch_size=batch_size, img_size=img_size,
                            files=list_images(train_data))
        # compute_mean_std streams train_files; files= fills test_files
        pipe.train_files = pipe.test_files
        return pipe.compute_mean_std()
    return default_norm_stats()


def _mesh_of(models) -> Optional[MeshContext]:
    """The scoring mesh of the models' `hp.mesh` (None without one)."""
    return MeshContext.from_hp(models.hp, devices=next(models.parts[0].parameters()).device)


def _prepare(models, batch: int, centering: bool, train_data: str, mesh: str = ""):
    """The CLI's batch and mesh overrides on the models' HyperParams; (hp,
    mean, std). A batch the mesh's data axis does not divide exits."""
    hp = models.hp
    if batch:
        hp.batch_size = batch
    if mesh:
        hp.mesh = MeshConfig.parse(mesh)
        try:
            _mesh_of(models).check_batch(hp.batch_size)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    return hp, *norm_stats_for(centering, train_data, hp.img_size, hp.batch_size)


def _build_pth_models_cli(pths: List[str], arch: str, model_name: str, img_size: int,
                          hidden_ratio: float, flow_steps: int, encoder_ckpt: str, device,
                          fused_ln: Optional[bool], fused_mlp: Optional[bool], cfg: dict):
    """The models of one head `.pth` (at the feature depth of the `config.json`
    beside it), or of the two stage-head files of the ResNet-MDN
    convention."""
    from vit_ad_tpu_torch.pipeline.loading import build_pth_models, build_pth_resnet_mdn_models

    if len(pths) == 2:
        if arch != "mdn":
            raise SystemExit("two .pth files = the ResNet-MDN convention; use -a mdn")
        return build_pth_resnet_mdn_models(pths, img_size=img_size, encoder_ckpt=encoder_ckpt,
                                           device=device)
    if len(pths) == 1:
        return build_pth_models(pths[0], model_name, arch, img_size=img_size,
                                hidden_ratio=hidden_ratio, flow_steps=flow_steps,
                                encoder_ckpt=encoder_ckpt, device=device, fused_ln=fused_ln,
                                fused_mlp=fused_mlp, block_index=cfg.get("block_index", 0))
    raise SystemExit(f"--pth takes one head file, or the two stage-head files of the "
                     f"ResNet-MDN convention; got {len(pths)}")


def _maybe_compress(models, weights_dtype: str) -> None:
    """`--weights-dtype bf16`: the models' f32 weights rounded to bf16 values
    in place ('auto' and 'f32' keep them)."""
    if weights_dtype == "bf16":
        from vit_ad_tpu_torch.pipeline.loading import compress_params_bf16

        n = compress_params_bf16(models)
        print(f"--weights-dtype bf16: {n} f32 parameters and buffers rounded to bf16",
              flush=True)


def score_pth(
    pths: List[str],
    arch: str,
    images_dir: str,
    out_dir: Optional[str] = None,
    model_name: str = "enc_deit",
    img_size: int = 224,
    hidden_ratio: float = 0.16,
    flow_steps: int = 20,
    encoder_ckpt: str = "",
    batch: int = 0,
    device: Optional[str] = None,
    fused_ln: Optional[bool] = None,
    fused_mlp: Optional[bool] = None,
    train_data: str = "",
    heatmaps: int = 0,
    weights_dtype: str = "auto",
    mesh: str = "",
) -> dict:
    """Score a folder with a reference-format head `.pth` (plus the pretrained
    trunk `encoder_ckpt`), or with the two stage-head files of the ResNet-MDN
    convention; write scores.csv and summary.json (and `heatmaps` overlays);
    return the summary. The feature depth and the centering come from the
    `config.json` beside the first `.pth` (`run_config`); `train_data` is
    read by centering runs. `mesh`: a `--mesh` spec (this process is a rank
    of its cluster)."""
    cfg = run_config(pths[0])
    models = _build_pth_models_cli(pths, arch, model_name, img_size, hidden_ratio, flow_steps,
                                   encoder_ckpt, device, fused_ln, fused_mlp, cfg)
    _maybe_compress(models, weights_dtype)
    hp, mean, std = _prepare(models, batch, cfg.get("centering", False), train_data, mesh)
    return _score_with_models(models, pths[0], {"architecture": arch}, images_dir,
                              out_dir or os.path.splitext(pths[0])[0] + "_scores", mean, std,
                              heatmaps)


def _load_run_cli(run_dir: str, device, fused_ln: Optional[bool], fused_mlp: Optional[bool]):
    """(RunModels, config) of a run directory; `--fused-ln` / `--fused-mlp`
    given on the command line replace the run's recorded settings."""
    from vit_ad_tpu_torch.pipeline.loading import build_run_models, find_checkpoint, \
        load_run_config

    hp, cfg = load_run_config(run_dir)
    hp.fused_ln = hp.fused_ln if fused_ln is None else fused_ln
    hp.fused_mlp = hp.fused_mlp if fused_mlp is None else fused_mlp
    return build_run_models(hp, find_checkpoint(run_dir, cfg), device), cfg


def score_folder(run_dir: str, images_dir: str, out_dir: Optional[str] = None,
                 heatmaps: int = 0, batch: int = 0, train_data: str = "",
                 weights_dtype: str = "auto", device: Optional[str] = None,
                 fused_ln: Optional[bool] = None, fused_mlp: Optional[bool] = None,
                 mesh: str = "") -> dict:
    """Score every image under images_dir with a run directory's models
    (JAX `score_folder`)."""
    models, cfg = _load_run_cli(run_dir, device, fused_ln, fused_mlp)
    _maybe_compress(models, weights_dtype)
    hp, mean, std = _prepare(models, batch, models.hp.centering, train_data, mesh)
    return _score_with_models(models, run_dir, cfg, images_dir,
                              out_dir or os.path.join(run_dir, "scores"), mean, std, heatmaps)


def score_files(models, files: List[str], mean, std):
    """ScoreOutput of an explicit file list (padded static batches)."""
    from vit_ad_tpu_torch.data.loader import DataPipeline
    from vit_ad_tpu_torch.pipeline.loading import score_models

    hp = models.hp
    return score_models(models, DataPipeline(batch_size=hp.batch_size, img_size=hp.img_size,
                                             files=files), mean, std)


def _write_scores(path: str, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["path", "image_score"])
        w.writerows(rows)


def _score_with_models(models, source: str, cfg: dict, images_dir: str, out_dir: str,
                       mean, std, heatmaps: int = 0) -> dict:
    """The one-shot body: score the folder, write scores.csv, summary.json
    and the heatmaps (the primary rank alone); return the summary."""
    files = list_images(images_dir)
    if not files:
        raise SystemExit(f"no images found under {images_dir!r}")
    hp = models.hp
    s = score_files(models, files, mean, std)
    summary = {
        "run": source,
        "images": len(files),
        "arch": cfg.get("architecture", hp.architecture),
        "model": hp.model_name,
        "score_min": float(np.min(s.image_scores)),
        "score_mean": float(np.mean(s.image_scores)),
        "score_max": float(np.max(s.image_scores)),
        "top": [{"path": files[i], "image_score": float(s.image_scores[i])}
                for i in np.argsort(s.image_scores)[::-1][:5]],
    }
    if not is_primary():
        return summary
    os.makedirs(out_dir, exist_ok=True)
    _write_scores(os.path.join(out_dir, "scores.csv"),
                  [(path, repr(float(score))) for path, score in zip(files, s.image_scores)])
    if heatmaps:
        save_heatmaps(s, files, hp.img_size, out_dir, heatmaps)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def save_heatmaps(s, files: List[str], img_size: int, out_dir: str, n: int) -> List[str]:
    """Overlay PNGs of the n highest-scoring images (the ones a user triages
    first) under `out_dir/heatmaps`, `<rank>_<name>.png`: the anomaly map in
    jet at alpha 0.4 over the image, display-normalized over the scored set
    so one colour scale spans every PNG of the invocation (JAX
    `_save_heatmaps`). Returns the paths."""
    from vit_ad_tpu_torch.data.dataset import load_image
    from vit_ad_tpu_torch.utils.images import overlay, save_png

    hm_dir = os.path.join(out_dir, "heatmaps")
    os.makedirs(hm_dir, exist_ok=True)
    lo, hi = float(s.pixel_scores.min()), float(s.pixel_scores.max())
    span = (hi - lo) or 1.0
    paths = []
    for rank, i in enumerate(np.argsort(s.image_scores)[::-1][:n]):
        name = os.path.splitext(os.path.basename(files[i]))[0]
        paths.append(save_png(overlay(load_image(files[i], img_size),
                                      (s.pixel_scores[i] - lo) / span),
                              os.path.join(hm_dir, f"{rank:03d}_{name}.png")))
    return paths


def _resume_scored(csv_path: str) -> set:
    """Resume an interrupted watch: keep the well-formed rows of an existing
    scores.csv (a torn final row, from a hard kill mid-write, is dropped and
    its image scored again) and return their real paths."""
    scored = set()
    if not os.path.exists(csv_path):
        _write_scores(csv_path, [])
        return scored
    with open(csv_path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    valid = []
    for r in rows[1:]:
        try:
            float(r[1])
        except (IndexError, ValueError):
            continue
        valid.append(r)
        scored.add(os.path.realpath(r[0]))
    _write_scores(csv_path, valid)
    return scored


def watch_folder(models, source: str, images_dir: str, out_dir: str, mean, std,
                 interval: float = 30.0, max_waves: int = 0) -> dict:
    """Continuous serving (JAX `watch_folder`): poll images_dir every
    `interval` seconds and score the images not scored yet, appending rows to
    scores.csv (the models are loaded once). Dedup keys are real paths, so a
    restart with a differently spelled -d does not score everything again;
    rows keep the path as listed.

    Each fresh file is decoded first: a file that does not decode (one of
    `data.dataset.DECODE_ERRORS`: mid-copy or corrupt) is retried on later
    waves and after 3 failed waves gets a NaN row. The decodable files are
    scored as one set; whatever that raises (the models, the card) ends the
    watch with the error, and nothing of that wave is recorded.

    MDN scores are normalized per wave (reference ValidatorMDN.py:133
    semantics), so they are comparable within a wave. summary.json is
    rewritten every wave. `max_waves` bounds the loop (0: until
    interrupted). On a mesh the primary rank lists and decodes each wave's
    files and tells every rank which to score; it alone writes."""
    from vit_ad_tpu_torch.data.dataset import DECODE_ERRORS, load_image

    hp = models.hp
    mc = _mesh_of(models)
    primary = is_primary()
    csv_path = os.path.join(out_dir, "scores.csv")
    scored = set()
    if primary:
        os.makedirs(out_dir, exist_ok=True)
        scored = _resume_scored(csv_path)
    summary = {"run": source, "images": len(scored), "waves": 0, "arch": hp.architecture,
               "model": hp.model_name}
    failures: dict = {}

    def write_summary() -> None:
        if primary:
            with open(os.path.join(out_dir, "summary.json"), "w") as f:
                json.dump(summary, f, indent=1)

    waves = 0
    while True:
        try:
            fresh, good, dead = [], [], set()
            if primary:
                fresh = [p for p in list_images(images_dir)
                         if os.path.realpath(p) not in scored]
            for p in fresh:
                try:
                    load_image(p, hp.img_size)
                    good.append(p)
                except DECODE_ERRORS as e:
                    key = os.path.realpath(p)
                    failures[key] = failures.get(key, 0) + 1
                    if failures[key] >= 3:
                        print(f"watch: giving up on {p!r} after 3 failed waves "
                              f"({type(e).__name__}: {e})", file=sys.stderr, flush=True)
                        dead.add(p)
            if mc is not None:
                fresh, good, dead = mc.broadcast_object((fresh, good, dead))
            got = {}
            if good:
                s = score_files(models, good, mean, std)
                got = dict(zip(good, (float(x) for x in s.image_scores)))
            rows = [(p, got[p] if p in got else float("nan")) for p in fresh
                    if p in got or p in dead]
            if rows:
                if primary:
                    with open(csv_path, "a", newline="") as f:
                        csv.writer(f).writerows((p, repr(x)) for p, x in rows)
                scored.update(os.path.realpath(p) for p, _ in rows)
                finite = [(p, x) for p, x in rows if np.isfinite(x)]
                if finite:
                    top = max(finite, key=lambda r: r[1])
                    summary["last_wave"] = {"n": len(rows), "score_max": top[1], "top": top[0]}
                    print(json.dumps(summary["last_wave"]), flush=True)
            summary["images"] = len(scored)
            waves += 1
            summary["waves"] = waves
            write_summary()
            if max_waves and waves >= max_waves:
                return summary
            time.sleep(interval)
        except KeyboardInterrupt:
            # completed waves are on disk already; leave a final summary
            write_summary()
            return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="score a folder of images with a trained run or with reference-format "
                    "legacy .pth weights (PyTorch/CUDA port)")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("-r", "--run", help="run dir (config.json + the checkpoints it lists)")
    src.add_argument("--pth", nargs="+", metavar="PTH",
                     help="reference-format .pth weights (two files = the ResNet-MDN "
                          "convention); needs -a")
    ap.add_argument("-d", "--images", required=True,
                    help="directory of images to score (recursive)")
    ap.add_argument("-o", "--out", default="",
                    help="output dir (default <run>/scores or <pth>_scores)")
    ap.add_argument("--heatmaps", type=int, default=0,
                    help="save overlay PNGs for the N highest scores")
    ap.add_argument("-b", "--batch", type=int, default=0, help="scoring batch size")
    ap.add_argument("--train-data", default="",
                    help="training image dir (only --centering runs read it: their "
                         "config.json says so)")
    ap.add_argument("--mesh", default="",
                    help="score as the ranks of a device mesh, DxM or 'auto': batches sharded "
                         "over the data axis (the trainers' flag)")
    ap.add_argument("--watch", type=float, default=0.0, metavar="SECS",
                    help="continuous serving: poll the images dir every SECS seconds and "
                         "score new images as they arrive (appends to scores.csv)")
    ap.add_argument("--watch-waves", type=int, default=0,
                    help="stop --watch after N polls (0 = run until interrupted)")
    ap.add_argument("-a", "--arch", default="", help="nf | mdn | recon (with --pth)")
    ap.add_argument("-m", "--model", default="enc_deit",
                    help="registry key (with --pth): the encoder (nf, mdn) or the "
                         "auto-encoder (recon: ae_*)")
    ap.add_argument("-E", "--encoder-ckpt", default="",
                    help="pretrained trunk the head was trained against (with --pth; timm "
                         "ViT/DeiT, NesT or EfficientFormer .pth, the EsViT Swin-T .pth for -m "
                         "enc_esvit, NVIDIA's EfficientNet-B4 .pth for -m enc_eff_net)")
    ap.add_argument("--fused-ln", dest="fused_ln", action="store_true", default=None,
                    help="LayerNorms of the trunk through the one-pass kernel (enc_esvit, "
                         "enc_nest and their ae_* keys)")
    ap.add_argument("--no-fused-ln", dest="fused_ln", action="store_false")
    ap.add_argument("--fused-mlp", dest="fused_mlp", action="store_true", default=None,
                    help="the blocks' MLP tail through the fused kernel (enc_deit, enc_vit)")
    ap.add_argument("--no-fused-mlp", dest="fused_mlp", action="store_false")
    ap.add_argument("-i", "--img-size", type=int, default=224)
    ap.add_argument("-f", "--flow-steps", type=int, default=20)
    ap.add_argument("--hidden-ratio", type=float, default=0.16)
    ap.add_argument("--weights-dtype", default="auto", choices=("auto", "f32", "bf16"),
                    help="weights at rest (auto = f32; bf16 rounds them, opt-in)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; give --device cpu to run on the CPU)")
    argv = sys.argv[1:] if argv is None else argv
    args = ap.parse_args(argv)
    # a rank of a cluster joins it before the device is chosen
    maybe_initialize_distributed()
    if args.watch and args.heatmaps:
        ap.error("--heatmaps is not supported with --watch (overlays need the whole scored "
                 "set for one colour scale)")
    if args.pth:
        if not args.arch:
            ap.error("--pth needs -a nf, -a mdn or -a recon")
        if args.arch not in ("nf", "mdn", "recon"):
            ap.error(f"-a {args.arch}: the heads are nf, mdn and recon")
        if args.arch == "recon" and not args.model.startswith("ae_"):
            ap.error(f"-a recon scores an auto-encoder: give its registry key (-m ae_*), not "
                     f"{args.model!r}")
        if args.model not in get_possible_models():
            ap.error(f"-m {args.model}: unknown model; known: {', '.join(get_possible_models())}")
        model = args.model
    else:
        if not os.path.exists(os.path.join(args.run, RUN_CONFIG)):
            ap.error(f"-r {args.run}: no {RUN_CONFIG} there (a run directory holds the run's "
                     f"{RUN_CONFIG} and the checkpoints it lists)")
        with open(os.path.join(args.run, RUN_CONFIG)) as f:
            model = json.load(f).get("model_name", "")
    if args.fused_ln is not None and model not in FUSED_LN_MODELS:
        ap.error(f"--fused-ln/--no-fused-ln: -m {model} has no fused LayerNorm path "
                 f"(models that have: {', '.join(FUSED_LN_MODELS)})")
    if args.fused_mlp is not None and (model not in FUSED_MLP_MODELS
                                       or (args.pth and len(args.pth) != 1)):
        ap.error(f"--fused-mlp/--no-fused-mlp: only -m {' or '.join(FUSED_MLP_MODELS)} has a "
                 "fused MLP path")
    device = check_device(args.device)
    launched = launch_cli("vit_ad_tpu_torch.cli.score", argv,
                          MeshConfig.parse(args.mesh) if args.mesh else MeshConfig(), device)
    if launched is not None:
        return launched
    set_numerics_policy()
    if not args.watch:
        if args.pth:
            summary = score_pth(args.pth, args.arch, args.images, out_dir=args.out or None,
                                model_name=args.model, img_size=args.img_size,
                                hidden_ratio=args.hidden_ratio, flow_steps=args.flow_steps,
                                encoder_ckpt=args.encoder_ckpt, batch=args.batch, device=device,
                                fused_ln=args.fused_ln, fused_mlp=args.fused_mlp,
                                train_data=args.train_data, heatmaps=args.heatmaps,
                                weights_dtype=args.weights_dtype, mesh=args.mesh)
        else:
            summary = score_folder(args.run, args.images, out_dir=args.out or None,
                                   heatmaps=args.heatmaps, batch=args.batch,
                                   train_data=args.train_data, weights_dtype=args.weights_dtype,
                                   device=device, fused_ln=args.fused_ln,
                                   fused_mlp=args.fused_mlp, mesh=args.mesh)
        if is_primary():
            print(json.dumps(summary))
        return 0
    if args.pth:
        cfg = run_config(args.pth[0])
        models = _build_pth_models_cli(args.pth, args.arch, args.model, args.img_size,
                                       args.hidden_ratio, args.flow_steps, args.encoder_ckpt,
                                       device, args.fused_ln, args.fused_mlp, cfg)
        centering, source = cfg.get("centering", False), args.pth[0]
        out = args.out or os.path.splitext(args.pth[0])[0] + "_scores"
    else:
        models, _ = _load_run_cli(args.run, device, args.fused_ln, args.fused_mlp)
        centering, source = models.hp.centering, args.run
        out = args.out or os.path.join(args.run, "scores")
    _maybe_compress(models, args.weights_dtype)
    _, mean, std = _prepare(models, args.batch, centering, args.train_data, args.mesh)
    summary = watch_folder(models, source, args.images, out, mean, std, interval=args.watch,
                           max_waves=args.watch_waves)
    if is_primary():
        print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
